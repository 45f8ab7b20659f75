"""Seeded weights of a dense decoder, made by the benchmark on the card.

The program under test and the reference get the same values: the
weights come from one ``torch.Generator`` seeded with ``--seed``, in a
few large calls in bfloat16 (the type they are trained in), each leaf
then scaled to its init distribution and rounded to bfloat16 again.  The
norms' scales are ones in float32, as the program keeps them.

Leaves are named by the benchmark (``layers.<i>.wq`` and so on); the
driver maps them onto the program's parameters.
"""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 30            # elements a call of randn draws at most


def leaves(cfg: dict) -> list[tuple[str, tuple, float | None]]:
    """(name, shape, std) per leaf; std None means a norm's ones."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, ff, V = d // H, cfg["intermediate_size"], cfg["vocab_size"]
    out = [("embed", (V, d), 0.02)]
    for i in range(L):
        p = f"layers.{i}."
        out += [(p + "attn_norm", (d,), None),
                (p + "wq", (d, H * hd), d ** -0.5),
                (p + "wk", (d, Hkv * hd), d ** -0.5),
                (p + "wv", (d, Hkv * hd), d ** -0.5),
                (p + "wo", (H * hd, d), (H * hd) ** -0.5),
                (p + "mlp_norm", (d,), None),
                (p + "w_gate", (d, ff), d ** -0.5),
                (p + "w_up", (d, ff), d ** -0.5),
                (p + "w_down", (ff, d), ff ** -0.5)]
    out += [("final_norm", (d,), None), ("lm_head", (d, V), d ** -0.5)]
    return out


def generate(cfg: dict, seed: int, device):
    """Yield (name, tensor) for every leaf: bfloat16 matrices, float32
    norm scales.  One leaf's scaled copy lives beside the raw draws at a
    time."""
    specs = leaves(cfg)
    total = sum(math.prod(s) for _, s, std in specs if std is not None)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    raw = torch.empty(total, dtype=torch.bfloat16, device=device)
    for off in range(0, total, CHUNK):
        n = min(CHUNK, total - off)
        raw[off:off + n] = torch.randn(n, generator=gen, device=device,
                                       dtype=torch.bfloat16)
    off = 0
    for name, shape, std in specs:
        if std is None:
            yield name, torch.ones(shape, dtype=torch.float32, device=device)
            continue
        n = math.prod(shape)
        w = (raw[off:off + n].float() * std).to(torch.bfloat16)
        off += n
        yield name, w.view(shape)
    del raw
