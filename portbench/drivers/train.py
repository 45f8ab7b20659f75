"""Training steps of a dense decoder through the port (``kind: "train"``).

Set-up builds one object: the port's ``Model`` at the configuration's
published widths, its weights made by the benchmark from the seed
(:mod:`portbench.weights`), the f32 masters and moments of
``optim.adamw``, and the step that ``train.train_step.make_train_step``
returns.  It drives that object through its first three steps, called as
``Trainer.run`` calls it, on batches of the cell's traffic; those steps
also warm every shape.  The same object then runs the window: steps on
fresh batches until ``--seconds`` have passed, each ending in the host's
read of its metrics, as ``Trainer.run``'s does.

``correct``: once the window has closed and the program's state is
freed, the plain float32 reference (:mod:`portbench.reference.dense_lm`,
its masters rounded to bfloat16 as they enter products, as the
configuration holds its parameters) takes the same weights and the same
three batches.  The readings (:func:`readings`): each step's loss gap
(relative); each leaf's gradient norm as the optimizer got it at step 1
(its first moment over ``1 - b1``), and after step 3 its change norm
(its master less its start) and its written change norm (the parameter
the model computes with, as the optimizer wrote it, less its start), as
the gap between the program's and the reference's norms over the larger
of the reference's norm of that leaf and of the median leaf, by the
worst leaf and at the median leaf.  Leaves whose reference gradient is
under a thousandth of the median leaf's are left out.  The cell's limits
file (``limits/<cell>.json``) names the readings compared and their
limits.
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time

from portbench import harness, weights, yardstick
from portbench import traffic as gen

CHECK_STEPS = 3
LEAF_FLOOR = 1e-3
GRAD_SAMPLE = 4096          # elements of each leaf's gradient compared


def sample_indices(config: dict, seed: int, device) -> dict:
    """Per leaf (the benchmark's names), the flat indices of the elements
    whose step-1 gradients are compared: a draw from the seed."""
    import torch
    gen = torch.Generator(device=device).manual_seed((int(seed) + 1) % 2**63)
    out = {}
    for name, shape, _ in weights.leaves(config):
        n = math.prod(shape)
        out[name] = torch.randint(0, n, (min(n, GRAD_SAMPLE),),
                                  generator=gen, device=device)
    return out


def limits(workload: str) -> dict:
    """The cell's limits on its compared numbers (``limits/<cell>.json``),
    set from the program's and the controls' readings."""
    return harness.load_json(harness.PKG / "limits" / f"{workload}.json"
                             )["limits"]


def arch_config(config: dict):
    """The port's ``ArchConfig`` for a published dense configuration."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(
        name=config["name"], family="dense",
        num_layers=config["num_hidden_layers"], d_model=config["hidden_size"],
        num_heads=config["num_attention_heads"],
        num_kv_heads=config["num_key_value_heads"],
        d_ff=config["intermediate_size"], vocab_size=config["vocab_size"],
        rope_theta=float(config["rope_theta"]),
        sliding_window=config.get("sliding_window"),
        norm_eps=float(config["rms_norm_eps"]),
        tie_embeddings=bool(config["tie_word_embeddings"]),
        dtype=config["torch_dtype"], attn_impl="sdpa")


def program_parameter(name: str) -> str:
    """The port's parameter name of a benchmark leaf."""
    table = {"embed": "embed", "final_norm": "final_norm.scale",
             "lm_head": "lm_head"}
    if name in table:
        return table[name]
    _, i, leaf = name.split(".")
    return f"blocks.{i}." + {
        "attn_norm": "norm1.scale", "wq": "mixer.wq", "wk": "mixer.wk",
        "wv": "mixer.wv", "wo": "mixer.wo", "mlp_norm": "norm2.scale",
        "w_gate": "ffn.wg", "w_up": "ffn.wi", "w_down": "ffn.wo"}[leaf]


def batch_of(docs, seed: int, step: int, device):
    import torch
    tok = torch.from_numpy(docs.tokens(seed, step)).to(device)
    B, S = tok.shape[0], tok.shape[1] - 1
    pos = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
    return {"tokens": tok[:, :-1].to(torch.int32),
            "targets": tok[:, 1:].to(torch.int32), "positions": pos}


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             t0: float, device: str = "cuda"):
    import torch
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    config, mix = spec["config"], spec["traffic"]
    on_card = device == "cuda"
    docs = gen.Documents(mix, config["vocab_size"], config["eos_token_id"])
    opt_cfg = adamw.OptConfig(**config["optimizer"])
    model = Model(arch_config(config), device=device)
    params = dict(model.named_parameters())
    filled = set()
    with torch.no_grad():
        for name, w in weights.generate(config, seed, device):
            pname = program_parameter(name)
            params[pname].copy_(w)
            filled.add(pname)
    if filled != set(params):
        raise RuntimeError(f"leaves the benchmark does not make: "
                           f"{sorted(set(params) - filled)}")
    opt = adamw.init_state(params)
    step_fn = make_train_step(arch_config(config), opt_cfg, microbatches=1)

    # The first steps: the window's own call and feed.
    losses, grad_norms = [], None
    err = None
    for step in range(CHECK_STEPS):
        _, opt, err, metrics = step_fn(model, opt, err,
                                       batch_of(docs, seed, step, device))
        losses.append(float(metrics["loss"]))
        if step == 0:
            grad_norms = {k: float(m.norm()) / (1 - opt_cfg.b1)
                          for k, m in opt["m"].items()}
            grad_sample = {
                program_parameter(k): (opt["m"][program_parameter(k)].view(
                    -1)[i] / (1 - opt_cfg.b1)).cpu()
                for k, i in sample_indices(config, seed, device).items()}
    masters = opt["master"]
    change, written, still, bf16 = {}, {}, 0, 0
    for name, w0 in weights.generate(config, seed, device):
        pname = program_parameter(name)
        change[pname] = float((masters[pname] - w0.float()).norm())
        written[pname] = float((params[pname].detach().float()
                                - w0.float()).norm())
        if w0.dtype == torch.bfloat16:
            still += int((params[pname] == w0).sum())
            bf16 += w0.numel()
    print(f"train: after {CHECK_STEPS} steps {still / bf16:.6f} of the "
          f"bfloat16 weights still hold their first value", file=sys.stderr)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    prof = harness.profiler() if trace else None
    restore = None
    if prof is not None:
        restore = adamw.apply_updates

        def traced_updates(*a, **kw):
            with harness.span("portbench.train.opt", prof):
                return restore(*a, **kw)
        adamw.apply_updates = traced_updates
        prof.start()
    wall0 = time.time_ns()          # the profiler's events carry this clock
    start = time.perf_counter()
    step = CHECK_STEPS
    try:
        while True:
            batch = batch_of(docs, seed, step, device)
            with harness.span("portbench.train.step", prof):
                _, opt, err, metrics = step_fn(model, opt, err, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
            step += 1
            now = time.perf_counter()
            if now - start >= seconds:
                break
    finally:
        if restore is not None:
            adamw.apply_updates = restore
    window_s = now - start
    steps = step - CHECK_STEPS
    traced = None
    if prof is not None:
        prof.stop()
        traced = harness.Trace(prof, wall0, window_s)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del model, params, opt, masters, metrics, batch
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    B, S = docs.batch, docs.seq_len
    e2e = {"train_throughput": steps * B * S / window_s, "setup_s": setup_s}
    r0 = time.perf_counter()
    ref = reference(config, seed, docs, device)
    prog = dict(losses=losses, grad_norms=grad_norms,
                grad_sample=grad_sample, change_norms=change,
                param_norms=written)
    checks, got = compare(prog, ref, limits(spec["cell"]["name"]))
    print(f"train: {steps} steps in {window_s:.3f} s, set-up {setup_s:.3f} "
          f"s, reference {time.perf_counter() - r0:.3f} s, losses "
          f"{losses} vs {ref['losses']}", file=sys.stderr)
    ctx = dict(window_s=window_s, steps=steps, trace=traced,
               peak_bytes=peak,
               flops_per_step=yardstick.dense_lm_flops(config, B, S))
    return dict(e2e=e2e, ctx=ctx, checks=checks, attempted=steps,
                failed=0, peak_bytes=peak, trace=traced, readings=got,
                program=prog)


def reference(config: dict, seed: int, docs, device, **kw) -> dict:
    """The reference's readings of the first steps, on the same weights
    and batches, its leaves named as the program's.  ``kw`` goes to
    ``dense_lm.train_steps`` (a control's ``q``)."""
    import torch
    from portbench.reference import dense_lm
    W = {name: w.float() for name, w in weights.generate(config, seed,
                                                          device)}
    batches = []
    for step in range(CHECK_STEPS):
        b = batch_of(docs, seed, step, device)
        batches.append((b["tokens"].long(), b["targets"].long()))
    out = dense_lm.train_steps(
        W, batches, config, config["optimizer"],
        lambda: weights.generate(config, seed, device),
        probe=sample_indices(config, seed, device), **kw)
    del W
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    return {key: out["losses"] if key == "losses" else
            {program_parameter(k): v for k, v in out[key].items()}
            for key in ("losses", "grad_norms", "grad_sample",
                        "change_norms", "param_norms")}


def readings(prog: dict, ref: dict) -> dict:
    """The numbers a run can be compared by, the program's (or a
    control's) against the reference's, each a dict as
    :func:`reference` returns: each step's loss gap (relative); the
    gradient, change and written change norms' gaps (``grad_norm``,
    ``change``, ``param``) by the worst leaf and at the median leaf; and
    at the median leaf the step-1 gradient's error on the sampled
    elements, ``|g - g_ref| / |g_ref|``, which no cancellation hides."""
    out = {f"loss{i + 1}_gap": abs(a - b) / abs(b)
           for i, (a, b) in enumerate(zip(prog["losses"], ref["losses"]))}
    med = statistics.median(ref["grad_norms"].values())
    keep = [k for k, g in ref["grad_norms"].items() if g >= LEAF_FLOOR * med]
    for name, key in (("grad_norm", "grad_norms"), ("change", "change_norms"),
                      ("param", "param_norms")):
        got, refn = prog[key], ref[key]
        base = statistics.median(refn[k] for k in keep)
        gaps = {k: abs(got[k] - refn[k]) / max(refn[k], base) for k in keep}
        worst = max(gaps, key=gaps.get)
        out[f"{name}_gap"] = gaps[worst]
        out[f"{name}_leaf"] = worst
        out[f"{name}_median_gap"] = statistics.median(gaps.values())
    sample, rs = prog["grad_sample"], ref["grad_sample"]
    out["grad_diff_median"] = statistics.median(
        float((sample[k] - rs[k]).norm() / rs[k].norm().clamp(min=1e-30))
        for k in keep)
    out["left_out"] = len(ref["grad_norms"]) - len(keep)
    return out


def compare(prog: dict, ref: dict, lim: dict):
    """The checks of a run (each compared number beside its limit) and
    all its readings."""
    r = readings(prog, ref)
    print(f"train: readings {r}", file=sys.stderr)
    return [dict(name=k, value=float(r[k]), limit=v, ok=bool(r[k] <= v))
            for k, v in lim.items()], r
