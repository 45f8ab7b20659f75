"""Batched serving with continuous batching + the dispersed KV page pool
(the port of the reference's ``examples/serve_lm.py``).

Trains a tiny model briefly so generations are non-degenerate, then serves
a stream of requests through the port's ``ServeEngine`` and prints the
dispersion statistics of the KV pool (the paper's mechanism at page
granularity).

  python -m repro_torch.examples.serve_lm [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs import get
from repro_torch.core import policies
from repro_torch.optim import OptConfig
from repro_torch.serve import (DispersedKVPool, PagePoolConfig, Request,
                               ServeEngine)
from repro_torch.train import TrainConfig, Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_serve_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get("phi3-mini-3.8b").reduced()
    tc = TrainConfig(seq_len=64, global_batch=8, steps=args.steps,
                     checkpoint_every=999, checkpoint_dir=args.ckpt,
                     log_every=20, device=args.device)
    trainer = Trainer(cfg, tc, OptConfig(peak_lr=3e-3, warmup_steps=4,
                                         total_steps=args.steps))
    trainer.run()

    engine = ServeEngine(cfg, trainer.model, slots=4, max_len=96,
                         temperature=0.8, device=args.device)
    requests = [Request(prompt=[int(t) for t in np.random.default_rng(
        i).integers(1, cfg.vocab_size, 8)], max_new_tokens=16)
        for i in range(10)]
    engine.run(requests)
    for i, r in enumerate(requests[:4]):
        print(f"req{i}: prompt={r.prompt[:4]}... -> {r.out}")
    print(f"all {len(requests)} requests served with {engine.slots} slots "
          "(continuous batching)")

    # Dispersed KV pool demo: bounded hot memory, FIFO spill to the cold
    # region.
    pool = DispersedKVPool(PagePoolConfig(
        num_logical_pages=64, num_hot_pages=8,
        page_shape=(16, cfg.num_kv_heads, cfg.head_dim),
        policy=policies.FIFO), device=args.device)
    rng = np.random.default_rng(0)
    for step in range(400):
        tail = min(step // 8, 63)
        pool.write(tail, pool.read(tail))
        for p in rng.integers(0, max(tail, 1), 2):
            pool.read(int(p))
    st = pool.stats()
    print(f"dispersed KV pool: hit rate {st['hit_rate']:.3f} with "
          f"{st['hot_bytes'] / 1e3:.0f} kB hot vs "
          f"{st['cold_bytes'] / 1e3:.0f} kB logical (spills={st['spills']})")
    return dict(requests=requests, pool=st)


if __name__ == "__main__":
    main()
