"""Serving launcher CLI: batched generation with continuous batching.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
      --reduced --requests 8 --max-new 12 [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.models import Model
from repro_torch.serve import Request, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    engine = ServeEngine(cfg, model, slots=args.slots, max_len=args.max_len,
                         temperature=args.temperature, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in
                            rng.integers(1, cfg.vocab_size, 6)],
                    max_new_tokens=args.max_new)
            for _ in range(args.requests)]
    engine.run(reqs)
    done = sum(r.done for r in reqs)
    print(f"served {done}/{len(reqs)} requests "
          f"({args.slots} slots, continuous batching, {model.device})")
    for r in reqs[:3]:
        print("  out:", r.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
