"""Training launcher CLI (the port of the reference's ``launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
      --reduced --steps 100 --seq-len 128 --global-batch 8 [--device cpu]

Runs the fault-tolerant Trainer (checkpoint/restart, heartbeat, straggler
policy) on one device: the card unless ``--device cpu``.  The
reference's flags, plus ``--device``; its multi-host mesh has no
counterpart here.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig, Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tc = TrainConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                     microbatches=args.microbatches, steps=args.steps,
                     checkpoint_every=max(args.steps // 4, 1),
                     checkpoint_dir=args.ckpt_dir, device=args.device)
    oc = OptConfig(peak_lr=args.lr, min_lr=args.lr / 10,
                   warmup_steps=max(args.steps // 20, 1),
                   total_steps=args.steps,
                   compress_grads=args.compress_grads)
    out = Trainer(cfg, tc, oc).run()
    h = out["history"]
    print(f"final loss {h[-1]['loss']:.4f} after {len(h)} steps on "
          f"{tc.device} (restartable from {args.ckpt_dir})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
