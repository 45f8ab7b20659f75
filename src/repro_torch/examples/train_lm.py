"""End to end: train a ~100M-param qwen3-family model for a few
hundred steps on the synthetic corpus, with checkpointing and restart
(the port of the reference's ``examples/train_lm.py``).

  python -m repro_torch.examples.train_lm [--steps 300] [--small] \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig, Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true",
                    help="tiny config for a fast smoke run")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.small:
        cfg = get("qwen3-8b").reduced()
        tc = TrainConfig(seq_len=64, global_batch=8, steps=args.steps,
                         checkpoint_every=100, checkpoint_dir=args.ckpt,
                         log_every=20, device=args.device)
    else:
        # ~100M params: 12 layers x 512 wide, GQA + qk-norm (qwen3 family).
        cfg = dataclasses.replace(
            get("qwen3-8b"), num_layers=12, d_model=512, num_heads=8,
            num_kv_heads=4, head_dim=64, d_ff=1536, vocab_size=32768)
        tc = TrainConfig(seq_len=256, global_batch=16, steps=args.steps,
                         checkpoint_every=100, checkpoint_dir=args.ckpt,
                         log_every=10, device=args.device)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"steps={tc.steps} device={tc.device}")
    oc = OptConfig(peak_lr=1e-3, min_lr=1e-4,
                   warmup_steps=max(tc.steps // 20, 5),
                   total_steps=tc.steps)
    out = Trainer(cfg, tc, oc).run()
    h = out["history"]
    print(f"\nloss: {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f} "
          f"({len(h)} steps, restartable from {tc.checkpoint_dir})")
    return out


if __name__ == "__main__":
    main()
