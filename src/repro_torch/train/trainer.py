"""Training loop: checkpoint/restart, heartbeat, straggler hooks, metrics
(the port of the reference's ``train/trainer.py``).

``Trainer.run(steps)`` is restart-safe: it restores the newest complete
checkpoint (params + optimizer + data step) if one exists, so killing the
process at any point and re-running continues bit-identically (the data
pipeline is a pure function of step).  The model lives on ``device``
(``TrainConfig.device``, the card by default; a request for it without
one raises), its random init drawn from a ``torch.Generator`` seeded with
``TrainConfig.seed`` on that device.  Steps run eagerly: there is no
compile.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (Heartbeat, RestartPolicy,
                                                 StragglerPolicy)
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class TrainConfig:
    seq_len: int = 128
    global_batch: int = 8
    microbatches: int = 1
    steps: int = 50
    checkpoint_every: int = 25
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt")
    seed: int = 0
    log_every: int = 10
    device: str = "cuda"


class Trainer:
    def __init__(self, arch_cfg, train_cfg: TrainConfig,
                 opt_cfg: adamw.OptConfig | None = None):
        self.cfg = arch_cfg
        self.tc = train_cfg
        self.oc = opt_cfg or adamw.OptConfig(
            total_steps=train_cfg.steps,
            warmup_steps=max(1, min(100, train_cfg.steps // 10)))
        self.model = Model(arch_cfg, device=train_cfg.device)
        self.device = self.model.device
        self.data = SyntheticCorpus(DataConfig(
            vocab_size=arch_cfg.vocab_size, seq_len=train_cfg.seq_len,
            global_batch=train_cfg.global_batch, seed=train_cfg.seed))
        self.ckpt = Checkpointer(train_cfg.checkpoint_dir)
        self.heartbeat = Heartbeat()
        self.stragglers = StragglerPolicy()
        self.restart_policy = RestartPolicy()
        self._step_fn = make_train_step(arch_cfg, self.oc,
                                        train_cfg.microbatches)

    # ------------------------------------------------------------- state --
    def init_state(self):
        """Seeded random weights in the model, and a fresh optimizer state
        (and error feedback when gradients are compressed)."""
        self.model.init(torch.Generator(device=self.device).manual_seed(
            self.tc.seed))
        params = dict(self.model.named_parameters())
        opt = adamw.init_state(params)
        err = (adamw.init_error_feedback(params)
               if self.oc.compress_grads else None)
        return {"params": params, "opt": opt, "err": err}

    def _make_batch(self, step: int):
        b = self.data.batch(step)
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in b.items()}
        if self.cfg.positional == "mrope":
            batch["positions3"] = batch["positions"][None].expand(
                (3,) + tuple(batch["positions"].shape))
        if self.cfg.encoder_decoder:
            # audio frontend stub: deterministic pseudo-embeddings
            bsz = batch["tokens"].shape[0]
            t = np.linspace(0, 1, self.cfg.encoder_seq, dtype=np.float32)
            emb = np.sin(t[:, None] * np.arange(1, self.cfg.d_model + 1)
                         [None] * 0.1).astype(np.float32)
            batch["audio_embeds"] = torch.from_numpy(np.ascontiguousarray(
                np.broadcast_to(emb, (bsz,) + emb.shape))).to(
                    self.device) * 0.05
        return batch

    # --------------------------------------------------------------- run --
    def run(self, steps: int | None = None, state=None) -> dict:
        steps = steps or self.tc.steps
        start = 0
        if state is None:
            state = self.init_state()
            if self.ckpt.latest_step() is not None:
                start, _ = self.ckpt.restore(
                    {"params": state["params"], "opt": state["opt"]})
        history = []
        for step in range(start, steps):
            t0 = time.monotonic()
            batch = self._make_batch(step)
            params, opt, err, metrics = self._step_fn(
                self.model, state["opt"], state["err"], batch)
            state = {"params": params, "opt": opt, "err": err}
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step"] = step
            metrics["step_time"] = time.monotonic() - t0
            history.append(metrics)
            self.heartbeat.beat(step)
            self.stragglers.observe(self.heartbeat.records)
            if (step + 1) % self.tc.checkpoint_every == 0:
                self.ckpt.save(step + 1, {"params": state["params"],
                                          "opt": state["opt"]})
            if step % self.tc.log_every == 0:
                print(f"step {step:5d} loss {metrics['loss']:.4f} "
                      f"lr {metrics['lr']:.2e} "
                      f"gnorm {metrics['grad_norm']:.3f}")
        self.ckpt.wait()
        return {"state": state, "history": history}
