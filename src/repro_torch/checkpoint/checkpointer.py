"""Checkpointing with restore: the reference's on-disk contract (the port
of its ``checkpoint/checkpointer.py``).

Format: ``step_XXXXXXXX/shard_0.npz`` (one array per leaf, keyed by the
leaf's ``/``-joined path in the state dict) and ``manifest.json`` (step,
time, keys), the manifest written last through a ``.tmp`` and a rename,
so a crash mid-save never leaves a step that looks complete: restart
reads the newest step that has a manifest.  Saves run on a background
thread so the train loop does not wait on the disk; ``keep`` bounds the
steps kept.  npz has no bfloat16, so bf16 leaves are stored as f32 (which
loses nothing) and restored to the leaf's dtype and device.

The state is a nested dict of tensors (the trainer's ``params`` keyed by
parameter name, and the optimizer's ``step``, ``m``, ``v`` and
``master``).  ``save`` copies every leaf to host memory before it
returns, keeping bf16 leaves in bf16 there and widening each to f32 only
as the writer reaches it; ``restore`` loads each leaf into the tensor of
``like`` at the same key, in place, so neither needs a second copy of the
state on the device.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zipfile

import numpy as np
import torch


def _flatten(tree, prefix=""):
    """(key, leaf) pairs of a nested dict, keys ``/``-joined."""
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, key + "/")
        else:
            yield key, v


def _host_array(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _write_npz(path: str, host: dict) -> None:
    """``np.savez``'s uncompressed layout, one leaf converted at a time."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, t in host.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, _host_array(t),
                                          allow_pickle=False)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ---------------------------------------------------------------- save
    def save(self, step: int, state: dict, blocking: bool = False) -> None:
        """Async save of a nested dict of tensors ``state`` at ``step``."""
        self.wait()
        # Snapshot to host memory now (the train loop updates the tensors
        # in place); the disk write runs on the thread.
        with torch.no_grad():
            host = {k: v.detach().to("cpu", copy=True)
                    for k, v in _flatten(state)}

        def _write():
            try:
                path = os.path.join(self.dir, f"step_{step:08d}")
                os.makedirs(path, exist_ok=True)
                _write_npz(os.path.join(path, "shard_0.npz"), host)
                host.clear()
                manifest = {"step": step, "time": time.time(),
                            "keys": sorted(keys)}
                tmp = os.path.join(path, "manifest.json.tmp")
                with open(tmp, "w") as f:
                    json.dump(manifest, f)
                os.replace(tmp, os.path.join(path, "manifest.json"))
                self._gc()
            except Exception as e:              # raised again by wait()
                self._error = e

        keys = list(host)
        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Join the pending save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            path = os.path.join(self.dir, f"step_{s:08d}")
            for f in os.listdir(path):
                os.remove(os.path.join(path, f))
            os.rmdir(path)

    # ------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        steps = []
        for d in os.listdir(self.dir):
            if (d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "manifest.json"))):
                steps.append(int(d.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: dict, step: int | None = None
                ) -> tuple[int, dict]:
        """Load step ``step`` (default: the newest) into ``like``: each
        leaf is copied, in place, into the tensor of ``like`` at its key,
        cast to that tensor's dtype on its device.  Returns (step,
        like)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with np.load(os.path.join(path, "shard_0.npz")) as data, \
                torch.no_grad():
            for key, leaf in _flatten(like):
                leaf.copy_(torch.from_numpy(data[key]))
        return step, like
