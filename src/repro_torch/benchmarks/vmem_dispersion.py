"""Device-memory traffic vs accumulator working-set size for the
dispersed GEMM — the cVRF height/traffic trade-off (Fig 4's economics)
one level up the memory hierarchy.

Port of ``benchmarks/vmem_dispersion.py``: the closed-form traffic model
on granite-8b's MLP shape (M=8192 tokens x K=4096 x N=14336) for
W in {1, 2, 4, 8, 16}, plus a small numeric spot check of
``ops.matmul`` on the chosen device.

    python -m repro_torch.benchmarks.vmem_dispersion [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.benchmarks import common
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def run(device="cuda") -> list[dict]:
    dev = resolve_device(device)
    rows = []
    m, k, n = 8192, 4096, 14336
    for w in (1, 2, 4, 8, 16):
        t = ops.hbm_traffic_model(m, n, k, block_m=128, block_k=512,
                                  working_set=w)
        rows.append(dict(
            name=f"traffic_W{w}", us_per_call=0.0,
            grouped_gb=round(t["grouped"] / 1e9, 2),
            dispersed_gb=round(t["dispersed"] / 1e9, 2),
            ideal_gb=round(t["ideal"] / 1e9, 2),
            vmem_acc_mb=round(t["vmem_acc_bytes"] / 1e6, 2),
        ))
    # small numeric spot check on the device (the kernel on a card, its
    # plain twin on the CPU), against a plain f32 product
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((256, 512), np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal((512, 256), np.float32)).to(dev)
    t0 = time.perf_counter()
    got = ops.matmul(a, b, working_set=2, block_m=128, block_k=256)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    us = (time.perf_counter() - t0) * 1e6
    err = float((got - a @ b).abs().max())
    rows.append(dict(name=f"{dev.type}_check", grouped_gb="",
                     dispersed_gb="", ideal_gb="", vmem_acc_mb="",
                     us_per_call=round(us, 1), max_err=round(err, 6)))
    return rows


def main(device="cuda"):
    rows = run(device)
    common.emit(rows, ["name", "us_per_call", "grouped_gb", "dispersed_gb",
                       "ideal_gb", "vmem_acc_mb", "max_err"])
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
