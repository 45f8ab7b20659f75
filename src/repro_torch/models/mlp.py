"""MLP blocks: SwiGLU and GELU.  Mixture-of-Experts is later work."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common


class MLP(nn.Module):
    """SwiGLU (``wi``, ``wg``, ``wo``) or GELU (``wi``, ``wo``, ``bi``,
    ``bo``) weights, (d_in, d_out) and applied as ``x @ w``."""

    def __init__(self, d: int, d_ff: int, dtype, kind: str = "swiglu",
                 device="cuda"):
        super().__init__()
        dev = common.resolve_device(device)

        def w(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype, device=dev),
                                requires_grad=False)

        self.kind = kind
        self.wi, self.wo = w(d, d_ff), w(d_ff, d)
        if kind == "swiglu":
            self.wg = w(d, d_ff)
        else:
            self.bi, self.bo = w(d_ff), w(d)

    def init_(self, gen: torch.Generator) -> None:
        common.dense_init_(self.wi, gen)
        if self.kind == "swiglu":
            common.dense_init_(self.wg, gen)
        common.dense_init_(self.wo, gen, fan_in=self.wo.shape[0])


def mlp(p, x, kind: str = "swiglu"):
    if kind == "swiglu":
        h = F.silu(x @ p.wg) * (x @ p.wi)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p.wi + p.bi, approximate="tanh")
    out = h @ p.wo
    if kind != "swiglu":
        out = out + p.bo
    return out
