"""Macro-calibrated metrics, registered through
:func:`repro_torch.metrics.register`, the registry's no-core-edit
extension point.

Each metric takes a ``macro_model`` parameter (a registry name or a
:class:`repro_torch.silicon.MacroModel` instance; default ``"flop"``, the
bit-identical legacy constants), so one ``derive`` call re-prices a whole
sweep grid under a different silicon assumption:

    r = res.derive("silicon_area", macro_model="sram6t", out="area_6t")

``silicon_area`` / ``silicon_cluster_area`` are the macro-parameterised
twins of ``area_with_l1`` / ``cluster_area`` — under ``macro_model="flop"``
they are **bit-identical** to the legacy metrics (pinned in
``tests/test_silicon.py``), so every existing benchmark number is
unchanged by this layer existing.  ``silicon_energy`` re-prices the power
model's flat per-access L1 energy with the macro's per-geometry access
energy and adds the macro's leakage (which the core power model, whose
area explicitly excludes L1 macros, has never charged).
"""

from __future__ import annotations

import numpy as np

from repro_torch import metrics as _metrics
from repro_torch.core import costmodel
from repro_torch.silicon.models import get_macro_model

L1_LINE_BITS = 32 * 8     # L1Geometry.LINE_BYTES * 8


def _l1_macro(ctx):
    """(model, words, bits) of the sweep's per-core L1 macro: one word per
    cache line (sets x ways) of 256 bits."""
    model = get_macro_model(ctx.params.get("macro_model"))
    words = ctx.axis_grid("l1_sets") * ctx.axis_grid("l1_ways")
    return model, words, L1_LINE_BITS


@_metrics.register("l1_macro_area", "model",
                   "per-core L1 SRAM macro area (au) under the macro_model "
                   "backend (default 'flop', the bit-identical legacy "
                   "constants) at the sweep's l1_geometry",
                   params=("macro_model",))
def _l1_macro_area(ctx):
    model, words, bits = _l1_macro(ctx)
    return model.area(words, bits)


@_metrics.register("l1_macro_access_energy", "model",
                   "dynamic energy of one L1 macro access under the "
                   "macro_model backend ('flop' reads the legacy flat "
                   "PowerParams.e_l1_access)",
                   params=("macro_model",))
def _l1_macro_access_energy(ctx):
    model, words, bits = _l1_macro(ctx)
    return model.access_energy(words, bits)


@_metrics.register("silicon_area", "model",
                   "total_area plus the macro_model-priced L1 macro — the "
                   "macro-parameterised twin of area_with_l1 "
                   "(bit-identical to it under macro_model='flop')",
                   params=("macro_model", "dispersed", "n_lanes"))
def _silicon_area(ctx):
    return ctx.counter("total_area") + ctx.counter("l1_macro_area")


@_metrics.register("silicon_cluster_area", "model",
                   "cores * silicon_area plus the macro_model-priced "
                   "shared-L2 macro from meta['cluster'] — the twin of "
                   "cluster_area (bit-identical under macro_model='flop')",
                   params=("macro_model", "dispersed", "n_lanes"))
def _silicon_cluster_area(ctx):
    cl = _metrics._cluster_meta(ctx)
    model = get_macro_model(ctx.params.get("macro_model"))
    l2_au = float(model.area(cl["l2_sets"] * cl["l2_ways"],
                             L1_LINE_BITS)) if cl["l2_bytes"] else 0.0
    return ctx.axis_grid("cores") * ctx.counter("silicon_area") + l2_au


@_metrics.register("sram_access_energy", "model",
                   "total L1 macro dynamic energy over the run: the power "
                   "model's L1 access count (l1_hits + mem_reads + "
                   "mem_writes) times the macro's per-access energy",
                   params=("macro_model",))
def _sram_access_energy(ctx):
    l1_ev = (ctx.counter("l1_hits") + ctx.counter("mem_reads")
             + ctx.counter("mem_writes")).astype(np.float64)
    return l1_ev * ctx.counter("l1_macro_access_energy")


def _cores_grid(ctx):
    if any(a.name == "cores" for a in ctx.result.axes):
        return ctx.axis_grid("cores")
    return np.asarray(1)


@_metrics.register("silicon_energy", "model",
                   "application energy with the flat L1 access energy "
                   "re-priced by the macro_model backend, plus the L1 "
                   "macro's leakage (cores * leak * scaled_cycles) the "
                   "core power model never charges; equals energy + L1 "
                   "leakage under macro_model='flop'",
                   params=("macro_model", "dispersed", "n_lanes", "pp"))
def _silicon_energy(ctx):
    pp = ctx.params.get("pp", costmodel.DEFAULT_POWER)
    model, words, bits = _l1_macro(ctx)
    l1_ev = (ctx.counter("l1_hits") + ctx.counter("mem_reads")
             + ctx.counter("mem_writes")).astype(np.float64)
    reprice = l1_ev * (model.access_energy(words, bits) - pp.e_l1_access)
    leak = _cores_grid(ctx) * model.leakage(words, bits) \
        * ctx.counter("scaled_cycles")
    return ctx.counter("energy") + reprice + leak


@_metrics.register("silicon_edp", "model",
                   "macro-calibrated energy-delay product: silicon_energy "
                   "* scaled_cycles",
                   params=("macro_model", "dispersed", "n_lanes", "pp"))
def _silicon_edp(ctx):
    return ctx.counter("silicon_energy") * ctx.counter("scaled_cycles")
