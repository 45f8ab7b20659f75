"""Pluggable SRAM macro models: per-geometry area / access-energy /
leakage curves behind one protocol.

Every iso-area comparison in this repo (the Pareto frontier, the cluster
iso-SRAM-budget sweeps, the DSE study) prices cache capacity through ONE
constant, ``costmodel.SRAM_AU_PER_BIT`` — an assumption anchored on a 28 nm
6T bitcell, not a calibration (the long-standing ``TODO(cal)``).  This
module closes that item the way OpenRAM-style design-space flows do: a
macro *model* maps a (words x bits x banks) geometry to area, per-access
energy and leakage, and a registry makes the model a swappable parameter of
the metric layer (``derive("area_with_l1", macro_model="sram6t")``) instead
of a hard-coded constant.

Three backends ship:

  * ``flop`` — the legacy flop-derived constants, **bit-identical** to the
    closed forms the repo has always used (``bits * SRAM_AU_PER_BIT +
    SRAM_PERIPHERY_AU``, flat 12.0-unit access energy, ``leak_per_au``
    leakage).  This is the default everywhere, so every existing benchmark
    number is unchanged; the class docstring is the constant's derivation.
  * ``sram6t`` — an OpenRAM-style analytic 6T curve: raw bitcell array
    plus periphery that scales with the folded array's *edge* (wordline
    drivers + row decoder ~ rows, sense amps + column muxes ~ cols) plus a
    fixed control block.  Small macros stop looking unrealistically cheap:
    a 1 KB macro is ~32% array, a 4 KB macro ~50%, a 64 KB macro ~77% —
    the classic macro-efficiency curve.
  * ``table`` — piecewise interpolation (linear in log2 bits) through
    user-supplied published datapoints, exact at its anchors.  The
    registered default carries 28 nm-compiler-shaped anchors; replace it
    with ``register_macro_model(TableMacroModel("table", pts),
    override=True)`` when a measured datasheet lands.

Units: everything is in the repo's calibrated *area units* (au) and
model energy/power units, bridged to silicon via the documented anchor
(one flop bit = ``REG_AU_PER_BIT`` au ~ 4x a 0.127 um^2 28 nm 6T bitcell,
so ``AU_PER_UM2 = REG_AU_PER_BIT / (4 * 0.127)``).
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core import costmodel

__all__ = [
    "MacroModel", "FlopMacroModel", "Sram6TMacroModel", "TableMacroModel",
    "register_macro_model", "get_macro_model", "macro_model_names",
    "macro_catalog", "DEFAULT_MACRO_MODEL", "AU_PER_UM2", "BITCELL_UM2",
]

# -- the au <-> um^2 calibration bridge (see costmodel.SRAM_AU_PER_BIT) ----
BITCELL_UM2 = 0.127                 # published 28 nm planar 6T bitcell
# One flop bit (storage + mux/clock load) ~ 4x a 6T bitcell in drawn area;
# the flop bit is REG_AU_PER_BIT au by calibration, which fixes the scale.
AU_PER_UM2 = costmodel.REG_AU_PER_BIT / (4.0 * BITCELL_UM2)


@runtime_checkable
class MacroModel(Protocol):
    """One silicon backend: geometry -> area / access energy / leakage.

    ``words`` is the number of addressable entries (cache lines for an L1
    macro), ``bits`` the width of one entry, ``banks`` how many equal
    sub-arrays the macro is split into (each bank gets its own periphery;
    an access activates one bank).  All three broadcast as numpy arrays,
    and every method is vectorized — the metric layer evaluates whole
    sweep grids in one call.
    """

    name: str

    def area(self, words, bits, banks=1) -> np.ndarray:
        """Total macro area (au), periphery included."""
        ...

    def access_energy(self, words, bits, banks=1) -> np.ndarray:
        """Dynamic energy of one access (model energy units)."""
        ...

    def leakage(self, words, bits, banks=1) -> np.ndarray:
        """Static leakage power (model power units)."""
        ...


def _geometry(words, bits, banks):
    words = np.asarray(words, np.int64)
    bits = np.asarray(bits, np.int64)
    banks = np.asarray(banks, np.int64)
    if (np.asarray(banks) < 1).any():
        raise ValueError(f"banks must be >= 1, got {banks}")
    return np.broadcast_arrays(words, bits, banks)


@dataclasses.dataclass(frozen=True)
class FlopMacroModel:
    """The legacy flop-derived constants as a macro model (the default).

    Derivation of the pinned constant (carried over from
    ``costmodel.SRAM_AU_PER_BIT``, whose ``TODO(cal)`` this class closes):
    the paper gives only area *ratios*, so the calibrated
    ``REG_AU_PER_BIT`` fixes the au scale; a flop + mux/clock load in
    28 nm is ~4x a 6T bitcell in drawn area, hence ``SRAM_AU_PER_BIT =
    REG_AU_PER_BIT / 4`` with a single flat ``SRAM_PERIPHERY_AU`` adder
    per macro.  Access energy is the flat ``PowerParams.e_l1_access``
    (12.0 units for any geometry) and leakage is ``area * leak_per_au`` —
    exactly what the power model has always charged.  Bit-identity of
    ``area`` with the legacy ``costmodel.l1_sram_area`` closed form is a
    regression pin (``tests/test_silicon.py``).
    """

    name: str = "flop"

    def area(self, words, bits, banks=1) -> np.ndarray:
        words, bits, banks = _geometry(words, bits, banks)
        total_bits = words * bits * banks
        return (total_bits * costmodel.SRAM_AU_PER_BIT
                + costmodel.SRAM_PERIPHERY_AU * banks)

    def access_energy(self, words, bits, banks=1) -> np.ndarray:
        words, bits, banks = _geometry(words, bits, banks)
        return np.broadcast_to(
            np.asarray(costmodel.DEFAULT_POWER.e_l1_access), words.shape)

    def leakage(self, words, bits, banks=1) -> np.ndarray:
        return self.area(words, bits, banks) \
            * costmodel.DEFAULT_POWER.leak_per_au


@dataclasses.dataclass(frozen=True)
class Sram6TMacroModel:
    """OpenRAM-style analytic 6T macro curve.

    Per bank, the array is folded to a near-square aspect (rows ~ cols ~
    sqrt(bits)), so the periphery — wordline drivers + row decoder along
    one edge, sense amps + column muxes + write drivers along the other —
    scales with the array *edge* while the cells scale with its *area*:

        area_bank = bits * cell_au  +  edge_au * sqrt(bits)  +  fixed_au

    Anchors (documented, not fitted): the cell term reuses the repo's
    28 nm 6T bitcell bridge (``SRAM_AU_PER_BIT``); ``edge_au``/``fixed_au``
    put a 4 KB macro at ~50% array efficiency — the OpenRAM ballpark for
    small compiler macros — which lands 1 KB at ~32% and 64 KB at ~77%.
    Relative to the ``flop`` backend (whose periphery is a flat 9000 au),
    small macros get *more* expensive and the gap narrows with size: that
    is exactly the reordering the DSE acceptance criterion exercises.

    Access energy activates one bank: a fixed decode term plus wordline +
    bitline capacitance proportional to the bank edge, calibrated to meet
    the legacy flat 12.0 units at the 16 KB reference macro.  Leakage is
    per-cell (6T cells leak ~half the model's per-au logic rate) plus a
    periphery share.
    """

    name: str = "sram6t"
    cell_au: float = costmodel.SRAM_AU_PER_BIT      # raw 6T array density
    edge_au: float = 1400.0      # wordline/decoder + sense/mux per edge unit
    fixed_au: float = 12000.0    # control FSM, timing, redundancy per bank
    e_decode: float = 2.0        # fixed decode+control energy per access
    e_edge: float = 10.0 / 362.0  # edge energy; 12.0 total at 16 KB (1 bank)
    leak_scale: float = 0.5      # 6T cell leakage vs logic, per au

    def _bank_bits(self, words, bits, banks):
        words, bits, banks = _geometry(words, bits, banks)
        return (words * bits / banks).astype(np.float64), banks

    def area(self, words, bits, banks=1) -> np.ndarray:
        bank_bits, banks = self._bank_bits(words, bits, banks)
        bank = (bank_bits * self.cell_au
                + self.edge_au * np.sqrt(bank_bits) + self.fixed_au)
        return banks * bank

    def access_energy(self, words, bits, banks=1) -> np.ndarray:
        bank_bits, _ = self._bank_bits(words, bits, banks)
        return self.e_decode + self.e_edge * np.sqrt(bank_bits)

    def leakage(self, words, bits, banks=1) -> np.ndarray:
        return self.area(words, bits, banks) \
            * costmodel.DEFAULT_POWER.leak_per_au * self.leak_scale


@dataclasses.dataclass(frozen=True)
class TableMacroModel:
    """Interpolated macro model from published datapoints.

    ``points`` is a tuple of ``(total_bits, area_au, access_energy,
    leakage)`` anchors, at least two, sorted by capacity.  Between anchors
    each quantity is linear in ``log2(total_bits)`` (macro curves are
    close to straight on a log-capacity axis); outside the anchor range
    the edge values clamp (``np.interp`` semantics — extrapolating a
    published table would be invention).  At an anchor capacity the model
    returns the published value **exactly** (pinned in
    ``tests/test_silicon.py``); banks split the capacity into equal
    sub-macros, each read off the table at its own size.
    """

    name: str
    points: tuple = ()

    def __post_init__(self):
        pts = tuple(tuple(float(x) for x in p) for p in self.points)
        if len(pts) < 2:
            raise ValueError(
                f"TableMacroModel needs >= 2 anchor points, got {len(pts)}")
        if any(len(p) != 4 for p in pts):
            raise ValueError(
                "each anchor is (total_bits, area_au, access_energy, "
                "leakage)")
        if list(p[0] for p in pts) != sorted(set(p[0] for p in pts)):
            raise ValueError("anchor capacities must be strictly increasing")
        object.__setattr__(self, "points", pts)

    def _interp(self, words, bits, banks, column):
        words, bits, banks = _geometry(words, bits, banks)
        bank_bits = (words * bits / banks).astype(np.float64)
        xp = np.log2([p[0] for p in self.points])
        fp = np.asarray([p[column] for p in self.points])
        return np.interp(np.log2(bank_bits), xp, fp)

    def area(self, words, bits, banks=1) -> np.ndarray:
        _, _, banks = _geometry(words, bits, banks)
        return banks * self._interp(words, bits, banks, 1)

    def access_energy(self, words, bits, banks=1) -> np.ndarray:
        return self._interp(words, bits, banks, 2)

    def leakage(self, words, bits, banks=1) -> np.ndarray:
        _, _, banks = _geometry(words, bits, banks)
        return banks * self._interp(words, bits, banks, 3)


def _kb(n):
    return n * 1024 * 8


# Default ``table`` anchors: 28 nm-compiler-shaped datapoints — raw array
# from the 0.127 um^2 bitcell times the macro-efficiency ladder published
# for small/medium compiler macros (~2.0x array at 4 KB, ~1.5x at 32 KB,
# ~1.35x at 256 KB), converted um^2 -> au through AU_PER_UM2; energies
# bracket the legacy flat 12.0 units at 16 KB.  These are engineering
# anchors, not a measured datasheet: swap the instance (override=True)
# when one lands in PAPERS.md.
_TABLE_ANCHORS = tuple(
    (bits, AU_PER_UM2 * BITCELL_UM2 * bits * factor, energy,
     AU_PER_UM2 * BITCELL_UM2 * bits * factor
     * costmodel.DEFAULT_POWER.leak_per_au * 0.5)
    for bits, factor, energy in (
        (_kb(1), 2.9, 5.0),
        (_kb(4), 2.0, 8.0),
        (_kb(16), 1.65, 12.0),
        (_kb(32), 1.5, 14.5),
        (_kb(256), 1.35, 24.0),
    ))


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

DEFAULT_MACRO_MODEL = "flop"

_MACRO_REGISTRY: dict[str, MacroModel] = {}


def register_macro_model(model: MacroModel,
                         override: bool = False) -> MacroModel:
    """Register a macro model under ``model.name``; re-registering an
    existing name raises unless ``override=True``.  Returns the model so
    the call composes with construction."""
    if not isinstance(model, MacroModel):
        raise TypeError(
            f"macro model must implement the MacroModel protocol "
            f"(area/access_energy/leakage + name), got {model!r}")
    if model.name in _MACRO_REGISTRY and not override:
        raise ValueError(
            f"macro model {model.name!r} registered twice "
            "(pass override=True to replace)")
    _MACRO_REGISTRY[model.name] = model
    return model


def get_macro_model(model=None) -> MacroModel:
    """Resolve a macro model: ``None`` -> the ``flop`` default, a name ->
    registry lookup (unknown names raise with the sorted menu), an object
    implementing the protocol -> passed through."""
    if model is None:
        model = DEFAULT_MACRO_MODEL
    if isinstance(model, str):
        try:
            return _MACRO_REGISTRY[model]
        except KeyError:
            raise KeyError(
                f"unknown macro model {model!r}; registered: "
                f"{', '.join(sorted(_MACRO_REGISTRY))}") from None
    if isinstance(model, MacroModel):
        return model
    raise TypeError(
        f"macro_model must be a name or a MacroModel, got {model!r}")


def macro_model_names() -> list[str]:
    """Sorted names of every registered macro model."""
    return sorted(_MACRO_REGISTRY)


def macro_catalog(words: int = 512, bits: int = 256) -> dict[str, dict]:
    """JSON-safe registry dump evaluated at one reference geometry
    (default: a 2-way 16 KB L1's 512 lines x 256 b — the ``sram6t``
    energy-calibration point) — what ``run.py --json`` records so a
    report names the silicon its areas assume."""
    return {name: dict(
        area_au=float(m.area(words, bits)),
        access_energy=float(m.access_energy(words, bits)),
        leakage=float(m.leakage(words, bits)),
        kind=type(m).__name__,
    ) for name, m in sorted(_MACRO_REGISTRY.items())}


register_macro_model(FlopMacroModel())
register_macro_model(Sram6TMacroModel())
register_macro_model(TableMacroModel("table", _TABLE_ANCHORS))
