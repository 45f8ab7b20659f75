"""Calibrated silicon backend: pluggable SRAM macro models + the metrics
that let any sweep re-price its area/energy axes per backend.

``repro_torch.silicon`` is the layer between the cost model and the sweep
front door: a
:class:`MacroModel` protocol (area / access energy / leakage as functions
of a words x bits x banks geometry), a registry with three backends
(``flop`` — the legacy flop-derived constants, bit-identical default;
``sram6t`` — an OpenRAM-style analytic 6T curve with edge-scaled
periphery; ``table`` — interpolated from published datapoints, exact at
its anchors), and macro-parameterised metrics (``silicon_area``,
``silicon_cluster_area``, ``silicon_energy``, ``silicon_edp``) registered
through :func:`repro_torch.metrics.register` with no core-engine edits
(importing the package registers them).  A numpy copy of the reference's
``repro/silicon``; see ``docs/silicon.md``.
"""

from repro_torch.silicon.models import (AU_PER_UM2, BITCELL_UM2,
                                        DEFAULT_MACRO_MODEL, FlopMacroModel,
                                        MacroModel, Sram6TMacroModel,
                                        TableMacroModel, get_macro_model,
                                        macro_catalog, macro_model_names,
                                        register_macro_model)
from repro_torch.silicon import metrics as _macro_metrics  # noqa: F401

__all__ = [
    "AU_PER_UM2", "BITCELL_UM2", "DEFAULT_MACRO_MODEL", "FlopMacroModel",
    "MacroModel", "Sram6TMacroModel", "TableMacroModel", "get_macro_model",
    "macro_catalog", "macro_model_names", "register_macro_model",
]
