"""The port's silicon macro models (``repro_torch.silicon``) against the
reference's ``repro.silicon`` and ``BENCH_core.json``, on the CPU.

Every macro model gives the reference's area, access energy and leakage,
bitwise, over a range of geometries and bank counts; ``macro_catalog()``
equals the reference's and ``BENCH_core.json``'s ``macro_models`` block
exactly; the registry keeps the reference's discipline (duplicates
refused, unknown names listed, instances passed through, custom models
registered); and the flop backend is the legacy closed form.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import silicon as jsilicon  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import silicon as tsilicon  # noqa: E402
from repro_torch.core import costmodel as tcost  # noqa: E402
from repro_torch.silicon import models as tmodels  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORDS = np.array([16, 64, 128, 256, 512, 1024, 4096, 1 << 16])
BITS = (64, 256, 512)
MODELS = ("flop", "sram6t", "table")


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("banks", (1, 2, 4))
def test_macro_model_equals_reference(name, banks):
    want, got = jsilicon.get_macro_model(name), tsilicon.get_macro_model(
        name)
    assert type(got).__name__ == type(want).__name__
    for bits in BITS:
        for fn in ("area", "access_energy", "leakage"):
            w = np.asarray(getattr(want, fn)(WORDS, bits, banks=banks))
            g = np.asarray(getattr(got, fn)(WORDS, bits, banks=banks))
            assert g.dtype == w.dtype, (name, fn)
            np.testing.assert_array_equal(g, w, err_msg=f"{name}.{fn}")


def test_macro_catalog_equals_reference_and_bench():
    bench = json.loads((ROOT / "BENCH_core.json").read_text())
    got = tsilicon.macro_catalog()
    assert got == jsilicon.macro_catalog()
    assert json.loads(json.dumps(got)) == bench["macro_models"]
    for words, bits in ((64, 256), (2048, 512)):
        assert tsilicon.macro_catalog(words, bits) == \
            jsilicon.macro_catalog(words, bits)
    assert tsilicon.macro_model_names() == jsilicon.macro_model_names() \
        == list(MODELS)
    assert tsilicon.AU_PER_UM2 == jsilicon.AU_PER_UM2
    assert tsilicon.BITCELL_UM2 == jsilicon.BITCELL_UM2
    assert tsilicon.DEFAULT_MACRO_MODEL == jsilicon.DEFAULT_MACRO_MODEL


def test_registry_discipline():
    with pytest.raises(ValueError, match="registered twice"):
        tsilicon.register_macro_model(tsilicon.FlopMacroModel())
    with pytest.raises(KeyError, match="unknown macro model.*sram6t"):
        tsilicon.get_macro_model("nope")
    with pytest.raises(TypeError, match="MacroModel"):
        tsilicon.get_macro_model(42)
    m = tsilicon.Sram6TMacroModel(name="test_custom", fixed_au=1.0)
    assert tsilicon.get_macro_model(m) is m
    tsilicon.register_macro_model(m)
    try:
        assert tsilicon.get_macro_model("test_custom") is m
        assert "test_custom" in tsilicon.macro_catalog()
        res = tapi.SweepResult(
            (tapi.Axis("l1_geometry", (tapi.L1Geometry(64, 2),)),),
            {"cycles": np.ones(1)})
        a = res.derive("l1_macro_area", macro_model="test_custom", out="a")
        assert a["a"][0] == float(m.area(128, 256))
    finally:
        tmodels._MACRO_REGISTRY.pop("test_custom")
    assert "test_custom" not in tsilicon.macro_model_names()
    with pytest.raises(ValueError, match=">= 2 anchor"):
        tsilicon.TableMacroModel("t", ((1024, 1.0, 1.0, 1.0),))
    with pytest.raises(ValueError, match="strictly increasing"):
        tsilicon.TableMacroModel("t", ((2048, 1.0, 1.0, 1.0),
                                       (1024, 1.0, 1.0, 1.0)))
    with pytest.raises(ValueError, match="banks must be >= 1"):
        tsilicon.get_macro_model("sram6t").area(1024, 256, banks=0)


def test_flop_backend_is_the_legacy_closed_form():
    sets = np.array([[64], [128], [256], [512]])
    ways = np.array([[1, 2, 4, 8]])
    legacy = tcost.l1_sram_area(sets, ways)
    for macro in ("flop", tsilicon.get_macro_model("flop")):
        np.testing.assert_array_equal(
            tcost.l1_sram_area(sets, ways, macro=macro), legacy)
    assert tsilicon.macro_catalog()["flop"]["area_au"] == float(
        tcost.l1_sram_area(256, 2))


def test_table_exact_at_anchors_and_clamped_outside():
    m = tsilicon.get_macro_model("table")
    for total_bits, area, energy, leak in m.points:
        words = int(total_bits) // 256
        assert float(m.area(words, 256)) == area
        assert float(m.access_energy(words, 256)) == energy
        assert float(m.leakage(words, 256)) == leak
    lo, hi = m.points[0], m.points[-1]
    assert float(m.area(int(lo[0]) // 256 // 4, 256)) == lo[1]
    assert float(m.area(int(hi[0]) // 256 * 4, 256)) == hi[1]
