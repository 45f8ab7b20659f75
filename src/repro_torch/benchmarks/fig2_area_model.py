"""Fig 2 / Fig 7 / §4.4.1: analytic area model — baseline breakdown
calibration and the cVRF savings *predictions* vs the paper's synthesis.

Calibrated on the baseline only (VRF = 61% of VPU; VPU = 43.4% of CPU+VPU,
derived from 53% VPU saving => 23% total saving).  The savings rows are
model outputs to be compared against the paper's 3.5x / 53% / 23% — all
five come from one ``repro_torch.metrics.area_headline`` query.

Beyond the paper rows, the suite now reports the :mod:`repro_torch.silicon`
macro registry at the 16 KB reference L1 macro (512 lines x 256 b):
per-backend macro area and per-access energy, plus each backend's area
ratio against the legacy ``flop`` constants — the calibration table
``docs/silicon.md`` documents, emitted through the same registry the DSE
study sweeps."""

from __future__ import annotations

from repro_torch import metrics, silicon
from repro_torch.benchmarks import common

PAPER = dict(baseline_vrf_pct_of_vpu=61.0, baseline_vpu_pct_of_total=43.4,
             vrf_area_reduction_x=3.5, vpu_area_saving_pct=53.0,
             total_area_saving_pct=23.0)

# The reference macro geometry the registry catalog is quoted at: a
# 2-way 16 KB L1 = 512 lines of 256 bits.
REF_WORDS, REF_BITS = 512, 256


def run() -> list[dict]:
    head = metrics.area_headline(n_full=32, n_cvrf=8)
    rows = [dict(name=name, us_per_call=0.0, value=round(value, 2),
                 paper=PAPER[name])
            for name, value in head.items()]
    # the macro-model calibration rows, through the silicon registry
    cat = silicon.macro_catalog(words=REF_WORDS, bits=REF_BITS)
    flop_area = cat["flop"]["area_au"]
    for name, rec in cat.items():
        rows.append(dict(
            name=f"l1_16kb_macro_area_au[{name}]", us_per_call=0.0,
            value=round(rec["area_au"], 1),
            vs_flop=round(rec["area_au"] / flop_area, 3)))
        rows.append(dict(
            name=f"l1_16kb_access_energy[{name}]", us_per_call=0.0,
            value=round(rec["access_energy"], 2)))
    return rows


def main():
    rows = run()
    common.emit(rows, ["name", "us_per_call", "value", "paper", "vs_flop"])
    return rows


if __name__ == "__main__":
    main()
