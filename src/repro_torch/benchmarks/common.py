"""Shared benchmark output (the ``emit`` of ``benchmarks/common.py``)."""

from __future__ import annotations


def emit(rows: list[dict], header: list[str]) -> None:
    """Print ``rows`` as CSV under ``header`` (missing fields empty)."""
    print(",".join(header))
    for r in rows:
        print(",".join(str(r.get(h, "")) for h in header))
