"""PyTorch + CUDA port of the ``repro`` package (the JAX reference).

Module paths mirror the reference: ``repro/serve/engine.py`` is ported as
``repro_torch/serve/engine.py``.  The package imports ``torch`` and never
``jax`` or ``repro``.  Entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``.
"""
