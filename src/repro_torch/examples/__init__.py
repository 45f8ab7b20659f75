"""The port's examples: ``python -m repro_torch.examples.quickstart`` and
``python -m repro_torch.examples.dispersion_analysis`` (``--device cpu``
off the card)."""
