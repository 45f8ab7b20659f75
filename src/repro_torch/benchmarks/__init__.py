"""The port's benchmarks: the measured kernel roofline
(``python -m repro_torch.benchmarks.roofline``) and the accumulator
working-set study (``python -m repro_torch.benchmarks.vmem_dispersion``).
"""
