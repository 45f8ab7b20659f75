from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
__all__ = ["DataConfig", "SyntheticCorpus"]
