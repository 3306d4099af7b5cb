"""Data: deterministic synthetic LM streams and the NIAH task (numpy)."""
from repro_torch.data.niah import niah_accuracy, niah_batch
from repro_torch.data.pipeline import DataConfig, batches, copy_batch, markov_batch

__all__ = ["DataConfig", "batches", "copy_batch", "markov_batch", "niah_accuracy",
           "niah_batch"]
