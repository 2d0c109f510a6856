"""Synthetic data (the port's copy of ``repro.data.synthetic``)."""
from repro_torch.data.synthetic import SyntheticLMDataset, lm_batch_iterator
