"""Synthetic LM data and federated client problems (the port's copies of
``repro.data.synthetic`` and ``repro.data.federated``)."""
from repro_torch.data.federated import (FederatedLogReg, classwise_split,
                                        dirichlet_mixtures, dirichlet_split,
                                        make_logreg_clients)
from repro_torch.data.synthetic import SyntheticLMDataset, lm_batch_iterator
