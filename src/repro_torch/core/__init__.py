"""The paper's algorithms (port of ``repro.core``): compression (EF-BV),
local training and personalization (Scafflix), multi-round cohorts
(SPPM-AS), federated pruning (FedP3), post-training pruning (SymWanda), and
the sync of the training step (``distributed``)."""
from repro_torch.core import compressors
from repro_torch.core import distributed
from repro_torch.core import ef_bv
from repro_torch.core import fedp3
from repro_torch.core import scafflix
from repro_torch.core import sppm
from repro_torch.core import symwanda
from repro_torch.core.compressors import (Compressor, WireSpec, identity,
                                         make_compressor, qsgd, qsgd_kernel,
                                         scale_compressor, top_k)
