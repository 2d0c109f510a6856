"""repro_torch.cohort — vectorized million-client cohort simulation (the
port of ``repro.cohort``).

``Population`` is the law of a client population (link classes, Dirichlet
data skew, personalization mixes) evaluated lazily per client id;
``CohortEngine`` runs whole federated rounds over sampled cohorts as one
batched sweep on the card (``device=``), with per-class byte attribution
(``CohortAccountant``) cross-checked against a materialized small-N oracle.
"""
from repro_torch.cohort.accounting import (CohortAccountant, CohortRoundBytes,
                                           materialized_round_bytes,
                                           message_nbytes)
from repro_torch.cohort.engine import (CohortEngine, CohortRoundReport,
                                       flix_local_step)
from repro_torch.cohort.population import (ClientSpecBatch, CohortBuckets,
                                           LinkClass, Population,
                                           bucket_boundaries, bucket_by_size,
                                           bucket_capacities, cohort_compressor,
                                           link_classes_from_tree, sample_cohort)

__all__ = [
    "CohortAccountant", "CohortRoundBytes", "materialized_round_bytes",
    "message_nbytes", "CohortEngine", "CohortRoundReport", "flix_local_step",
    "ClientSpecBatch", "CohortBuckets", "LinkClass", "Population",
    "bucket_boundaries", "bucket_by_size", "bucket_capacities",
    "cohort_compressor", "link_classes_from_tree", "sample_cohort",
]
