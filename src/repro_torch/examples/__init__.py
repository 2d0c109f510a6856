"""Example entry points, the port's counterparts of ``examples/*.py``:

  python -m repro_torch.examples.quickstart        EF-BV training + decode
  python -m repro_torch.examples.train_e2e         qwen-family training,
                                                   checkpoint and eval
  python -m repro_torch.examples.prune_llm         train, then prune the
                                                   checkpoint (launch.prune)
  python -m repro_torch.examples.federated_logreg  EF-BV / EF21 / DIANA and
                                                   Scafflix (Ch. 2, 3)
  python -m repro_torch.examples.cohort_squeeze    SPPM-AS (Ch. 5)
  python -m repro_torch.examples.serve_decode      batched prefill + decode of
                                                   any architecture (reduced)

Each runs on the card unless ``--device cpu`` is given, and raises where
there is no card.
"""
