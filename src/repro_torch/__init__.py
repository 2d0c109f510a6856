"""repro_torch — the PyTorch/CUDA port of ``repro``.

The package mirrors ``repro``'s module layout and names so each module can be
read next to its JAX counterpart.  It imports ``torch`` and never ``jax`` or
anything of ``repro``: what it needs from there it keeps as its own copy.

Entry points take ``device=None``, which resolves to ``"cuda"`` and raises
where no card is present; only an explicit ``device="cpu"`` runs on the CPU.
The hand-written CUDA kernels (``repro_torch.kernels``) launch for CUDA
tensors and fall back to their plain PyTorch versions only for tensors that
lie on the CPU.

Ported so far: the personalized serving plane, SymWanda pruning, the wire
codecs and the training path (EF-BV and hierarchical sync).

  configs    ModelConfig + registry (h2o-danube-1.8b); Level/Sync/TrainConfig
  kernels    B1-B3, B6: blockwise absmax quantize; B4/B5: mask bit packing;
             B7/B8: N:M and fused score-and-mask prune (CUDA C++, sm_90a)
             + plain refs
  core       compressors and the EF-BV calculus; distributed (EF-BV and
             anchor-cascade sync); symwanda
  comm       buckets, wire codecs, byte ledger, topology and tree models,
             round accounting
  faults     the counter-PRNG fault model
  optim      AdamW / SGD over trees, schedules
  data       synthetic LM corpus
  models     dense decoder: GQA with causal / SWA / chunked masks, ring
             cache, full-sequence forward + CE loss under autograd
  training   train steps, loop, checkpoints; continuous batcher
  serve      delta store, block pool, per-slot delta engine
  launch     greedy-decode, prune (loss ladder) and train entry points
  interop    JAX-package parameters (as numpy) -> the port's tree
"""
