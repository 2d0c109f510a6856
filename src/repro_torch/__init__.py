"""repro_torch — the PyTorch/CUDA port of ``repro``.

The package mirrors ``repro``'s module layout and names so each module can be
read next to its JAX counterpart.  It imports ``torch`` and never ``jax`` or
anything of ``repro``: what it needs from there it keeps as its own copy.

Entry points take ``device=None``, which resolves to ``"cuda"`` and raises
where no card is present; only an explicit ``device="cpu"`` runs on the CPU.
The hand-written CUDA kernels (``repro_torch.kernels``) launch for CUDA
tensors and fall back to their plain PyTorch versions only for tensors that
lie on the CPU.

Ported so far: the personalized serving plane and SymWanda pruning.

  configs    ModelConfig + registry (h2o-danube-1.8b)
  kernels    B1-B3: blockwise absmax quantize; B7/B8: N:M and fused
             score-and-mask prune (CUDA C++, sm_90a) + plain refs
  core       compressors (identity, top_k, qsgd, qsgd_kernel); symwanda
  comm       buckets, wire codecs, byte ledger
  models     dense decoder: GQA with causal / SWA / chunked masks, ring
             cache, full-sequence forward + CE loss
  training   continuous batcher
  serve      delta store, block pool, per-slot delta engine
  launch     greedy-decode and prune (loss ladder) entry points
  interop    JAX-package parameters (as numpy) -> the port's tree
"""
