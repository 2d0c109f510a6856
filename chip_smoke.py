#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, each printed on its own ``[phase]`` line; any failure raises and
the script exits nonzero without printing a result:

  device   the card's name and power limit (nvidia-smi); no card -> exit 1
  build    nvcc builds kernels B1-B8 and D1 from src/repro_torch/kernels/csrc/ (one
           nvcc per source, started together, then one link)
  kernels  B1-B6 against their plain PyTorch versions on the card, bit for
           bit: B1-B3 on a ragged tensor with zero rows (bits 8 and 4) and a
           2^26-element slice of the main path's shape; B4/B5 (pack_bits /
           unpack_bits) and B6 (stream_quantize_pack, with zero rows) at
           ragged d in {1, 31, 33, 4097, 5*512+37}
  lint     python -m repro_torch.lint --device cuda in this process over
           src/repro_torch and this script: exit 0 and no finding.  Its
           contracts run on the card (RC001's qsgd_kernel carriers, RC002's
           probe: B1, B2 and B3 must launch) and RC003 reads every kernel
           instance's launch resources from the built library: one line
           each with its registers, static and dynamic shared memory, local
           bytes and blocks per SM (clusters per device for the selecting
           B8, staged at d_in 2560 and unstaged at 8192)
  serve    the main path at the full width of h2o-danube-1.8b (bf16, random
           weights from a seed): a DeltaStore with the qsgd_kernel
           compressor stores two users (each put runs B2 and B1 and passes
           the bitwise certificate), a BlockPool pages them in (B3), and a
           PersonalizedBatcher answers 6 requests over 2 slots.  Every
           prefill and decode step is checked bitwise against serving the
           users' materialized params; serve/page_in ledger bytes must equal
           the payload bytes of the misses; B1-B3 must have launched, and
           D1 (the delta apply) once at every delta-path slot call.  The
           first put's B2, B1 and B3 and the first page-in's B3 are held
           bit for bit to their plain versions on their own inputs, 2^20
           rows at a time.
  ref      the port's forward on the card agrees with the CPU on a small
           f32 model (stated tolerance), greedy tokens equal
  codec    the third path: the wire codecs at the full width of the delta
           space (1,831,202,816 coordinates).  (a) A DeltaStore with top_k
           (1%) on the sparse_bitmap wire stores two norm-only users (B4 per
           put, B5 in each certificate) and a BlockPool pages them in (B5):
           resident blocks equal the store's nonzero decoded blocks bit for
           bit, serve/page_in bytes equal the payload bytes, and each payload
           is 4 B per mask word plus 4 B per value.  (b) A full-model update
           (every leaf perturbed) is streamed with encode_stream at
           DEFAULT_TILE under top_k + sparse_bitmap, topk_block (1%, 2048) +
           sparse_block and qsgd_kernel (B2 encode, B3 decode), each recorded
           with CommLedger.record_stream: decode_stream == decode == the
           compressor's carrier, chunk records sum to nbytes and the chunks
           tile [0, d).  (c) B6 (ops.stream_quantize_pack) at full width.
           B4, B5 and B6 must have launched.  Then, not counted: B4/B5 and
           B6 against their plain versions at full width, and B6 == B2
  train    the chain's first half: training.loop.train (traced, so each
           step's metrics are fetched and reach the obs registry, which is
           checked) at the full width of h2o-danube-1.8b (bf16, random
           weights from seed 0), on a SyntheticLMDataset (seed 0), seq 64,
           a global batch of 2 sequences, AdamW: dense for 2 steps (the
           baseline); efbv + qsgd_kernel with 2 groups for 3 steps, where
           B1 must launch 2 x 55 chunks every step and B2 for the round
           report, and one full B1 chunk of step 0's real delta must equal
           its plain version bit for bit; hier + qsgd with 2 replicas,
           sync_period 2, for 4 steps, where the replicas must differ after
           step 0 and be bitwise equal to each other and to the bf16
           anchor after steps 1 and 3.  The efbv run's params are saved
           with save_checkpoint to a temporary directory once its optimizer
           state is freed.  Per run: each step's loss and grad norm
           (finite), the peak device memory and the RoundCost bytes per round
  prune    the chain's second half: SymWanda pruning of the train phase's
           checkpoint (full-width h2o-danube-1.8b, bf16, trained by the efbv
           run) through its CLI (launch/prune.py --ckpt): the loss ladder of
           magnitude / wanda / ria / symwanda at 50% and 60%, wanda +
           R^2-DSnoT and wanda 2:4; B8 and B7 must have launched, every B8
           launch in its selecting mode (tau=None).  The CLI's load must equal
           the tensors the train run ended with bit for bit (save and load
           seconds and bytes printed); the directory is removed after the
           phase.  Then on all 24 trained w_in layers, for every mode and
           sparsity: B8 (tau given) and B7 bit for bit equal to their plain
           versions on the same tau / scores, the selecting B8's (out, mask,
           tau) bit for bit equal to scored_args' torch.topk tau + the plain
           mask, the B8 wanda mask equal to core.symwanda.prune's, and every
           B7 disagreement with mask_nm inside a group of tied scores
  prune_wide  the prune CLI at the full width of qwen1.5-4b (QKV bias;
           random bf16 weights from seed 0): exactly 40 B7 and 320 B8
           launches, all selecting; the peak, the ladder's seconds and the
           dense loss
  paper    the paper's federated algorithms (no kernel on this path): the
           examples.federated_logreg runs (EF-BV / EF21 / DIANA under
           rand_k(0.1), 800 rounds; Scafflix at alpha 0.1 / 0.5 / 0.9, 400
           rounds) and FedP3 at bench_fedp3's OPU3 configuration (25 rounds),
           their draws from CPU generators moved to the card; the same calls
           on the CPU; communicated rounds, message and ledger bytes and
           uploaded floats exactly equal, objective traces and FedP3's final
           test loss within rtol 1e-4, FedP3's accuracies within 2 of 600
           test points; ms per round on both; SPPM's (numpy) Fig 5.1 cost row
           once
  cohort   the Cohort-Squeeze cohort engine (repro_torch.cohort): (a)
           Population(10^6, dim 32), a cohort of 10^5 on edge_fl_tree
           (5,000 / 5 / 4) with availability 0.9 and drop 0.05, rounds 0-4
           on the card and on the CPU: bytes and participants equal the JAX
           package's accounting, the anchors equal bit for bit, target_dist
           and root_norm within rtol 1e-5, the registry's cohort series and
           export_json; ms per round, the host derivations timed apart, the
           round's spans, peak memory, staged bytes, bytes by level and
           class; (b) retained device bytes equal across a 10x population
           and a 4x cohort, staged bytes exact; (c) analytic round bytes ==
           the encoded oracle (4,504 and 5,776 B) == the ledger's tags; (d)
           lossy-link transmit: 16 children send a qsgd_kernel-encoded
           full-width w_in (B2) with drops and corruptions, every attempt
           decided as FaultModel.attempt_outcomes, retries under the retry
           tag, delivered payloads decoded (B3) bit for bit; then one
           full-model payload through a corrupted attempt (seal, verify and
           corrupted-copy seconds).  The engine launches no kernel; B2 and
           B3 must launch in (d)
  arch     the other architectures at full width.  (a) mamba2-2.7b whole
           (64 SSD layers, d_model 2560, 80 heads of 64, d_state 128, chunk
           256, tied vocab 50280, bf16, random weights from seed 0) served
           as the serve phase serves danube: a qsgd_kernel DeltaStore of two
           norm-personalized users (B2 + B1 per certified put; the norm
           leaves include each block's gated SSD norm), a BlockPool (B3) and
           the checked PersonalizedBatcher answering 6 requests over 2 slots
           with 300-token prompts (longer than one 256-token SSD chunk), every
           prefill and decode step bitwise equal to the materialized path,
           serve/page_in bytes == the misses' payload bytes, B1-B3 launched
           and their first calls held to the plain versions at this path's
           5,278,520 x 512 shape.
           (b) seamless-m4t-large-v2 whole (24 encoder + 24 decoder layers):
           a ContinuousBatcher (2 slots, 4 requests) whose cache holds
           enc_memory, and launch.serve's generate with seeded frame
           embeddings (2, 16, 1024).  (c) llama4-scout-17b-a16e (4 of 48
           layers: one period, 16 experts top-1 + shared, 256 vision tokens)
           and dbrx-132b (2 of 40 layers, 16 experts top-4) at full width,
           one after the other: prefill 2 x 288 tokens and 8 decode steps;
           on the first MoE layer's prefill inputs moe_ffn(no_drop) within
           2% of the f32 sum of its experts (shared expert too), and the
           dropped assignments at capacity 1.25 are each expert's
           assignments past C in token order of an f32 top-k.  (d) the reduced f32 configs
           of the five and jamba's 8-layer period at reduced widths on the
           card and on the CPU: logits within 1e-4 of their max, tokens
           equal.  The peaks are printed
  archtrain  training of the other architectures at full width, each run
           through training.loop.train with tracing on (bf16, random weights
           from seed 0, seq 64, a global batch of 2, AdamW, the train phase's
           SyntheticLMDataset feed): (a) mamba2-2.7b whole, dense, 2 steps;
           (b) mamba2-2.7b at 32 of 64 layers, efbv + qsgd_kernel over 2
           groups, 4 steps, where B1 must launch G x chunks every step and B2 for the round report, and
           step 0's first B1 chunk and the report's B2 probe must equal their
           plain versions bit for bit; (c) seamless-m4t-large-v2 whole
           (24 + 24 layers), dense, 2 steps, each batch with 64 source frames
           made as launch.serve's side_inputs makes them; (d)
           llama4-scout-17b-a16e cut to one full-width 16-expert MoE layer,
           dense, 2 steps, the aux term printed.  Per run: losses and grad
           norms (finite), the obs registry's series, the peak.  (e) The
           reduced f32 jamba, dbrx and llama4, 3 dense steps on the card and
           on the CPU from the same params and batches: losses within rtol
           1e-4, every router call's top-(K+1) margin > 1e-5.  (f) (b)'s
           trace through export_jsonl and export_chrome_trace (every event
           "X" with its tid; load_jsonl gives the spans back) and obs.report
           on it: exit 0, no ledger.  (g) A traced two-level hier round at 2^20 coordinates under
           qsgd_kernel (encode B2, decode B3; each level in ambient(level=))
           audited by obs.report against round_ledger's bytes: bytes_match
           True and exit 0, exit 1 with one level's ledger bytes raised by 1
  longctx  the tiled (flash) attention at lengths no whole score matrix fits
           (bf16, random weights from seed 0): (a) h2o-danube-1.8b whole,
           one 32,768-token prompt (prefill_32k's length) then 4 greedy
           decode steps, with BANDED off and on, and the two runs' last-
           position logits' max abs difference; (b) seamless-m4t-large-v2's
           24-layer encoder on 32,768 source frames plus a 32-token decoder
           prefill cross-attending to them; (c) one dense danube train step
           (AdamW) at seq 16,384, batch 1, through forward_train and the
           tiled backward, its loss finite; (d) layer 0's prefill attention
           at S = 2048 in f32 within 2e-5 of a whole-matrix f32 softmax
           computed by this script.  ms and peak GiB for each run; no kernel
  dp       the data-parallel EF-BV sync, core.ef_bv.efbv_sync_worker under
           qsgd_kernel (B1 on every rank, every launch held bit for bit to
           its plain version): (a) a 1-rank NCCL group, h2o-danube-1.8b whole
           at full width, one microbatch's grads (seq 64), one sync equal
           bit for bit to core.distributed.efbv_sync's per-leaf path with
           G = 1 on the same grads and draws; (b) 4 spawned ranks on the one
           card over gloo (CUDA tensors staged through host memory: not an
           NVLink figure), danube at full width cut to 4 of 24 layers, each
           rank its own batch; every rank's (g_est, h_i, h_bar) equal bit for
           bit to the per-leaf efbv_sync with G = 4 on every rank's gathered
           grads and replayed draws.  Sync ms per rank, probed and unprobed
  ep       the expert-parallel MoE paths (models.moe.moe_ffn_shardmap, with
           gather_quant, and moe_ffn_alltoall) on a 1-rank NCCL group's
           (1, 1) mesh, their collectives real NCCL calls: one full-width
           MoE layer of llama4-scout-17b-a16e (16 experts top-1 + shared)
           and of dbrx-132b (16 experts top-4), bf16, tokens (2, 288, d),
           forward and backward against the scatter moe_ffn (gather_quant
           against the scatter path on the tokens it gathers): outputs,
           aux and gradients within 2e-2 of the max; ms and peak each
  dryrun   the dry-run and the costing (repro_torch.launch.dryrun /
           costing / perf: the step traced under FakeTensorMode on
           DTensors over a fake process group, nothing allocated).  (a)
           Each in a subprocess of its own (this process holds NCCL and
           gloo groups), four full-width cells on the production meshes:
           h2o-danube-1.8b x train_4k x (16, 16) dense, qwen1.5-110b x
           decode_32k x (2, 16, 16) (FSDP serving), mamba2-2.7b x
           long_500k x (16, 16), llama4-scout-17b-a16e x train_4k x
           (16, 16) (the expert-parallel shardmap MoE) and h2o-danube-1.8b
           x long_500k x (16, 16) (the SWA ring cache); each must be ok,
           with its trace seconds, per-rank argument and peak bytes and
           collective counts printed.  (b) The memory anchor on the card:
           whole h2o-danube-1.8b, a dense train step at (1, 4096), remat
           full, and a prefill at (1, 8192), each first traced by the
           dry-run's one-device step under FakeTensorMode (the estimate),
           then run for real from the same state after
           reset_peak_memory_stats: the argument bytes must be equal and
           max_memory_allocated over the estimate within [0.8, 1.25].  (c)
           python -m repro_torch.launch.train --arch h2o-danube-1.8b
           --dry-run --shape decode_32k --multi-pod (a subprocess) must
           write its record with status ok.  (d) The flop anchor: (b)'s
           train step on the card under FlopCounterMode counts exactly the
           flops of the dry-run's fake trace of it, costing.corrected_costs
           (1 and 2 layers, extrapolated) lies within 1% of that count.  (e)
           python -m repro_torch.launch.perf records (subprocesses):
           danube train_4k at baseline and sync_efbv, llama4 train_4k at
           baseline, moe_a2a and moe_quant, mamba2 prefill_32k under
           ssd_heads; each record's roofline terms, memory, collective
           bytes and trace seconds beside the direct cell's.  (f) python -m
           repro_torch.launch.serve --arch h2o-danube-1.8b --dry-run --shape
           long_500k (a subprocess) must write a record equal to (a)'s
           direct one of the same cell in every field but trace_s.  (a),
           (c), (e) and (f) run while (b) and (d) do
  timing   B1-B3 and B6 (beside B2) at the serve path's shape, B4/B5 at the
           codec path's d, and B7/B8 (both modes, three score modes) at one
           full-width w_in (2560 x 6912 bf16) on the card (CUDA events,
           medians or queued runs), beside the plain versions, the bound
           and B3's torch.mul yardstick; prune_scored's old route
           (statistics / plain scores + torch.topk / tau-given B8) against
           the selecting route (statistics / selecting B8), torch.topk
           alone, and one wanda call's peak allocation on each route;
           D1 at the full layout of mamba2-2.7b for one dense user (every
           block its own pool row), bit for bit against its plain version,
           beside its byte bound and the plain version

The last three lines are the kernels JSON, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""
import gc
import json
import os
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
import time

# the delta and materialized paths must get identical cuBLAS results
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

ARCH = "h2o-danube-1.8b"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS = 67e12              # H100 SXM f32 rate outside the tensor cores
N_SLOTS, MAX_LEN, PROMPT, MAX_NEW = 2, 64, 16, 8
USERS = (0, 1)
REQUEST_USERS = (0, 1, None, 1, 0, None)
REF_ATOL = 1e-4                # f32 logits, card vs CPU (summation order)

# id, wrapper name, TPU kernel replaced, f32 operations per element
KERNEL_INFO = (
    ("B1", "quant_dequant_2d", "src/repro/kernels/quant8.py:37", 8),
    ("B2", "quant_pack_2d", "src/repro/kernels/bitpack.py:101", 7),
    ("B3", "unpack_dequant_2d", "src/repro/kernels/bitpack.py:131", 2),
)
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/quant.cu"
PRUNE_INFO = (
    ("B7", "nm_prune_2d", "src/repro/kernels/nm_prune.py:45"),
    ("B8", "wanda_prune_2d", "src/repro/kernels/wanda_score.py:60"),
)
PRUNE_SOURCE = "src/repro_torch/kernels/csrc/prune.cu"
DELTA_INFO = ("D1", "delta_apply", "none: the JAX package's delta apply is XLA's fusion "
              "inside one jit", "src/repro_torch/kernels/csrc/delta.cu")
B8_MODES = ("wanda", "ria", "symwanda")
# id, wrapper name, TPU kernel replaced, source, integer or f32 operations
# per coordinate (B4/B5: compare or shift, mask, or / store)
CODEC_INFO = (
    ("B4", "pack_mask_2d", "src/repro/kernels/bitpack.py:53",
     "src/repro_torch/kernels/csrc/bitmask.cu", 3),
    ("B5", "unpack_mask_2d", "src/repro/kernels/bitpack.py:68",
     "src/repro_torch/kernels/csrc/bitmask.cu", 3),
    ("B6", "stream_quant_pack_2d", "src/repro/kernels/stream.py:110", KERNEL_SOURCE, 7),
)
RAGGED_D = (1, 31, 33, 4097, 5 * 512 + 37)
WIDE_ARCH = "qwen1.5-4b"       # the second full-width prune ladder
# paper phase: FedP3 rounds and layer sizes (benchmarks/bench_fedp3.py), and
# the card-vs-CPU tolerance on objective traces and losses (summation order)
PAPER_ROUNDS, FEDP3_SIZES, PAPER_RTOL = 25, (24, 64, 64, 48, 6), 1e-4
# cohort phase: the headline (Population(1e6, dim 32), cohort 1e5, edge_fl_tree
# classes, these faults) and its (total bytes, participants) for rounds 0-4,
# from the JAX package's numpy accounting; the byte oracle's (total, uplink)
# for rounds 0-1 at cohort 80; the staged bytes of one round at cohort 2,000
# and 8,000; the transmit faults
COHORT_POP, COHORT_SIZE, COHORT_DIM = 1_000_000, 100_000, 32
COHORT_FAULTS = dict(seed=11, availability=0.9, drop_rate=0.05)
COHORT_BYTES = ((3_255_288, 89_957), (3_260_104, 90_079), (3_248_248, 89_973),
                (3_249_128, 89_952), (3_243_592, 89_992))
COHORT_UPPER = {"metro": 2_560, "wan": 32}
ORACLE_BYTES = ((4_504, 1_912), (5_776, 3_184))
STAGED_BYTES = {2_000: 323_711, 8_000: 1_281_740}
COHORT_RTOL = 1e-5             # target_dist / root_norm, card vs CPU (sum order)
XMIT_FAULTS = dict(seed=7, drop_rate=0.2, corrupt_rate=0.2, max_retries=3)
XMIT_CHILDREN = 16
W_IN = (2560, 6912)            # one full-width h2o-danube-1.8b w_in
# arch phase: full-width mamba2-2.7b served to the two users with prompts
# longer than one SSD chunk (256); seamless served whole; the MoE configs at
# full width, depth cut to (layers kept); the reduced f32 configs (and
# jamba's own 8-layer period at reduced widths) on the card against the CPU
MAMBA_ARCH, MAMBA_PROMPT = "mamba2-2.7b", 300
SEAMLESS_ARCH, SEAMLESS_PROMPT, SEAMLESS_SRC = "seamless-m4t-large-v2", 32, 16
MOE_CUTS = (("llama4-scout-17b-a16e", 4), ("dbrx-132b", 2))
MOE_PROMPT, MOE_DECODE = 288, 8    # prompts longer than llama4's 256 vision tokens
MOE_DENSE_RTOL = 2e-2              # bf16 moe_ffn vs the f32 sum of its experts, of the max
ARCH_REDUCED = ("mamba2-2.7b", "seamless-m4t-large-v2", "llama4-scout-17b-a16e",
                "dbrx-132b", "jamba-1.5-large-398b", "jamba period")
JAMBA_PERIOD = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba")
ARCH_RTOL = 1e-4                   # f32 logits card vs CPU, of the max (SSD scan order)
# serve and arch: rows per slice where the plain B1-B3 are held to the first
# put's and page-in's kernel calls (mamba2-2.7b's delta is 5,278,520 rows)
PROBE_SLICE_ROWS = 1 << 20
# archtrain phase: (label, config, layers kept (None: whole), SyncConfig
# fields, steps, n_groups) at full width, seq and batch of the train phase;
# the efbv run's trace is exported and read back.  Seamless's source frames per
# sequence; the reduced MoE configs trained card vs CPU, their loss tolerance
# and the router margin below which a top-k choice could flip; the audited
# round's inter period
ARCHTRAIN_RUNS = (
    ("(a) mamba2 dense", "mamba2-2.7b", None, {"mode": "dense"}, 2, 1),
    ("(b) mamba2 efbv + qsgd_kernel", "mamba2-2.7b", 32,
     {"mode": "efbv", "compressor": "qsgd_kernel"}, 4, 2),
    ("(c) seamless dense", "seamless-m4t-large-v2", None, {"mode": "dense"}, 2, 1),
    ("(d) llama4 dense", "llama4-scout-17b-a16e", 1, {"mode": "dense"}, 2, 1),
)
ARCHTRAIN_SRC = 64
ARCHTRAIN_REDUCED = ("jamba-1.5-large-398b", "dbrx-132b", "llama4-scout-17b-a16e")
ARCHTRAIN_RTOL, ROUTER_MARGIN = 1e-4, 1e-5
AUDIT_PERIOD = 4
# train phase: (label, SyncConfig fields, steps, n_groups, n_pods)
TRAIN_SEQ, TRAIN_BATCH = 64, 2
TRAIN_RUNS = (("dense", {"mode": "dense"}, 2, 1, 1),
              ("efbv + qsgd_kernel", {"mode": "efbv", "compressor": "qsgd_kernel"}, 3, 2, 1),
              ("hier + qsgd", {"mode": "hier", "compressor": "qsgd", "sync_period": 2}, 4, 1, 2))
# longctx phase: danube's prompt (prefill_32k's length) and decode steps,
# seamless's source frames and decoder prompt, the train step's length, the
# length of the one-layer check against a whole-matrix softmax and its
# tolerance (the CPU tests' atol)
LONG_PROMPT, LONG_DECODE, LONG_FRAMES, LONG_DEC_PROMPT = 32768, 4, 32768, 32
LONG_TRAIN_SEQ, LONG_CHECK_SEQ, LONG_ATOL = 16384, 2048, 2e-5
# dp phase: the microbatch's length, the spawned ranks, (b)'s depth (of 24),
# the ranks' time limit; the seeds of the batches, h_i, h_bar and the draws
DP_SEQ, DP_RANKS, DP_LAYERS, DP_JOIN_S = 64, 4, 4, 600
DP_BATCH_SEED, DP_H_SEED, DP_HBAR_SEED, DP_DRAW_SEED = 10, 200, 300, 1000
# ep phase: the expert-parallel MoE paths on a 1-rank NCCL mesh, one
# full-width MoE layer of each MOE_CUTS config on prefill-shaped tokens; the
# tolerance of the paths against the scatter path (bf16 outputs and
# gradients, of the max)
EP_PATHS = ("shardmap", "shardmap gather_quant", "alltoall")
EP_RTOL = 2e-2
# the dry-run's full-width cells on the fake backend: (arch, shape, multi-pod)
DRYRUN_CELLS = (("h2o-danube-1.8b", "train_4k", False), ("qwen1.5-110b", "decode_32k", True),
                ("mamba2-2.7b", "long_500k", False), ("llama4-scout-17b-a16e", "train_4k", False),
                ("h2o-danube-1.8b", "long_500k", False))
# perf records (launch.perf) on the fake backend: (arch, shape, variants)
PERF_RECORDS = (("h2o-danube-1.8b", "train_4k", ""), ("h2o-danube-1.8b", "train_4k", "sync_efbv"),
                ("llama4-scout-17b-a16e", "train_4k", ""),
                ("llama4-scout-17b-a16e", "train_4k", "moe_a2a"),
                ("llama4-scout-17b-a16e", "train_4k", "moe_quant"),
                ("mamba2-2.7b", "prefill_32k", "ssd_heads"))
FLOP_ANCHOR_RTOL = 0.01       # corrected_costs' flops vs the direct count
DRYRUN_CLI = ("h2o-danube-1.8b", "decode_32k")     # through launch.train --dry-run --multi-pod
SERVE_DRYRUN_CLI = ("h2o-danube-1.8b", "long_500k")  # through launch.serve --dry-run, == (a)'s
ANCHOR_RUNS = (("train", 4096), ("prefill", 8192))  # (kind, seq) at batch 1, remat full
ANCHOR_RANGE = (0.8, 1.25)    # max_memory_allocated / the dry-run's estimate
# from the phase's start: the llama4 train_4k traces took 356-471 s of host
# time on the card's machine, all in parallel
DRYRUN_JOIN_S = 900


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def bits_equal(a, b):
    """Bitwise equality of two tensors of one dtype."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return bool(torch.equal(a.view(view), b.view(view)))
    return bool(torch.equal(a, b))


def max_abs_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    smi = smi.strip().splitlines()[0].strip()
    log("device", f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
                  f"torch {torch.__version__} cuda {torch.version.cuda} | "
                  f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path = build.build()
    log("build", f"{time.perf_counter() - t0:.2f} s: {path.name} from "
                 f"{', '.join(src.name for src in build.SOURCES)}")
    kernel = ""
    for line in build.BUILD_LOG.splitlines():
        m = re.search(r"\d([a-z][a-z_]*_kernel)(I\w*?E)?E", line)
        if "entry function" in line and m:       # the mangled name, shortened
            kernel = m.group(1) + (m.group(2) or "")
        elif "registers" in line or "spill" in line:
            log("build", f"{kernel}: {line.replace('ptxas info    :', '').strip()}")


def compare_kernels(x2d, u2d, bits):
    """Run B1-B3 and their plain versions on (rows, 512) inputs; raise unless
    bitwise equal.  Returns {name: max_abs_err}."""
    from repro_torch.kernels import bitpack, quant8, ref
    out = quant8.quant_dequant_2d(x2d, u2d, bits)
    want = ref.quant_dequant_ref(x2d, u2d, bits)
    errs = {"quant_dequant_2d": max_abs_err(out, want)}
    require(bits_equal(out, want), f"B1 != plain (bits={bits})")
    del want
    q, s = bitpack.quant_pack_2d(x2d, u2d, bits)
    qw, sw = ref.quant_pack_ref(x2d, u2d, bits)
    errs["quant_pack_2d"] = max(max_abs_err(q, qw), max_abs_err(s, sw))
    require(bits_equal(q, qw) and bits_equal(s, sw), f"B2 != plain (bits={bits})")
    del qw, sw
    deq = bitpack.unpack_dequant_2d(q, s)
    want = ref.unpack_dequant_ref(q, s)
    errs["unpack_dequant_2d"] = max_abs_err(deq, want)
    require(bits_equal(deq, want), f"B3 != plain (bits={bits})")
    require(bits_equal(deq, out), f"B3(B2) != B1 (bits={bits})")
    return errs


def phase_kernels(device):
    import torch
    from repro_torch.kernels import ops
    g = torch.Generator(device=device).manual_seed(11)
    d = 5 * 512 + 37                                       # ragged tail
    x = torch.randn(d, generator=g, device=device) * 3.0
    x[1024:1536] = 0.0                                     # an all-zero row
    for bits in (8, 4):
        noise = torch.rand((ops.tile_rows(d), 512), generator=g, device=device)
        padded, noise, _ = ops._quant_tiles(x, noise)
        compare_kernels(padded, noise, bits)
    rows = (1 << 26) // 512
    x2 = torch.randn((rows, 512), generator=g, device=device) * 0.02
    x2[::97] = 0.0
    u2 = torch.rand((rows, 512), generator=g, device=device)
    compare_kernels(x2, u2, 8)
    log("kernels", f"B1-B3 == plain bit for bit: ragged d={d} (bits 8, 4), "
                   f"slice {rows}x512 (bits 8)")
    for d in RAGGED_D:
        compare_mask_kernels(torch.rand(d, generator=g, device=device) < 0.3)
        x = torch.randn(d, generator=g, device=device) * 3.0
        x[:min(d, 512)] = 0.0                                 # a zero row
        u = torch.rand((ops.tile_rows(d), 512), generator=g, device=device)
        compare_stream_kernel(*ops._quant_tiles(x, u)[:2])
    log("kernels", f"B4/B5 and B6 == plain bit for bit (B6 == B2): ragged d in {RAGGED_D}")


def phase_lint(device):
    """``python -m repro_torch.lint --device cuda`` in this process over its
    default paths (src/repro_torch and this script): exit 0, no finding.
    Its contracts run on the card: RC001's qsgd_kernel carriers (B1), RC002's
    qsgd_kernel probe (B1, B2, B3) and RC003's card half, each kernel's
    launch resources from the built library.  B1-B3 must launch, and every
    launch of them on the card is held bit for bit against its plain
    version on the same inputs (probes in ``kernels.ops``); one line per
    kernel instance gives its resources.  Returns the resource rows."""
    import contextlib
    import io
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import bitpack, ops, quant8, ref
    from repro_torch.lint import contracts
    from repro_torch.lint.__main__ import main as lint_main
    b3 = KernelProbe(bitpack, "unpack_dequant_2d", ref.unpack_dequant_ref, every=True)
    probes = {"B1": KernelProbe(quant8, "quant_dequant_2d", ref.quant_dequant_ref, every=True),
              "B2": KernelProbe(b3, "quant_pack_2d", ref.quant_pack_ref, every=True),
              "B3": b3}
    kernels.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    ops._q8, ops._bp = probes["B1"], probes["B2"]
    try:
        with contextlib.redirect_stdout(buf):
            rc = lint_main(["--device", "cuda", "--format", "json"])
    finally:
        ops._q8, ops._bp = quant8, bitpack
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    doc = json.loads(buf.getvalue())
    counts = kernels.launch_counts()
    require(rc == 0 and doc["findings"] == [] and doc["baselined"] == 0,
            f"lint: exit {rc}, findings {doc['findings']}")
    for kid, name, _, _ in KERNEL_INFO:
        require(counts[name] > 0, f"{kid} {name} was not launched by the lint's contracts")
        held = [c for c in probes[kid].checks if c[1] == "cuda"]
        require(len(held) == counts[name],
                f"lint: {kid} launched {counts[name]} times, {len(held)} held to plain")
        require(all(c[2] for c in held), f"lint: {kid} != plain on {[c for c in held if not c[2]]}")
        log("lint", f"{kid} {name}: {len(held)} launches == plain bit for bit, shapes "
                    f"{sorted({c[0] for c in held})}, max_abs_err "
                    f"{max(c[3] for c in held)}")
    rows = contracts.kernel_resources(device)
    for r in rows:
        m = r["launch"]
        at = f" d_in {m.d_in} ({'staged' if r['staged'] else 'unstaged'})" if m.d_in else ""
        per = "clusters per device" if r["cluster"] > 1 else "blocks per SM"
        log("lint", f"{m.kid} {r['name']}{at}: {r['threads']} threads x cluster "
                    f"{r['cluster']}, {r['regs']} registers, {r['static_smem']} B static "
                    f"+ {r['dyn_smem']} B dynamic shared, {r['local']} B local, "
                    f"{r['occupancy']} {per}")
    log("lint", f"exit {rc}: 0 findings in {doc['checked_files']} files, "
                f"{seconds:.2f} s; launches {counts}; opt-in shared memory "
                f"{rows[0]['optin']} B")
    return rows


def compare_mask_kernels(mask):
    """B4 (ops.pack_bits) and B5 (ops.unpack_bits) on a flat bool mask
    against their plain versions; raise unless bitwise equal.  Returns
    {name: max_abs_err}."""
    from repro_torch.kernels import ops, ref
    d = mask.numel()
    w = ops.pack_bits(mask)
    W = w.numel()
    wp = ref.pack_mask_ref(padded_mask(mask, 32 * W).view(32, W)).reshape(-1)
    require(bits_equal(w, wp), f"B4 != plain (d={d})")
    back = ops.unpack_bits(w, d)
    want = ref.unpack_mask_ref(w.view(1, W)).reshape(-1)[:d]
    require(bits_equal(back, want), f"B5 != plain (d={d})")
    require(bits_equal(back, mask.to(back.dtype)), f"B5(B4(mask)) != mask (d={d})")
    return {"pack_mask_2d": max_abs_err(w, wp), "unpack_mask_2d": max_abs_err(back, want)}


def compare_stream_kernel(x2d, u2d):
    """B6 on (rows, 512) inputs against its plain version and against B2;
    raise unless bitwise equal.  Returns {name: max_abs_err}."""
    from repro_torch.kernels import bitpack, ref, stream
    q, s = stream.stream_quant_pack_2d(x2d, u2d)
    qw, sw = ref.stream_quant_pack_ref(x2d, u2d, tile_rows=1 << 17)
    require(bits_equal(q, qw) and bits_equal(s, sw), f"B6 != plain ({x2d.shape[0]} rows)")
    err = max(max_abs_err(q, qw), max_abs_err(s, sw))
    del qw, sw
    q2, s2 = bitpack.quant_pack_2d(x2d, u2d)
    require(bits_equal(q, q2) and bits_equal(s, s2), f"B6 != B2 ({x2d.shape[0]} rows)")
    return {"stream_quant_pack_2d": err}


def padded_mask(mask, n):
    """``mask`` zero-padded to ``n`` entries (itself when it has n)."""
    if mask.numel() == n:
        return mask
    out = mask.new_zeros(n)
    out[:mask.numel()] = mask
    return out


# ---------------------------------------------------------------------------
def checked_batcher_class():
    import torch
    from repro_torch.serve import PersonalizedBatcher

    class CheckedBatcher(PersonalizedBatcher):
        """Runs the materialized path beside every delta-path step and
        requires bitwise-equal logits."""

        def __init__(self, *args, eff_by_uid, **kw):
            self.eff_by_uid = eff_by_uid
            self.slot_uid = [None] * kw["n_slots"]
            self.mcache = None
            self.checked = 0
            super().__init__(*args, **kw)

        def _on_admit(self, slot, req):
            super()._on_admit(slot, req)
            self.slot_uid[slot] = req.user_id

        def _on_retire(self, slot, req):
            super()._on_retire(slot, req)
            self.slot_uid[slot] = None

        def _check(self, logits, lm, what):
            what = f"{what} (step {self.checked})"
            require(bool(torch.isfinite(logits.float()).all()), f"{what}: non-finite logits")
            require(bits_equal(logits, lm), f"{what}: delta path != materialized path")
            self.checked += 1

        def _eff(self):
            return [self.eff_by_uid[u] for u in self.slot_uid]

        def _model_prefill(self, batch):
            out = super()._model_prefill(batch)
            lm, self.mcache = self.engine.prefill_materialized(self._eff(), batch["tokens"])
            self._check(out[0], lm, "prefill")
            return out

        def _model_decode(self, tok):
            out = super()._model_decode(tok)
            lm, self.mcache = self.engine.decode_materialized(self._eff(), tok, self.mcache)
            self._check(out[0], lm, "decode")
            return out

    return CheckedBatcher


class MemMarks:
    """Peak and live device memory per step (torch.cuda allocator stats);
    records nothing off the card."""

    def __init__(self, device):
        import torch
        self.device, self.marks = device, []
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

    def mark(self, label):
        import torch
        if self.device.type != "cuda":
            return
        torch.cuda.synchronize(self.device)
        self.marks.append((label, torch.cuda.max_memory_allocated(self.device),
                           torch.cuda.memory_allocated(self.device)))
        torch.cuda.reset_peak_memory_stats(self.device)

    def summary(self):
        if not self.marks:
            return "memory: not measured off the card"
        return "memory GiB (peak during / allocated after): " + ", ".join(
            f"{k} {p / 2**30:.2f}/{a / 2**30:.2f}" for k, p, a in self.marks) + \
            f"; overall peak {max(p for _, p, _ in self.marks) / 2**30:.2f}"


def phase_serve(cfg, device):
    """The main path.  Returns (launch counts, rows of the quantized delta,
    one user's payload bytes)."""
    return serve_users(cfg, device, "serve", PROMPT, MAX_LEN)


def serve_users(cfg, device, phase, prompt, max_len):
    """Personalized serving of ``cfg`` at full width: a qsgd_kernel store
    of two norm-personalized users (B2 + B1 per put), a BlockPool (B3) and
    the checked PersonalizedBatcher answering REQUEST_USERS' requests with
    ``prompt``-token prompts over N_SLOTS slots.  Returns (launch counts,
    rows of the quantized delta, one user's payload bytes)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.comm.buckets import bucketize
    from repro_torch.comm.ledger import PAGE_IN_TAG, PAGE_OUT_TAG
    from repro_torch.core.compressors import make_compressor
    from repro_torch.kernels import bitpack, ops, quant8, ref
    from repro_torch.kernels.ops import tile_rows
    from repro_torch.models import init_params
    from repro_torch.serve import BlockPool, DeltaStore, personalize_leaves
    from repro_torch.training.serving import Request
    from repro_torch.utils.device import fold_seed
    from repro_torch.utils.tree import tree_leaves

    on_card = device.type == "cuda"
    mem = MemMarks(device)
    t0 = time.perf_counter()
    params = init_params(0, cfg, device=device)
    n_params = sum(int(leaf.numel()) for leaf in tree_leaves(params))
    log(phase, f"{cfg.name}: {n_params} params ({cfg.dtype}) initialised "
                 f"in {time.perf_counter() - t0:.2f} s")
    mem.mark("init")

    # -- main path, part 1: the store (B2 + B1 per put, B3 in the certificate);
    # the first put's three launches held to their plain versions
    b3 = KernelProbe(bitpack, "unpack_dequant_2d", ref.unpack_dequant_ref,
                     slice_rows=PROBE_SLICE_ROWS)
    probes = {"put B2": KernelProbe(b3, "quant_pack_2d", ref.quant_pack_ref,
                                    slice_rows=PROBE_SLICE_ROWS),
              "put B1": KernelProbe(quant8, "quant_dequant_2d", ref.quant_dequant_ref,
                                    slice_rows=PROBE_SLICE_ROWS),
              "put B3": b3}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    store = DeltaStore(params, make_compressor("qsgd_kernel", bits=8), seed=7)
    ops._q8, ops._bp = probes["put B1"], probes["put B2"]
    try:
        for uid in USERS:
            pers = personalize_leaves(params, fold_seed(1, uid), match=("norm",))
            store.put(uid, pers)
            del pers
    finally:
        ops._q8, ops._bp = quant8, bitpack
    if on_card:
        torch.cuda.synchronize(device)
    counts = kernels.launch_counts()
    del params
    mem.mark("puts")
    rows = tile_rows(store.layout.padded_d)
    log(phase, f"store: {store.layout.n_buckets} blocks of {store.layout.bucket_size}, "
                 f"delta rows {rows}; {len(USERS)} certified puts in "
                 f"{time.perf_counter() - t0:.2f} s; payload bytes "
                 f"{[store.nbytes(u) for u in USERS]}; page_out "
                 f"{store.ledger.bytes_by_tag().get(PAGE_OUT_TAG, 0)}")

    # -- oracle (not counted): materialized per-user blocks, pool sizing
    eff_by_uid = {None: store.base_blocks}
    need = 0
    for uid in USERS:
        need += int(store.blocks(uid).ne(0).any(dim=1).sum())
        eff_by_uid[uid] = bucketize(store.personalized_params(uid),
                                    store.layout.bucket_size)[0]
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    mem.mark("oracle")

    # -- main path, part 2: page-in (B3) and serving
    # the first page-in's B3 held to its plain version
    probes["page-in B3"] = KernelProbe(bitpack, "unpack_dequant_2d", ref.unpack_dequant_ref,
                                       slice_rows=PROBE_SLICE_ROWS)
    kernels.reset_launch_counts()
    pool = BlockPool(store, capacity_blocks=need)
    Batcher = checked_batcher_class()
    b = Batcher(cfg, store, pool, n_slots=N_SLOTS, max_len=max_len, eff_by_uid=eff_by_uid)
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, prompt),
                    max_new=MAX_NEW, user_id=u) for i, u in enumerate(REQUEST_USERS)]
    for r in reqs:
        b.submit(r)
    t0 = time.perf_counter()
    ops._bp = probes["page-in B3"]
    try:
        stats = b.run(max_ticks=1000)
    finally:
        ops._bp = bitpack
    if on_card:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    for k, v in kernels.launch_counts().items():
        counts[k] += v
    mem.mark("serve")

    require(stats.completed == len(reqs), f"completed {stats.completed} of {len(reqs)}")
    calls = N_SLOTS * (stats.decode_steps + stats.prefills)
    require(counts["delta_apply"] == (calls if on_card else 0),
            f"D1 launched {counts['delta_apply']} times for {calls} delta-path slot calls")
    require(all(len(r.generated) == MAX_NEW and all(0 <= t < cfg.vocab_size
                                                    for t in r.generated) for r in reqs),
            "generated tokens out of range")
    page_in = store.ledger.bytes_by_tag().get(PAGE_IN_TAG, 0)
    want = sum(store.nbytes(u) for u in USERS)
    require(pool.misses == len(USERS), f"{pool.misses} misses, expected {len(USERS)}")
    require(page_in == want == pool.bytes_paged_in,
            f"serve/page_in {page_in} != payload bytes of the misses {want}")
    for name, pr in probes.items():
        require(pr.checked is not None and pr.checked[0] == (rows, quant8.QBLOCK),
                f"{name}'s first call on this path was not the ({rows}, {quant8.QBLOCK}) "
                f"delta: {pr.checked}")
        require(pr.checked[1], f"{name} on the {cfg.name} delta != plain: {pr.checked}")
    log(phase, f"{len(reqs)} requests ({stats.tokens_out} tokens) over {N_SLOTS} slots "
                 f"in {wall:.2f} s with checks; {b.checked} steps bitwise equal to "
                 f"the materialized path (prefill + every decode step)")
    log(phase, f"serve/page_in {page_in} bytes == payload bytes of {pool.misses} misses; "
                 f"pool {pool.stats()}")
    log(phase, "on this path's own inputs, held bit for bit to the plain versions "
                 f"{PROBE_SLICE_ROWS} rows at a time (the first call of each): " + ", ".join(
                     f"{k} {pr.checked[0]} (max_abs_err {pr.checked[2]})"
                     for k, pr in probes.items()))
    if on_card:
        log(phase, mem.summary())
    log(phase, "kernels " + json.dumps(counts))
    payload_bytes = store.nbytes(USERS[0])
    del b, pool, store, eff_by_uid
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return counts, rows, payload_bytes


def phase_ref(device):
    """Small f32 model: the port's forward on ``device`` vs the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params, prefill
    from repro_torch.utils.tree import tree_map

    cfg = get_config(ARCH).reduced()
    p_cpu = init_params(3, cfg, device="cpu")
    p_dev = tree_map(lambda a: a.to(device), p_cpu)
    toks = torch.as_tensor(np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 24)))
    l_cpu, _ = prefill(p_cpu, cfg, {"tokens": toks}, cache_len=40)
    l_dev, _ = prefill(p_dev, cfg, {"tokens": toks.to(device)}, cache_len=40)
    err = max_abs_err(l_cpu, l_dev.cpu())
    require(err <= REF_ATOL, f"prefill logits card vs CPU: {err} > {REF_ATOL}")
    g_cpu = generate(cfg, p_cpu, toks, 8)
    g_dev = generate(cfg, p_dev, toks.to(device), 8)
    require(np.array_equal(g_cpu, g_dev), "greedy tokens card != CPU")
    log("ref", f"reduced {ARCH} f32: prefill logits max |card - CPU| = {err:.3g} "
               f"(<= {REF_ATOL}); 8 greedy tokens equal")


# ---------------------------------------------------------------------------
def cli_args(cfg, device):
    """The prune CLI's flags for ``cfg`` on ``device`` (the card is its
    default; a reduced config is ``--reduced``)."""
    from repro_torch.configs import get_config
    argv = ["--arch", cfg.name, "--seed", "0"]
    if device.type != "cuda":
        argv += ["--device", "cpu"]
    if cfg != get_config(cfg.name):
        require(cfg == get_config(cfg.name).reduced(), "a config the CLI cannot name")
        argv.append("--reduced")
    return argv


def phase_prune(cfg, device, saved):
    """The pruning path on the train phase's checkpoint (``saved``), then its
    checks.  Returns (launch counts of the path, selecting B8 launches,
    {kernel: max |kernel - plain|}, (layer 0's trained w_in, calibration X))."""
    import math
    import torch
    from repro_torch import kernels
    from repro_torch.core import symwanda as sw
    from repro_torch.kernels import nm_prune, ops, ref, wanda_score
    from repro_torch.launch import prune as prune_cli
    from repro_torch.utils.tree import tree_flatten_with_path

    on_card = device.type == "cuda"
    mem = MemMarks(device)
    # -- main path: the CLI a user runs, on the card (its default device),
    #    pruning the trained checkpoint
    argv = cli_args(cfg, device) + ["--ckpt", saved["path"]]
    seen = {}                   # the CLI's own load and ladder, timed apart
    load, ladder_fn = prune_cli.load_params, prune_cli.loss_ladder

    def timed_load(*a, **kw):
        seen["params"], seen["load_s"] = timed(device, lambda: load(*a, **kw))
        mem.mark("load")
        return seen["params"]

    def timed_ladder(*a, **kw):
        out, seen["ladder_s"] = timed(device, lambda: ladder_fn(*a, **kw))
        return out

    kernels.reset_launch_counts()
    prune_cli.load_params, prune_cli.loss_ladder = timed_load, timed_ladder
    try:
        ladder = prune_cli.main(argv)
    finally:
        prune_cli.load_params, prune_cli.loss_ladder = load, ladder_fn
    counts = kernels.launch_counts()
    selecting = wanda_score.wanda_prune_2d.selecting
    mem.mark("ladder")
    require(all(math.isfinite(v) for v in ladder.values()), f"non-finite loss: {ladder}")
    require(selecting == counts["wanda_prune_2d"],
            f"{counts['wanda_prune_2d'] - selecting} of the ladder's B8 launches took tau")
    log("prune", f"loss ladder of {len(ladder)} rows on the trained checkpoint in "
                 f"{seen['ladder_s']:.2f} s; dense {ladder['dense']:.4f} vs ln V "
                 f"{math.log(cfg.vocab_size):.4f}; kernels {json.dumps(counts)}, B8 selecting "
                 f"{selecting}; ladder {json.dumps(ladder)}")

    # -- checks (their launches are not counted): the CLI's load equals the
    #    trained tensors bit for bit, then B7/B8 on the trained w_in layers
    params = seen.pop("params")
    got, want = tree_flatten_with_path(params)[0], tree_flatten_with_path(saved["params"])[0]
    require([k for k, _ in got] == [k for k, _ in want], "loaded keys != trained keys")
    for (key, a), (_, b) in zip(got, want):
        require(a.device.type == device.type and bits_equal(a, b.to(device)),
                f"{key}: loaded != the trained tensor")
    load_s = seen["load_s"]
    log("prune", f"checkpoint: saved in {saved['save_s']:.2f} s, loaded by the CLI in "
                 f"{load_s:.2f} s ({saved['bytes']} B on disk, {saved['bytes'] / load_s / 1e9:.2f} "
                 f"GB/s); {len(got)} leaves bit for bit equal to the tensors the train run "
                 f"ended with")
    t0 = time.perf_counter()
    X = prune_cli.calib_acts(params, cfg, prune_cli.calib_batch(cfg, 0, device))
    stack = params["blocks"]["pos0"]["mlp"]["w_in"]
    errs = {"nm_prune_2d": 0.0, "wanda_prune_2d": 0.0}
    n_checked = nm_differ = n_selecting = 0
    for li in range(stack.shape[0]):
        W = stack[li]
        d_in, d_out = W.shape
        for mode in prune_cli.FUSED:
            for sparsity in prune_cli.SPARSITIES:
                wp, kw, (r, c) = ops.scored_args(W, X, mode, sparsity)
                out, mask = wanda_score.wanda_prune_2d(wp, **kw)
                ro, rm = ref.wanda_prune_ref(wp, **kw)
                what = f"B8 layer {li} {mode}@{sparsity}"
                require(bits_equal(out, ro) and bits_equal(mask, rm), f"{what} != plain")
                k = ops.keep_count(d_in, sparsity)
                # the selecting mode against scored_args' torch.topk + plain
                tau = kw.pop("tau")
                so, sm, st = wanda_score.wanda_prune_2d(wp, tau=None, k=k, rows=r, cols=c, **kw)
                require(bits_equal(so, ro) and bits_equal(sm, rm) and bits_equal(st, tau),
                        f"{what}: selecting (out, mask, tau) != scored_args + plain")
                errs["wanda_prune_2d"] = max(errs["wanda_prune_2d"], max_abs_err(out, ro),
                                             max_abs_err(mask, rm), max_abs_err(so, ro),
                                             max_abs_err(sm, rm), max_abs_err(st, tau))
                n_selecting += 1
                require(int(mask.sum(0, dtype=torch.int32).min()) >= k,
                        f"{what}: a column keeps fewer than {k}")
                if mode == "wanda":
                    _, m_mod = sw.prune(W, X, method="wanda", sparsity=sparsity)
                    require(torch.equal(mask.float(), m_mod), f"{what} != symwanda.prune")
                n_checked += 1
        S = sw.score_wanda(W, X)
        out, mask = nm_prune.nm_prune_2d(W, S, 2, 4)
        ro, rm = ref.nm_prune_ref(W, S, 2, 4)
        require(bits_equal(out, ro) and bits_equal(mask, rm), f"B7 layer {li} != plain")
        errs["nm_prune_2d"] = max(errs["nm_prune_2d"], max_abs_err(out, ro),
                                  max_abs_err(mask, rm))
        grp = mask.reshape(d_in // 4, 4, d_out)
        require(bool((grp.sum(1, dtype=torch.int32) == 2).all()), f"B7 layer {li}: not 2:4")
        differ = (mask.float() != sw.mask_nm(S, 2, 4)).reshape(d_in // 4, 4, d_out).any(1)
        tied = (S.reshape(d_in // 4, 4, d_out).sort(1).values.diff(dim=1) == 0).any(1)
        require(not bool((differ & ~tied).any()),
                f"B7 layer {li}: a disagreement with mask_nm in a group without ties")
        nm_differ += int(differ.sum())
        n_checked += 1
    if on_card:
        torch.cuda.synchronize(device)
    mem.mark("checks")
    log("prune", f"{n_checked} kernel calls on {stack.shape[0]} trained w_in "
                 f"{tuple(stack.shape[1:])} {stack.dtype} layers bit for bit equal to the plain versions, and "
                 f"{n_selecting} selecting B8 calls' (out, mask, tau) equal to scored_args' "
                 f"torch.topk + plain; B8 wanda "
                 f"masks == symwanda.prune; B7 vs mask_nm: {nm_differ} differing groups, "
                 f"all with tied scores; {time.perf_counter() - t0:.2f} s")
    if on_card:
        log("prune", mem.summary())
    layer = (stack[0].clone(), X)
    del params, stack
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return counts, selecting, errs, layer


def phase_prune_wide(cfg, device):
    """The prune CLI on the random weights of a second full-width decoder
    (qwen1.5-4b: QKV bias, 40 w_in layers of 2560 x 6912): B7 once per
    layer, B8 eight times per layer (three modes at two sparsities, and the
    wanda of each R^2-DSnoT row), every B8 launch selecting.  Returns the
    launch counts."""
    import math
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import wanda_score
    from repro_torch.launch import prune as prune_cli

    on_card = device.type == "cuda"
    mem = MemMarks(device)
    kernels.reset_launch_counts()
    ladder, ladder_s = timed(device, lambda: prune_cli.main(cli_args(cfg, device)))
    counts = kernels.launch_counts()
    selecting = wanda_score.wanda_prune_2d.selecting
    kernels.reset_launch_counts()
    mem.mark("ladder")
    require(all(math.isfinite(v) for v in ladder.values()), f"non-finite loss: {ladder}")
    n = cfg.num_layers
    if on_card:
        require(counts["nm_prune_2d"] == n, f"B7 launched {counts['nm_prune_2d']}, not {n}")
        require(counts["wanda_prune_2d"] == selecting == 8 * n,
                f"B8 launched {counts['wanda_prune_2d']} ({selecting} selecting), not {8 * n}")
    peak = f"; peak {mem.marks[0][1] / 2**30:.2f} GiB" if on_card else ""
    log("prune_wide", f"{cfg.name} ({cfg.param_count()} params, {cfg.dtype}): loss ladder of "
                      f"{len(ladder)} rows in {ladder_s:.2f} s{peak}; dense "
                      f"{ladder['dense']:.4f} vs ln V {math.log(cfg.vocab_size):.4f}; kernels "
                      f"{json.dumps({k: v for k, v in counts.items() if v})}, B8 selecting "
                      f"{selecting}")
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
def timed(device, fn):
    """(fn(), host seconds) around synchronized work."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def phase_codec(cfg, device, serve_payload_bytes):
    """The codec path at full width.  Returns (launch counts of the path, the
    delta space's d).  ``serve_payload_bytes`` (the serve phase's
    qsgd_kernel payload of one user) is printed beside the bitmap payloads."""
    import dataclasses
    import torch
    from repro_torch import kernels
    from repro_torch.comm import codecs
    from repro_torch.comm.buckets import bucketize
    from repro_torch.comm.ledger import PAGE_IN_TAG, CommLedger
    from repro_torch.core.compressors import WireSpec, make_compressor
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serve import BlockPool, DeltaStore, personalize_leaves
    from repro_torch.utils.device import fold_seed, make_generator

    on_card = device.type == "cuda"
    mem = MemMarks(device)
    t_phase = time.perf_counter()
    path = {name: 0 for name in kernels.KERNELS}

    def tally():
        """Add the launches since the last reset to the path's counts."""
        for k, v in kernels.launch_counts().items():
            path[k] += v
        kernels.reset_launch_counts()

    params = init_params(0, cfg, device=device)
    mem.mark("init")

    # -- (a) store and pager on the bitmap wire (B4 per put, B5 in each
    #    certificate and page-in)
    bitmap = dataclasses.replace(make_compressor("top_k", k_frac=0.01),
                                 wire=WireSpec("sparse_bitmap"))
    kernels.reset_launch_counts()
    store = DeltaStore(params, bitmap, seed=7)
    d = store.layout.padded_d
    put_s = []
    for uid in USERS:
        pers = personalize_leaves(params, fold_seed(1, uid), match=("norm",))
        put_s.append(timed(device, lambda: store.put(uid, pers))[1])
        del pers
    tally()
    mem.mark("puts")
    oracle = {}                                    # not counted: decoded blocks
    for uid in USERS:
        blocks = store.blocks(uid)
        nz = torch.nonzero(blocks.ne(0).any(dim=1)).reshape(-1)
        oracle[uid] = (nz, blocks.index_select(0, nz))
        del blocks
    kernels.reset_launch_counts()
    pool = BlockPool(store, capacity_blocks=sum(int(nz.numel()) for nz, _ in oracle.values()))
    page_s = []
    for uid in USERS:
        entry, sec = timed(device, lambda: pool.acquire(uid))
        page_s.append(sec)
        nz, want = oracle[uid]
        require(entry.n_blocks == nz.numel() and int(entry.table.ne(0).sum()) == nz.numel(),
                f"user {uid}: {entry.n_blocks} resident blocks, {nz.numel()} nonzero")
        require(bits_equal(pool.blocks.index_select(0, entry.table[nz].long()), want),
                f"user {uid}: resident blocks != store.blocks' nonzero blocks")
        pool.release(uid)
    tally()
    mem.mark("pager")
    n_words = -(-d // 32)
    for uid in USERS:
        p = store.payload(uid)
        require(p.scheme == "sparse_bitmap" and p.planes["mask_words"].size == n_words
                and p.nbytes == 4 * n_words + 4 * p.planes["values"].size,
                f"user {uid}: payload {p.nbytes} B != 4 * {n_words} + 4 * nnz")
    page_in = store.ledger.bytes_by_tag().get(PAGE_IN_TAG, 0)
    require(page_in == store.total_payload_bytes() == pool.bytes_paged_in,
            f"serve/page_in {page_in} != payload bytes {store.total_payload_bytes()}")
    log("codec", f"(a) d={d}: {store.layout.n_buckets} blocks, {n_words} mask words; "
                 f"bitmap payloads {[store.nbytes(u) for u in USERS]} B (nnz "
                 f"{[store.payload(u).planes['values'].size for u in USERS]}) beside the "
                 f"serve phase's qsgd_kernel payload of {serve_payload_bytes} B; puts "
                 f"{[round(t, 3) for t in put_s]} s, page-ins {[round(t, 3) for t in page_s]} s; "
                 f"resident blocks {[int(nz.numel()) for nz, _ in oracle.values()]} bitwise == "
                 f"store.blocks; serve/page_in {page_in} B == payload bytes")

    # -- (b) streamed uplink of a full-model update, every leaf perturbed
    pers = personalize_leaves(params, fold_seed(2, 0), match=("",))
    x = bucketize(pers, store.layout.bucket_size)[0].sub_(store.base_blocks).reshape(-1)
    del pers, params, store, pool, oracle
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    mem.mark("x")
    k = max(1, int(round(0.01 * d)))
    topk_s = timed(device, lambda: torch.topk(x.abs(), k).values[-1])[1]
    mem.mark("topk")
    tally()
    ledger = CommLedger()
    u = None
    streams = (("top_k(0.01) + sparse_bitmap", ("top_k", {"k_frac": 0.01}), "sparse_bitmap"),
               ("topk_block(0.01, 2048) + sparse_block",
                ("topk_block", {"k_frac": 0.01, "block": 2048}), None),
               ("qsgd_kernel(8) + quant", ("qsgd_kernel", {"bits": 8}), None))
    for i, (label, (name, kw), scheme) in enumerate(streams):
        comp = make_compressor(name, **kw)
        if name == "qsgd_kernel":
            u = torch.rand((ops.tile_rows(d), 512), device=device,
                           generator=make_generator(fold_seed(3, 0), device))
        sec = {}
        sp, sec["encode_stream"] = timed(device, lambda: codecs.encode_stream(
            comp, x, scheme=scheme, noise=u))
        recs = ledger.record_stream(i, "leaf->agg", sp)
        require(sum(r.nbytes for r in recs) == sp.nbytes and len(recs) == sp.n_chunks
                == -(-d // codecs.DEFAULT_TILE), f"{label}: chunk records != nbytes")
        require(sp.chunks[0].start == 0 and sp.chunks[-1].stop == d and all(
            a.stop == b.start for a, b in zip(sp.chunks, sp.chunks[1:])),
            f"{label}: chunks do not tile [0, d)")
        p, sec["encode"] = timed(device, lambda: codecs.encode(comp, x, noise=u, scheme=scheme))
        require(p.nbytes == sp.nbytes, f"{label}: stream {sp.nbytes} B != payload {p.nbytes} B")
        y, sec["carrier"] = timed(device, lambda: comp(x, noise=u))
        out, sec["decode_stream"] = timed(device, lambda: codecs.decode_stream(sp, device))
        require(bool((out == y).all()), f"{label}: decode_stream != carrier")
        del out
        out, sec["decode"] = timed(device, lambda: codecs.decode(p, device))
        require(bool((out == y).all()), f"{label}: decode != carrier")
        del out
        tally()
        if scheme == "sparse_bitmap":             # not counted: B4/B5 vs plain
            compare_mask_kernels(y != 0)
            kernels.reset_launch_counts()
        kept = int(torch.count_nonzero(y))
        del y, sp, p
        mem.mark(f"stream {i}")
        log("codec", f"(b) {label}: {ledger.bytes_by_round()[i]} B in {len(recs)} chunks "
                     f"(== nbytes), {kept} kept; seconds " + ", ".join(
                         f"{k2} {v:.3f}" for k2, v in sec.items()))

    # -- (c) B6 at full width
    (q, s), b6_s = timed(device, lambda: ops.stream_quantize_pack(x, noise=u))
    tally()
    mem.mark("B6")
    x2d = x.view(-1, 512)                        # not counted: B6 vs plain, B6 == B2
    compare_stream_kernel(x2d, u)
    q2, s2 = ops.quantize_pack(x, noise=u)
    require(bits_equal(q, q2) and bits_equal(s, s2), "B6 != B2 at full width")
    kernels.reset_launch_counts()
    log("codec", f"(c) B6 stream_quantize_pack {tuple(q.shape)} in {b6_s:.3f} s == B2 "
                 f"quantize_pack bit for bit; B4/B5 at d={d} and B6 == plain bit for bit")
    del x, x2d, u, q, s, q2, s2
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        log("codec", mem.summary())
    log("codec", f"torch.topk(|x|, k={k}) over d={d}: {topk_s:.3f} s; phase "
                 f"{time.perf_counter() - t_phase:.2f} s; kernels {json.dumps(path)}")
    return path, d


# ---------------------------------------------------------------------------
class KernelProbe:
    """Stands in for a kernel module inside the module that calls it, for one
    run: the run's first call of ``fn`` (B1: a full chunk of step 0's delta;
    B2: the round report's probe, or a transmitted payload's encode; B3: a
    delivered payload's decode; in serve_users, the first certified put's B2,
    B1 and B3 and the first page-in's B3) is held bit for bit against its
    plain version on the same inputs.  The kernel call itself is the main path's, counted
    by the wrapper as always; the plain version launches nothing.  Probes
    chain: a probe of another probe stands in for both functions.  With
    ``every`` (the lint phase's probes) every call is held, and ``checks``
    lists each call's (input shape, device type, equal, max_abs_err)."""

    def __init__(self, module, fn, plain, slice_rows=None, every=False):
        self._mod, self._fn, self._plain = module, fn, plain
        self._slice_rows = slice_rows
        self._every = every
        self.checked = None
        self.checks = []

    def __getattr__(self, name):
        if name == self._fn:
            return self._call
        return getattr(self._mod, name)

    def _call(self, *args, **kw):
        kernel = getattr(self._mod, self._fn)
        if self.checked is not None and not self._every:
            return kernel(*args, **kw)
        if self._slice_rows:
            return self._call_sliced(kernel, args, kw)
        ins = tuple(a.clone() if hasattr(a, "clone") else a for a in args)
        out = kernel(*args, **kw)
        want = self._plain(*ins, **kw)
        got, want = (out, want) if isinstance(out, tuple) else ((out,), (want,))
        check = (tuple(args[0].shape), args[0].device.type,
                 all(bits_equal(g, w) for g, w in zip(got, want)),
                 max(max_abs_err(g, w) for g, w in zip(got, want)))
        self.checks.append(check)
        if self.checked is None:
            self.checked = (check[0],) + check[2:]
        del want
        return out

    def _call_sliced(self, kernel, args, kw):
        """With ``slice_rows``: the plain version first, ``slice_rows`` rows
        at a time over the same inputs (every tensor argument and output
        has the rows on axis 0, and the kernels work row by row), then the
        kernel, held slice by slice.  Only the plain output sits beside the
        main path's peak: no copy of the inputs, no full-size temporaries."""
        n, step = args[0].shape[0], self._slice_rows
        cuts = range(0, n, step)
        want = [self._plain(*(a[r:r + step] if hasattr(a, "shape") else a for a in args), **kw)
                for r in cuts]
        out = kernel(*args, **kw)
        got = out if isinstance(out, tuple) else (out,)
        equal, err = True, 0.0
        for i, r in enumerate(cuts):
            w = want[i] if isinstance(want[i], tuple) else (want[i],)
            want[i] = None
            for g, wi in zip(got, w):
                equal = equal and bits_equal(g[r:r + step], wi)
                err = max(err, max_abs_err(g[r:r + step], wi))
        self.checked = (tuple(args[0].shape), equal, err)
        self.checks.append((self.checked[0], args[0].device.type, equal, err))
        return out


def check_replicas(step, state, want_equal):
    """hier: after a sync step the replicas equal each other and the bf16
    anchor bit for bit; after step 0 they differ."""
    from repro_torch.utils.tree import tree_flatten
    leaves = tree_flatten(state.params)[0]
    anchor = tree_flatten(state.sync_state.h_bar)[0]
    same = [bits_equal(p[0], p[1]) for p in leaves]
    if want_equal:
        require(all(same), f"hier step {step}: replicas differ after a sync step")
        require(all(bits_equal(p[0], a.to(p.dtype)) for p, a in zip(leaves, anchor)),
                f"hier step {step}: replicas != the anchor cast to bf16")
    else:
        require(not all(same), f"hier step {step}: replicas equal before any sync")


def train_run(phase, label, cfg, tc, device, n_groups, n_pods, batches, on_step=None):
    """One traced run of ``training.loop.train`` for ``tc.total_steps``
    steps: finite losses and grad norms, the obs registry's series (each
    step's fetched metrics; the round cost once for a compressed sync), the
    peak and the launch counts.  Under efbv + ``qsgd_kernel``, B1 must
    launch G x chunks on every step, B2 for the round report, and the run's
    first B1 call (a full chunk of step 0's delta) and first B2 call (the
    report's probe) must equal their plain versions bit for bit.  The
    tracer still holds the run's spans on return.  Returns a dict (the
    final ``state`` included)."""
    import math
    import torch
    from repro_torch import kernels
    from repro_torch.core import distributed as dist
    from repro_torch.kernels import bitpack, ops, quant8, ref
    from repro_torch.kernels.ops import tile_rows
    from repro_torch.obs import registry, trace
    from repro_torch.training import loop
    from repro_torch.utils.tree import tree_leaves

    on_card = device.type == "cuda"
    steps = tc.total_steps
    probe = b2 = None
    if tc.sync.mode == "efbv" and tc.sync.compressor == "qsgd_kernel":
        probe = KernelProbe(quant8, "quant_dequant_2d", ref.quant_dequant_ref)
        b2 = KernelProbe(bitpack, "quant_pack_2d", ref.quant_pack_ref)
    run = {"b1_seen": [], "d": None}    # B1 launches counted after each step

    def step_hook(step, state, metrics):
        run["b1_seen"].append(kernels.launch_counts()["quant_dequant_2d"])
        if run["d"] is None:
            run["d"] = sum(int(p.numel()) for p in tree_leaves(state.params))
        if on_step is not None:
            on_step(step, state, metrics)

    free_cached(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    if probe is not None:
        dist.quant8, ops._bp = probe, b2
    kernels.reset_launch_counts()
    registry.reset()
    was_tracing = trace.enabled()
    tracer = trace.get_tracer()
    tracer.reset()
    trace.enable()
    try:
        t0 = time.perf_counter()
        state, history = loop.train(
            cfg, tc, batches, n_groups=n_groups, n_pods=n_pods, steps=steps,
            device=device, log=lambda m: log(phase, f"{label}: {m}"), on_step=step_hook)
        if on_card:
            torch.cuda.synchronize(device)
        run["s"] = time.perf_counter() - t0
    finally:
        trace.disable()
        if was_tracing:
            trace.enable()
        if probe is not None:
            dist.quant8, ops._bp = quant8, bitpack
    require(tracer.n_evicted == 0, f"{label}: the tracer evicted {tracer.n_evicted} spans")
    counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    run.update(state=state, history=history, counts=counts,
               peak_gib=torch.cuda.max_memory_allocated(device) / 2**30 if on_card else 0.0,
               losses=[h["loss"] for h in history], gnorms=[h["grad_norm"] for h in history],
               ces=[h["ce"] for h in history])
    require(len(history) == steps and all(math.isfinite(v) for v in run["losses"] + run["gnorms"]),
            f"{label}: non-finite loss or grad norm: {run['losses']} {run['gnorms']}")
    require([v for _, v in registry.get("train/loss").series] == run["losses"]
            and (tc.sync.mode == "dense") == (registry.get("comm/model/round_time_s") is None),
            f"{label}: registry series {registry.names()}")
    registry.reset()
    if probe is None:
        return run
    chunks = -(-tile_rows(run["d"]) // dist.CHUNK_ROWS)
    want = n_groups * chunks * steps
    b1_steps = [n - m for n, m in zip(run["b1_seen"], [0] + run["b1_seen"][:-1])]
    if on_card:
        require(b1_steps == [n_groups * chunks] * steps,
                f"{label}: B1 launches per step {b1_steps}, expected "
                f"{n_groups * chunks} on every step")
        require(counts["quant_dequant_2d"] == want,
                f"{label}: B1 launched {counts['quant_dequant_2d']} times, expected "
                f"{n_groups} groups x {chunks} chunks x {steps} steps = {want}")
        require(counts["quant_pack_2d"] >= 1, f"{label}: B2 did not launch for the round report")
        require(probe.checked is not None and probe.checked[0][0] == dist.CHUNK_ROWS,
                f"{label}: step 0's first B1 call was not a full chunk: {probe.checked}")
    require(probe.checked is not None and probe.checked[1],
            f"{label}: B1 chunk of step 0's delta != plain: {probe.checked}")
    from repro_torch.comm.accounting import PROBE_CAP
    probe_rows = tile_rows(min(cfg.param_count(), PROBE_CAP))
    require(b2.checked is not None and b2.checked[0] == (probe_rows, quant8.QBLOCK),
            f"{label}: the round report's first B2 call was not its "
            f"({probe_rows}, {quant8.QBLOCK}) probe: {b2.checked}")
    require(b2.checked[1], f"{label}: B2 on the round report's probe != plain: {b2.checked}")
    log(phase, f"{label}: B1 {counts['quant_dequant_2d']} launches (= {n_groups} groups x "
               f"{chunks} chunks x {steps} steps; per step {b1_steps}), B2 "
               f"{counts['quant_pack_2d']} (round report; its probe {b2.checked[0]} == "
               f"plain bit for bit, max_abs_err {b2.checked[2]}); "
               f"step 0's first B1 chunk {probe.checked[0]} == plain bit for bit "
               f"(max_abs_err {probe.checked[2]})")
    return run


def run_summary(run):
    """The run's losses, grad norms, peak and seconds."""
    return (f"losses {[round(v, 4) for v in run['losses']]}, grad norms "
            f"{[round(v, 4) for v in run['gnorms']]}; peak {run['peak_gib']:.2f} GiB; "
            f"run {run['s']:.2f} s; kernels "
            f"{json.dumps({k: v for k, v in run['counts'].items() if v})}")


def phase_train(cfg, device, ckpt):
    """The training path at full width: three runs through
    ``training.loop.train`` (train_run); the efbv + qsgd_kernel run's params
    are saved with ``save_checkpoint`` to ``ckpt`` (after its optimizer and
    sync state are freed).  Returns (the launch counts of the path, {"path",
    "params" (a host copy of the saved tensors), "save_s", "bytes"})."""
    from repro_torch import kernels
    from repro_torch.configs.base import SyncConfig, TrainConfig
    from repro_torch.core import distributed as dist
    from repro_torch.data.synthetic import SyntheticLMDataset, lm_batch_iterator
    from repro_torch.training.checkpoint import save_checkpoint
    from repro_torch.utils.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, length=100_000, seed=0)
    path = {name: 0 for name in kernels.KERNELS}
    summary = {}
    for label, sync_kw, steps, n_groups, n_pods in TRAIN_RUNS:
        tc = TrainConfig(model=cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, lr=3e-3,
                         warmup_steps=10, total_steps=steps, sync=SyncConfig(**sync_kw))
        on_step = None
        if label.startswith("hier"):
            def on_step(step, state, metrics):
                check_replicas(step, state, want_equal=step % 2 == 1)
        run = train_run("train", label, cfg, tc, device, n_groups, n_pods,
                        lm_batch_iterator(ds, TRAIN_BATCH, TRAIN_SEQ, seed=1), on_step=on_step)
        for k, v in run["counts"].items():
            path[k] += v
        cost = dist.round_comm(tc.sync, cfg.param_count(), device=device)   # not counted
        kernels.reset_launch_counts()
        state = run.pop("state")
        if label.startswith("efbv"):
            # the chain: these trained params are what the prune phase prunes
            trained = state.params
            del state
            free_cached(device)
            _, save_s = timed(device, lambda: save_checkpoint(ckpt, trained, step=steps))
            nbytes = os.path.getsize(ckpt + ".npz")
            saved = {"path": ckpt, "save_s": save_s, "bytes": nbytes,
                     "params": tree_map(lambda a: a.to("cpu"), trained)}
            log("train", f"{label}: saved {len(tree_leaves(trained))} leaves, "
                         f"{sum(a.numel() for a in tree_leaves(trained))} params "
                         f"({tree_leaves(trained)[0].dtype}) in {save_s:.2f} s: {nbytes} B "
                         f"on disk ({nbytes / save_s / 1e9:.2f} GB/s)")
            del trained
            state = None
        if label.startswith("hier"):
            log("train", f"{label}: replicas differ after step 0, bitwise equal to each other "
                         f"and to the bf16 anchor after steps 1 and 3")
        summary[label] = {"peak_gib": run["peak_gib"], "bytes_per_round": cost.total_bytes}
        log("train", f"{label}: {run_summary(run)}; RoundCost {cost.total_bytes:.0f} B/round "
                     f"(inter {cost.inter_bytes:.0f}, intra {cost.intra_bytes:.0f})")
        del state, run
    free_cached(device)
    log("train", f"phase {time.perf_counter() - t_phase:.2f} s; kernels {json.dumps(path)}; "
                 f"summary {json.dumps(summary)}")
    return path, saved


# ---------------------------------------------------------------------------
def close(got, want, rtol, what):
    """Require |got - want| <= rtol |want| elementwise; returns the largest
    relative difference."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    require(got.shape == want.shape, f"{what}: shapes {got.shape} != {want.shape}")
    rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))
    require(rel <= rtol, f"{what}: relative difference {rel:.3g} > {rtol}")
    return rel


def fedp3_run(device):
    """bench_fedp3's OPU3 configuration (10 clients, 5 a round, 3 trained
    layers, global prune ratio 0.9, 4 local steps, lr 0.2) for PAPER_ROUNDS
    rounds on the Dirichlet split, its draws from one CPU generator ->
    (accuracies, uploaded floats, final test loss, seconds)."""
    import torch
    from repro_torch.core import fedp3
    from repro_torch.data.federated import dirichlet_split

    X, y = fedp3.make_classification(n=2400, d=24, nclass=6, seed=0)
    Xte, yte = fedp3.make_classification(n=600, d=24, nclass=6, seed=1)
    idx = dirichlet_split(y, 10, alpha=0.5, seed=0)
    cfg = fedp3.FedP3Config(n_clients=10, clients_per_round=5, layers_per_client=3,
                            global_prune_ratio=0.9, local_steps=4, lr=0.2, seed=0)
    draws = fedp3.TorchDraws(torch.Generator().manual_seed(0))
    (acc, up, params), sec = timed(device, lambda: fedp3.fedp3_train(
        cfg, [X[i] for i in idx], [y[i] for i in idx], FEDP3_SIZES, PAPER_ROUNDS, Xte, yte,
        draws=draws, device=device))
    with torch.no_grad():
        loss = float(fedp3.xent(params, torch.as_tensor(Xte, device=device),
                                torch.as_tensor(yte, device=device).long(), 6))
    return acc, up, loss, sec


def phase_paper(device):
    """The paper's federated algorithms on the card, a smoke load: the
    federated_logreg example's EF-BV / EF21 / DIANA (rand_k(0.1), 800
    rounds) and Scafflix (alpha 0.1 / 0.5 / 0.9, 400 rounds) runs, and
    FedP3 at bench_fedp3's OPU3 configuration; the same calls on the CPU
    with the same draws; the two runs held to each other (communicated
    rounds and ledger bytes exactly, objective traces within PAPER_RTOL,
    FedP3's accuracy within 2 of 600 test points).  SPPM (numpy) once.
    Returns nothing: no kernel is on this path."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.comm.ledger import CommLedger
    from repro_torch.examples import cohort_squeeze, federated_logreg as fl

    cpu = torch.device("cpu")
    kernels.reset_launch_counts()
    runs = {}
    for dev in (device, cpu):
        say = (lambda msg, dev=dev: log("paper", f"{dev.type}:{msg}"))
        pb = fl.problem(dev)
        efbv, scafflix = fl.efbv_runs(pb, dev, log=say), fl.scafflix_runs(pb, dev, log=say)
        runs[dev.type] = dict(efbv=efbv, scafflix=scafflix, fedp3=fedp3_run(dev),
                              f_star=pb["f_star"])
    card, host = runs[device.type], runs["cpu"]
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    require(not launched, f"the paper path launched kernels: {launched}")
    for mode, r in card["efbv"].items():
        h = host["efbv"][mode]
        rel = close(r["trace"], h["trace"], PAPER_RTOL, f"efbv {mode} trace")
        require(r["msg_bytes"] == h["msg_bytes"], f"efbv {mode}: message bytes differ")
        rounds = len(r["trace"])
        require(CommLedger.from_rounds(r["msg_bytes"], rounds).cumulative_bytes() ==
                CommLedger.from_rounds(h["msg_bytes"], rounds).cumulative_bytes(),
                f"efbv {mode}: ledger bytes differ")
        require(abs(r["hit"] - h["hit"]) <= 1, f"efbv {mode}: gap-{fl.GAP:g} rounds "
                                               f"{r['hit']} vs {h['hit']}")
        log("paper", f"EF-BV {mode:5s}: {rounds} rounds, {1e3 * r['seconds'] / rounds:.3f} "
                     f"ms/round on the card ({1e3 * h['seconds'] / rounds:.3f} on the CPU); "
                     f"final gap {r['trace'][-1] - card['f_star']:.3e}, first round under "
                     f"{fl.GAP:g} {r['hit'] + 1 if r['hit'] >= 0 else 'none'} (CPU "
                     f"{h['hit'] + 1 if h['hit'] >= 0 else 'none'}); {r['msg_bytes']} B a "
                     f"message, {rounds * r['msg_bytes']} B ledger over all rounds on both; "
                     f"trace max rel diff card/CPU {rel:.2e}")
    for alpha, r in card["scafflix"].items():
        h = host["scafflix"][alpha]
        require(np.array_equal(r["comms"], h["comms"]),
                f"scafflix alpha={alpha}: communicated rounds differ")
        rel = close(r["trace"], h["trace"], PAPER_RTOL, f"scafflix alpha={alpha} trace")
        rounds = len(r["trace"])
        log("paper", f"Scafflix alpha={alpha}: {rounds} rounds, {int(r['comms'].sum())} "
                     f"communicated (equal on both), {1e3 * r['seconds'] / rounds:.3f} "
                     f"ms/round on the card ({1e3 * h['seconds'] / rounds:.3f} on the CPU); "
                     f"final gap {r['trace'][-1] - r['fstar']:.3e}; trace max rel diff "
                     f"{rel:.2e}")
    (acc, up, loss, sec), (hacc, hup, hloss, hsec) = card["fedp3"], host["fedp3"]
    require(np.array_equal(up, hup), "fedp3: uploaded floats differ")
    require(float(np.max(np.abs(acc - hacc))) <= 2 / 600 + 1e-9,
            f"fedp3: accuracies {acc} vs {hacc}")
    rel = close(loss, hloss, PAPER_RTOL, "fedp3 final test loss")
    log("paper", f"FedP3 OPU3: {PAPER_ROUNDS} rounds, {1e3 * sec / PAPER_ROUNDS:.2f} ms/round "
                 f"on the card ({1e3 * hsec / PAPER_ROUNDS:.2f} on the CPU); accuracy "
                 f"{acc[-1]:.4f} (CPU {hacc[-1]:.4f}), test loss {loss:.5f} (rel diff "
                 f"{rel:.2e}); uploaded {int(up[-1])} floats = {int(4 * up[-1])} B (equal)")
    prob, x_star = cohort_squeeze.problem()
    row, sppm_s = timed(cpu, lambda: cohort_squeeze.fig_5_1(prob, x_star, 50.0))
    log("paper", f"SPPM-AS (numpy, host) Fig 5.1 row, gamma 50: total cost TK by K "
                 f"{json.dumps({k: v for k, v in row.items()})} in {sppm_s:.2f} s")


# ---------------------------------------------------------------------------
def cohort_rounds(eng, device, n_rounds, trace=None):
    """Rounds 0..n-1 of ``eng`` -> (reports, anchors on the host after each
    round, host seconds per synchronized round, spans per round when
    ``trace`` is given: the tracer is on for rounds >= 1)."""
    import torch
    state, reps, anchors, secs, spans = eng.init_state(), [], [], [], []
    for rnd in range(n_rounds):
        if trace is not None and rnd == 1:
            trace.get_tracer().reset()
            trace.enable()
        (state, rep), sec = timed(device, lambda: eng.round(state, rnd))
        if trace is not None and rnd >= 1:
            spans.append({sp.name: sp.dur_us / 1e3 for sp in trace.get_tracer().spans()})
            trace.get_tracer().reset()
        reps.append(rep)
        secs.append(sec)
        anchors.append([a["x"].to("cpu", copy=True) for a in state.anchors])
    if trace is not None:
        trace.disable()
    del state
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return reps, anchors, secs, spans


def transmit_children(n, w, comp, cfg, fm, ledger, device):
    """(d)'s children: each encodes ``w`` with ``comp`` (B2) and sends it
    over the lossy uplink; every attempt's outcome must equal
    ``FaultModel.attempt_outcomes`` at lane ``attempt * n + child``, the
    ledger's tags the first attempt and the retries, and a delivered payload
    decode (B3) bit for bit as the sealed original.  -> (attempts sent,
    outcome counts)."""
    import copy

    import numpy as np
    from repro_torch.comm import codecs
    from repro_torch.comm.ledger import RETRY_TAG
    from repro_torch.faults import transmit
    from repro_torch.utils.device import fold_seed, make_generator

    sent, outcomes = 0, {"delivered": 0, "dropped": 0, "corrupt": 0}
    for child in range(n):
        p = codecs.encode(comp, w, generator=make_generator(fold_seed(17, child), device))
        original = copy.deepcopy(codecs.seal_payload(p))
        res = transmit(p, cfg, rnd=0, level_name="uplink", n_children=n, child=child,
                       ledger=ledger)
        drops = corrupt = 0
        for k in range(res.attempts):
            dr, co, _ = fm.attempt_outcomes(0, 0, 0, lanes=np.array([k * n + child]))
            if k == 0:
                d0, c0, _ = fm.attempt_outcomes(0, 0, 0)
                require((dr[0], co[0]) == (d0[child], c0[child]), f"child {child}: lane draw")
            last = res.delivered and k == res.attempts - 1
            require(bool(dr[0] or co[0]) != last, f"child {child} attempt {k}: outcome "
                                                  f"differs from attempt_outcomes")
            drops, corrupt = drops + int(dr[0]), corrupt + int(co[0])
        require((drops, corrupt) == (res.n_dropped, res.n_corrupt),
                f"child {child}: {res.n_dropped} dropped, {res.n_corrupt} corrupt; the fault "
                f"model says {drops}, {corrupt}")
        tags = [rec.tag for rec in ledger.records if rec.link == f"uplink/child{child}"]
        require(tags == ["uplink"] + [RETRY_TAG] * (res.attempts - 1), f"child {child}: {tags}")
        if res.delivered:
            require(bits_equal(codecs.decode(res.payload, device),
                               codecs.decode(original, device)),
                    f"child {child}: delivered payload decodes differently")
        sent += res.attempts
        outcomes["delivered"] += int(res.delivered)
        outcomes["dropped"] += res.n_dropped
        outcomes["corrupt"] += res.n_corrupt
        del p, original, res
    return sent, outcomes


def phase_cohort(device, d, payload_bytes, pop_size=COHORT_POP, cohort=COHORT_SIZE,
                 w_in=W_IN):
    """The Cohort-Squeeze cohort engine on the card.  (a) The headline round
    (10^5 clients sampled from 10^6) for rounds 0-4 on the card and on the
    CPU: bytes and participants equal the table, anchors equal bit for bit,
    the registry's series; (b) retained device bytes and staged host bytes
    O(cohort); (c) the analytic bytes against the encoded oracle; (d)
    lossy-link transmit of qsgd_kernel payloads (B2 encode, B3 decode).
    Returns this phase's kernel launch counts (B2 and B3 must be nonzero)."""
    import copy

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.cohort import CohortEngine, Population, materialized_round_bytes
    from repro_torch.comm import codecs
    from repro_torch.comm.ledger import CommLedger
    from repro_torch.comm.topology import Link
    from repro_torch.comm.tree import TreeLevel, TreeTopology
    from repro_torch.core.compressors import qsgd_kernel
    from repro_torch.faults import FaultConfig, FaultModel, corrupt_payload, transmit
    from repro_torch.kernels import bitpack, ops, quant8, ref
    from repro_torch.kernels.ops import tile_rows
    from repro_torch.obs import trace
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.utils.device import make_generator

    on_card = device.type == "cuda"
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    headline = (pop_size, cohort) == (COHORT_POP, COHORT_SIZE)
    faults = FaultConfig(**COHORT_FAULTS)
    kernels.reset_launch_counts()

    # -- (a) the headline round, card then CPU
    pop = Population(n_clients=pop_size, dim=COHORT_DIM)
    runs = {}
    for dev in (device, cpu):
        reg = MetricsRegistry()
        eng = CohortEngine(pop, cohort_size=cohort, fault_config=faults, metrics=reg,
                           device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        reps, anchors, secs, spans = cohort_rounds(eng, dev, len(COHORT_BYTES), trace)
        peak = (torch.cuda.max_memory_allocated(dev) - base) if dev.type == "cuda" else None
        runs[dev.type] = dict(eng=eng, reg=reg, reps=reps, anchors=anchors, secs=secs,
                              spans=spans, peak=peak)
        del eng
    card, host = runs[device.type], runs["cpu"]
    eng, reps = card["eng"], card["reps"]
    require([lev.fanout for lev in eng.tree.levels] == [cohort // 20, 5, 4],
            f"tree fanouts {[lev.fanout for lev in eng.tree.levels]}")
    if headline:
        got = [(r.bytes.total_bytes, r.n_participants) for r in reps]
        require(got == list(COHORT_BYTES), f"round bytes/participants {got} != "
                                           f"{list(COHORT_BYTES)}")
        for r in reps:
            by_level = r.bytes.by_level(eng.tree)
            require({k: by_level[k] for k in COHORT_UPPER} == COHORT_UPPER,
                    f"round {r.round}: upper bytes {by_level}")
            require(r.padded_steps == 4_838_650, f"padded steps {r.padded_steps}")
    for rnd, (a, b) in enumerate(zip(card["anchors"], host["anchors"])):
        for lv, (x, y) in enumerate(zip(a, b)):
            require(bits_equal(x, y), f"round {rnd} level {lv}: card anchor != CPU anchor "
                                      f"(max diff {max_abs_err(x, y):.3g})")
    for r, h in zip(reps, host["reps"]):
        require(r.bytes == h.bytes and r.staged_nbytes == h.staged_nbytes
                and np.array_equal(r.cohort_ids, h.cohort_ids), f"round {r.round}: card != CPU report")
        for k in r.metrics:
            close(r.metrics[k], h.metrics[k], COHORT_RTOL, f"round {r.round} {k}")
    reg = card["reg"]
    require(reg.get("cohort/bytes/total").total == sum(r.bytes.total_bytes for r in reps),
            "registry cohort/bytes/total != the reports' bytes")
    require([v for _, v in reg.get("cohort/participants").series]
            == [r.n_participants for r in reps], "registry participants")
    with tempfile.TemporaryDirectory() as tmp:
        path = reg.export_json(os.path.join(tmp, "cohort_metrics.json"))
        with open(path) as f:
            require(json.load(f) == json.loads(json.dumps(reg.to_dict())),
                    "export_json does not round-trip")
    host_s = {"client_spec": [], "buckets": [], "round_plan": []}
    for rnd in range(1, len(reps)):
        ids, t_ids = timed(cpu, lambda: eng.round_cohort(rnd))
        spec, t_spec = timed(cpu, lambda: pop.client_spec(ids))
        host_s["client_spec"].append(t_ids + t_spec)
        host_s["buckets"].append(timed(cpu, lambda: eng.buckets(spec.n_samples))[1])
        host_s["round_plan"].append(timed(cpu, lambda: eng.round_plan(rnd, ids, spec.class_ids))[1])
    ms = {k: 1e3 * statistics.median(v["secs"][1:]) for k, v in runs.items()}
    host_ms = {k: 1e3 * statistics.median(v) for k, v in host_s.items()}
    span_ms = {k: statistics.median(sp.get(k, 0.0) for sp in card["spans"])
               for k in card["spans"][0]} if card["spans"] else {}
    rep = reps[-1]
    peak = "n/a" if card["peak"] is None else f"{card['peak'] / 2**20:.2f} MiB"
    log("cohort", f"(a) Population({pop_size}, dim {COHORT_DIM}), cohort {cohort} on "
                  f"{eng.tree.name} (fanouts {[lev.fanout for lev in eng.tree.levels]}), "
                  f"faults {COHORT_FAULTS}: rounds 0-4 bytes/participants "
                  f"{[(r.bytes.total_bytes, r.n_participants) for r in reps]} == the JAX "
                  f"package's accounting: {headline}; card anchors == CPU anchors bit for bit, "
                  f"target_dist / root_norm within rtol {COHORT_RTOL}")
    log("cohort", f"(a) ms per round, median of rounds 1-4 (synchronized): card {ms[device.type]:.3f} "
                  f"(rounds {[round(1e3 * s, 3) for s in card['secs']]}), CPU {ms['cpu']:.3f} "
                  f"(rounds {[round(1e3 * s, 3) for s in host['secs']]}); host derivations "
                  f"timed apart: " + ", ".join(f"{k} {v:.3f}" for k, v in host_ms.items())
                  + f" = {sum(host_ms.values()):.3f} ms; round spans (host ms, card): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in span_ms.items()))
    log("cohort", f"(a) peak device memory over the 5 rounds {peak} above the "
                  f"allocation before them; staged {rep.staged_nbytes} B a round; padded steps {rep.padded_steps}; "
                  f"round 4 bytes by level {rep.bytes.by_level(eng.tree)}, by class "
                  f"{dict(zip([c.name for c in pop.classes], rep.bytes.leaf_class_nbytes))} "
                  f"(counts {rep.bytes.leaf_class_counts}); target_dist "
                  f"{[round(r.metrics['target_dist'], 6) for r in reps]}, root_norm "
                  f"{[round(r.metrics['root_norm'], 6) for r in reps]}")
    del runs, card, host, eng, reps, reg
    gc.collect()

    # -- (b) memory: O(cohort), never O(population)
    def mem_round(n_pop, size):
        e = CohortEngine(Population(n_clients=n_pop, dim=COHORT_DIM), cohort_size=size,
                         device=device)
        if on_card:
            torch.cuda.synchronize(device)
            before = torch.cuda.memory_allocated(device)
        state, r = e.round(e.init_state(), 0)
        retained = None
        if on_card:
            torch.cuda.synchronize(device)
            retained = torch.cuda.memory_allocated(device) - before
        del state
        return r.staged_nbytes, retained

    small = 2_000 if headline else cohort // 10
    sa, ra = mem_round(pop_size // 10, small)
    sb, rb = mem_round(pop_size, small)
    sc, rc = mem_round(pop_size, 4 * small)
    require(sa == sb and ra == rb, f"population changed the footprint: staged {sa} / {sb}, "
                                   f"retained {ra} / {rb}")
    require(sc > 3 * sa and rc == ra, f"cohort x4: staged {sa} -> {sc}, retained {ra} -> {rc}")
    if headline:
        require((sa, sc) == (STAGED_BYTES[2_000], STAGED_BYTES[8_000]),
                f"staged bytes {sa}, {sc} != {STAGED_BYTES}")
    log("cohort", f"(b) cohort {small}: staged {sa} B at populations {pop_size // 10} and "
                  f"{pop_size} (equal), retained device bytes {ra} / {rb} (equal); cohort "
                  f"{4 * small}: staged {sc} B ({sc / sa:.2f}x), retained {rc} (equal)")

    # -- (c) the analytic bytes against the encoded oracle, on the card
    ledger = CommLedger()
    opop = Population(n_clients=50_000, dim=COHORT_DIM)
    oeng = CohortEngine(opop, cohort_size=80, fault_config=faults, ledger=ledger, device=device)
    state = oeng.init_state()
    for rnd, (total, uplink) in enumerate(ORACLE_BYTES):
        state, r = oeng.round(state, rnd)
        oracle, osec = timed(device, lambda: materialized_round_bytes(
            rnd, r.class_ids, opop.classes, oeng.upper_compressors, oeng.tree, COHORT_DIM,
            r.plan.survivor_masks(), device=device))
        by_level = r.bytes.by_level(oeng.tree)
        tags = {}
        for rec in ledger.records:
            if rec.round == rnd:
                tags[rec.tag] = tags.get(rec.tag, 0) + rec.nbytes
        require(r.bytes.total_bytes == oracle == total
                and by_level == {"uplink": uplink, **COHORT_UPPER} and tags == by_level,
                f"oracle round {rnd}: analytic {r.bytes.total_bytes}, encoded {oracle}, "
                f"want {total}; by level {by_level}; ledger {tags}")
        log("cohort", f"(c) cohort 80, round {rnd}: analytic {r.bytes.total_bytes} B == "
                      f"encoded oracle {oracle} B ({osec:.3f} s on {device.type}); by level "
                      f"{by_level} == ledger tags")
    del state, oeng
    require(not any(kernels.launch_counts().values()),
            f"the engine launched kernels: {kernels.launch_counts()}")

    # -- (d) lossy-link transmit of qsgd_kernel payloads (B2 encode, B3 decode)
    cfg = FaultConfig(**XMIT_FAULTS)
    n = XMIT_CHILDREN
    tree = TreeTopology("cohort_xmit", (TreeLevel("uplink", n, Link(gbps=0.00625,
                                                                    latency_us=50_000.0)),))
    fm = FaultModel(cfg, tree)
    comp = qsgd_kernel(8)
    w = torch.randn(w_in, generator=make_generator(17, device), device=device).mul_(0.02)
    ledger = CommLedger()
    # B2 and B3 held to their plain versions on this path's own inputs: child
    # 0's encode and the first delivered payload's decode
    b3 = KernelProbe(bitpack, "unpack_dequant_2d", ref.unpack_dequant_ref)
    b2 = KernelProbe(b3, "quant_pack_2d", ref.quant_pack_ref)
    ops._bp = b2
    try:
        sent, outcomes = transmit_children(n, w, comp, cfg, fm, ledger, device)
    finally:
        ops._bp = bitpack
    rows = tile_rows(w.numel())
    for name, pr in (("B2", b2), ("B3", b3)):
        require(pr.checked is not None and pr.checked[0] == (rows, quant8.QBLOCK),
                f"{name}'s first call in the transmit was not a ({rows}, {quant8.QBLOCK}) "
                f"payload: {pr.checked}")
        require(pr.checked[1], f"{name} on a transmitted payload != plain: {pr.checked}")
    nbytes = ledger.records[0].nbytes
    require(ledger.retry_bytes == (sent - n) * nbytes
            and ledger.bytes_by_tag().get("uplink") == n * nbytes,
            f"retry bytes {ledger.retry_bytes} != ({sent} - {n}) x {nbytes}")
    log("cohort", f"(d) {n} children send a qsgd_kernel w_in {tuple(w_in)} ({nbytes} B) over "
                  f"uplink with {XMIT_FAULTS}: {sent} attempts, {outcomes}; every decision == "
                  f"FaultModel.attempt_outcomes at lane attempt * {n} + child; ledger "
                  f"uplink {n * nbytes} B + retry {ledger.retry_bytes} B; delivered payloads "
                  f"decode (B3) bit for bit to the sealed originals; child 0's B2 encode "
                  f"{b2.checked[0]} == plain bit for bit (max_abs_err {b2.checked[2]}), the "
                  f"first delivered B3 decode {b3.checked[0]} == plain bit for bit "
                  f"(max_abs_err {b3.checked[2]})")
    del w, ledger, b2, b3

    # one full-model payload on a (round, child) lane whose first attempt is
    # corrupted and second delivered
    lane = None
    for rnd in range(1_000):
        for c in range(n):
            first = fm.attempt_outcomes(rnd, 0, 0, lanes=np.array([c]))
            second = fm.attempt_outcomes(rnd, 0, 0, lanes=np.array([n + c]))
            if first[1][0] and not (second[0][0] or second[1][0]):
                lane = (rnd, c)
                break
        if lane is not None:
            break
    require(lane is not None, "no lane with a corrupted then a clean attempt")
    x = torch.randn((d,), generator=make_generator(19, device), device=device).mul_(0.02)
    p, enc_s = timed(device, lambda: codecs.encode(comp, x, generator=make_generator(23, device)))
    del x
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    require(p.nbytes == payload_bytes, f"full-model payload {p.nbytes} B != {payload_bytes}")
    sec = {"seal": timed(cpu, lambda: codecs.seal_payload(p))[1],
           "verify": timed(cpu, lambda: codecs.verify_payload(p))[1]}

    def corrupted_copy():
        wire = copy.deepcopy(p)
        corrupt_payload(wire, rnd=lane[0], lane=lane[1], seed=cfg.seed)
        try:
            codecs.verify_payload(wire)
        except codecs.PayloadError as e:
            return e.plane
        return None
    plane, sec["corrupted copy + verify"] = timed(cpu, corrupted_copy)
    require(plane == "q", f"corrupted plane {plane!r}, expected 'q'")
    res, sec["transmit"] = timed(cpu, lambda: transmit(
        p, cfg, rnd=lane[0], level_name="uplink", n_children=n, child=lane[1]))
    require(res.delivered and res.attempts == 2 and res.n_corrupt == 1
            and "checksum mismatch" in res.error, f"full-model transmit: {res}")
    del p, res
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    counts = kernels.launch_counts()
    log("cohort", f"(d) full-model qsgd_kernel payload {payload_bytes} B (d={d}, encoded in "
                  f"{enc_s:.3f} s) on round {lane[0]} child {lane[1]}: attempt 0 corrupted "
                  f"(plane 'q' caught), attempt 1 delivered; seconds " + ", ".join(
                      f"{k} {v:.3f}" for k, v in sec.items()))
    log("cohort", f"phase {time.perf_counter() - t_phase:.2f} s; kernels "
                  f"{json.dumps({k: v for k, v in counts.items() if v})}")
    return counts


# ---------------------------------------------------------------------------
def finite_batcher_class():
    import torch
    from repro_torch.training.serving import ContinuousBatcher

    class FiniteBatcher(ContinuousBatcher):
        """Requires finite logits of each prefill and decode step."""

        def _finite(self, key, out):
            require(bool(torch.isfinite(out[0].float()).all()), f"{key}: non-finite logits")
            return out

        def _model_prefill(self, batch):
            return self._finite("prefill", super()._model_prefill(batch))

        def _model_decode(self, tok):
            return self._finite("decode", super()._model_decode(tok))

    return FiniteBatcher


def free_cached(device):
    """Free what is unreferenced, on the card too."""
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def decode_run(cfg, params, batch, n):
    """Prefill ``batch``, then ``n`` greedy decode steps -> (logits of each
    step (prefill first), greedy tokens (B, n + 1), the cache)."""
    import torch
    from repro_torch.models import decode_step, prefill
    logits, cache = prefill(params, cfg, batch, cache_len=batch["tokens"].shape[1] + n + 1)
    outs = [logits]
    tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    toks = [tok]
    for _ in range(n):
        logits, cache = decode_step(params, cfg, tok, cache)
        outs.append(logits)
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
        toks.append(tok)
    return outs, torch.cat(toks, 1), cache


def check_moe_layer(cfg, moe_params, h):
    """One MoE layer's real inputs ``h`` (B, S, d): moe_ffn(no_drop=True)
    against the per-token sum of its chosen experts (and the shared one)
    computed in f32, and route's drops at the config's capacity_factor
    against the assignments past C in each expert, in token order, of an
    f32 top-k of the router probabilities.  Returns (relative error, T, C,
    dropped)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import moe as moe_lib

    m = cfg.moe
    E, K = m.num_experts, m.top_k
    require(cfg.mlp_act == "silu", f"{cfg.name}: the f32 reference has silu experts")
    kw = dict(num_experts=E, top_k=K, capacity_factor=m.capacity_factor, act=cfg.mlp_act,
              gated=cfg.mlp_gated, shared_expert=m.shared_expert)
    y, _ = moe_lib.moe_ffn(moe_params, h, **kw, no_drop=True)
    xt = h.reshape(-1, h.shape[-1])
    T = xt.shape[0]
    probs = torch.softmax(xt.float() @ moe_params["router"], -1)
    gw, gi = torch.topk(probs, K, dim=-1)
    gw = gw / gw.sum(-1, keepdim=True)
    x32 = xt.float()

    def ffn(x, w_in, w_gate, w_out):
        h = x @ w_in.float()
        h = F.silu(x @ w_gate.float()) * h if cfg.mlp_gated else F.silu(h)
        return h @ w_out.float()

    dense = torch.zeros_like(x32)
    for e in range(E):
        rows, ks = torch.nonzero(gi == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        w = moe_params
        dense.index_add_(0, rows, gw[rows, ks, None] * ffn(
            x32[rows], w["w_in"][e], w["w_gate"][e] if cfg.mlp_gated else None, w["w_out"][e]))
    if m.shared_expert:
        w = moe_params["shared"]
        dense += ffn(x32, w["w_in"], w.get("w_gate"), w["w_out"])
    err = float((y.reshape(T, -1).float() - dense).abs().max() / dense.abs().max())
    require(err <= MOE_DENSE_RTOL, f"{cfg.name}: moe_ffn(no_drop) vs the f32 expert sum "
                                   f"{err:.3g} > {MOE_DENSE_RTOL} of the max")
    # assignment t*K + k; each expert keeps its first C in that order
    C = max(1, int(T * K * m.capacity_factor / E))
    flat = gi.reshape(-1)
    drop = torch.zeros(T * K, dtype=torch.bool, device=flat.device)
    for e in range(E):
        drop[torch.nonzero(flat == e).flatten()[C:]] = True
    r = moe_lib.route(moe_params["router"], xt, E, K, m.capacity_factor)
    require(r.capacity == C and torch.equal(~r.keep, drop),
            f"{cfg.name}: route's drops (C = {r.capacity}, {int((~r.keep).sum())}) != the "
            f"assignments past C = {C} in each expert ({int(drop.sum())})")
    return err, T, C, int(drop.sum())


def arch_moe(device, arch, n_layers):
    """Full width, depth cut to ``n_layers``: prefill MOE_PROMPT tokens (2
    prompts) and MOE_DECODE greedy steps; the first MoE layer's input is
    recorded during the prefill and checked by check_moe_layer."""
    import numpy as np
    import torch
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import side_inputs
    from repro_torch.models import init_params, moe as moe_lib, period_info
    from repro_torch.utils.tree import tree_leaves, tree_map

    full = get_config(arch)
    cfg = replace(full, num_layers=n_layers)
    free_cached(device)
    mem = MemMarks(device)
    mem.mark("before")
    t0 = time.perf_counter()
    params = init_params(0, cfg, device=device)
    n_params = sum(int(a.numel()) for a in tree_leaves(params))
    init_s = time.perf_counter() - t0
    mem.mark("init")                  # the f32 draw of one stacked expert leaf on top
    rng = np.random.default_rng(9)
    batch = {"tokens": torch.as_tensor(rng.integers(1, cfg.vocab_size, (2, MOE_PROMPT)),
                                       device=device),
             **side_inputs(cfg, 2, 0, device)}
    seen = {}
    apply = moe_lib.moe_apply

    def recording(p, x, **kw):
        seen.setdefault("h", x.detach().clone())
        return apply(p, x, **kw)

    moe_lib.moe_apply = recording
    try:
        outs, toks, _ = decode_run(cfg, params, batch, MOE_DECODE)
    finally:
        moe_lib.moe_apply = apply
    mem.mark("prefill + decode")
    require(all(bool(torch.isfinite(o.float()).all()) for o in outs), f"{arch}: non-finite")
    require(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size, f"{arch}: token range")
    j = period_info(cfg)[3].index(True)             # the first MoE layer
    moe_params = tree_map(lambda a: a[0], params["blocks"][f"pos{j}"]["moe"])
    err, T, C, dropped = check_moe_layer(cfg, moe_params, seen["h"])
    log("arch", f"{arch}: {n_layers} of {full.num_layers} layers at full width "
                f"({n_params} params, {cfg.dtype}, init {init_s:.2f} s); prefill 2 x "
                f"{MOE_PROMPT} tokens{' (256 vision)' if cfg.vision_tokens else ''} and "
                f"{MOE_DECODE} decode steps; {mem.summary()}")
    log("arch", f"{arch}: layer {j}'s MoE on its prefill inputs (T={T}, top-"
                f"{cfg.moe.top_k} of {cfg.moe.num_experts}"
                f"{' + shared' if cfg.moe.shared_expert else ''}): moe_ffn(no_drop) vs the "
                f"f32 expert sum {err:.3g} of the max (<= {MOE_DENSE_RTOL}); capacity "
                f"{cfg.moe.capacity_factor}: C={C}, {dropped} of {T * cfg.moe.top_k} "
                f"assignments dropped, the same set as each expert's assignments past C in "
                f"token order of an f32 top-k")
    del params, outs, seen, moe_params
    free_cached(device)


def arch_seamless(device):
    """seamless-m4t-large-v2 whole: the continuous batcher (2 slots, 4
    requests, the batcher's zero frame embeddings) and launch.serve's
    generate with seeded frame embeddings (2, 16, 1024)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, side_inputs
    from repro_torch.models import init_params
    from repro_torch.training.serving import Request
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config(SEAMLESS_ARCH)
    free_cached(device)
    marks = MemMarks(device)
    params = init_params(0, cfg, device=device)
    n_params = sum(int(a.numel()) for a in tree_leaves(params))
    b = finite_batcher_class()(cfg, params, n_slots=N_SLOTS,
                               max_len=SEAMLESS_PROMPT + 2 * MAX_NEW + 2)
    rng = np.random.default_rng(6)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, SEAMLESS_PROMPT),
                    max_new=MAX_NEW) for i in range(4)]
    for r in reqs:
        b.submit(r)
    stats = b.run(max_ticks=200)
    require(stats.completed == 4 and all(len(r.generated) == MAX_NEW and
                                         all(0 <= t < cfg.vocab_size for t in r.generated)
                                         for r in reqs), "seamless: batcher tokens")
    mem = b.cache.get("enc_memory")
    require(mem is not None and tuple(mem.shape) == (N_SLOTS, 8, cfg.enc_d_model),
            f"seamless: the cache's enc_memory {None if mem is None else tuple(mem.shape)}")
    side = side_inputs(cfg, 2, 0, device, src_len=SEAMLESS_SRC)
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size, (2, SEAMLESS_PROMPT)),
                             device=device)
    t0 = time.perf_counter()
    out = generate(cfg, params, prompt, MAX_NEW, **side)
    gen_s = time.perf_counter() - t0
    require(out.shape == (2, MAX_NEW) and 0 <= out.min() and out.max() < cfg.vocab_size,
            "seamless: generate tokens")
    marks.mark("batcher + generate")
    log("arch", f"{SEAMLESS_ARCH}: {cfg.enc_layers} encoder + {cfg.num_layers} decoder "
                f"layers at full size ({n_params} params, {cfg.dtype}); ContinuousBatcher "
                f"{len(reqs)} requests over {N_SLOTS} slots ({stats.prefills} prefills, "
                f"{stats.decode_steps} decode steps, logits finite); cache "
                f"enc_memory {tuple(mem.shape)}; generate(src_embeds "
                f"{tuple(side['src_embeds'].shape)}) {MAX_NEW} tokens in {gen_s:.2f} s; "
                f"{marks.summary()}")
    del params, b
    free_cached(device)


def arch_reduced(device):
    """The reduced f32 configs (and jamba's 8-layer period at reduced
    widths) on the card and on the CPU from the same weights and inputs:
    prefill + 4 greedy decode steps, logits within ARCH_RTOL of their max,
    tokens equal.  Returns {config: largest relative difference}."""
    import numpy as np
    import torch
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.utils.tree import tree_map

    cpu, errs = torch.device("cpu"), {}
    for name in ARCH_REDUCED:
        if name == "jamba period":
            cfg = replace(get_config("jamba-1.5-large-398b").reduced(), num_layers=8,
                          layer_pattern=JAMBA_PERIOD)
        else:
            cfg = get_config(name).reduced()
        p_cpu = init_params(4, cfg, device="cpu")
        p_dev = tree_map(lambda a: a.to(device), p_cpu)
        rng = np.random.default_rng(4)
        batch = {"tokens": torch.as_tensor(rng.integers(1, cfg.vocab_size, (2, 20)))}
        if cfg.vision_tokens:
            batch["vision_embeds"] = torch.as_tensor(
                0.02 * rng.normal(size=(2, cfg.vision_tokens, cfg.d_model)), dtype=torch.float32)
        if cfg.enc_layers:
            batch["src_embeds"] = torch.as_tensor(
                0.02 * rng.normal(size=(2, 12, cfg.enc_d_model)), dtype=torch.float32)
        runs = [decode_run(cfg, p, {k: v.to(dev) for k, v in batch.items()}, 4)
                for p, dev in ((p_dev, device), (p_cpu, cpu))]
        (card, ctoks, _), (host, htoks, _) = runs
        err = max(float((a.cpu() - b).abs().max() / b.abs().max()) for a, b in zip(card, host))
        require(err <= ARCH_RTOL, f"reduced {name}: logits card vs CPU {err:.3g} > {ARCH_RTOL}")
        require(torch.equal(ctoks.cpu(), htoks), f"reduced {name}: greedy tokens card != CPU")
        errs[name] = err
    log("arch", "reduced f32 card vs CPU, prefill + 4 decode steps, max |diff| / max |logit|: "
                + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                + f" (<= {ARCH_RTOL}); greedy tokens equal")
    return errs


def phase_arch(device):
    """The other architectures.  (a) mamba2-2.7b at full width served to two
    personalized users (serve_users: B1-B3), (b) seamless whole, (c) llama4
    and dbrx at full width with their depth cut, (d) the reduced configs on
    the card against the CPU.  Returns the launch counts of (a)."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    counts = serve_users(get_config(MAMBA_ARCH), device, "arch", MAMBA_PROMPT,
                         MAMBA_PROMPT + 2 * MAX_NEW + 2)[0]
    arch_seamless(device)
    for arch, n_layers in MOE_CUTS:
        arch_moe(device, arch, n_layers)
    arch_reduced(device)
    log("arch", f"phase {time.perf_counter() - t0:.2f} s")
    return counts


# ---------------------------------------------------------------------------
def archtrain_config(arch, layers):
    """``arch`` at full width, its depth cut to ``layers`` (None: whole); a
    cut below one period of the layer pattern keeps the period's first
    layers."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is None:
        return cfg
    if cfg.layer_pattern and layers < len(cfg.layer_pattern):
        return replace(cfg, num_layers=layers, layer_pattern=cfg.layer_pattern[:layers])
    return replace(cfg, num_layers=layers)


def with_frames(cfg, batches, device):
    """Each batch with the encoder's source frames, as launch.serve's
    side_inputs makes them: 0.02 * N(0, 1), (B, ARCHTRAIN_SRC, De), from a
    generator seeded with the batch's index."""
    from repro_torch.launch.serve import side_inputs
    for i, batch in enumerate(batches):
        frames = side_inputs(cfg, batch["tokens"].shape[0], i, device, src_len=ARCHTRAIN_SRC)
        yield {**batch, "src_embeds": frames["src_embeds"]}


def sync_meta(sync):
    """A SyncConfig as the trace's meta header records it (obs.report's
    ``sync_from_meta`` rebuilds it)."""
    meta = {k: getattr(sync, k) for k in ("mode", "compressor", "compress_ratio",
                                          "quant_bits", "sync_period", "topology")}
    if sync.levels:
        meta["levels"] = [{"name": lc.name, "period": lc.period, "compressor": lc.compressor,
                           "compress_ratio": lc.compress_ratio, "quant_bits": lc.quant_bits}
                          for lc in sync.levels]
    return meta


def run_report(phase, argv):
    """``obs.report.main(argv)`` with its table on the log -> (exit status,
    the result dict it wrote with ``--json``)."""
    import contextlib
    import io
    from repro_torch.obs import report
    out_json = argv[0] + ".report.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = report.main(list(argv) + ["--json", out_json])
    for line in buf.getvalue().splitlines():
        log(phase, f"  | {line}")
    with open(out_json) as f:
        return rc, json.load(f)


def traced_round(out_dir, n_params, compressor, device, sync_period=AUDIT_PERIOD):
    """One full root period of a two-level hier schedule (dense ``intra``
    every round, ``compressor`` ``inter`` every ``sync_period``) run with
    the port's codecs under tracing, as the JAX package's
    benchmarks/bench_comm.py traced_round does: each level inside
    ``ambient(level=...)``, pack / encode / wire / decode / adopt spans, and
    every encode of the probe payload that ``round_ledger`` sizes its
    records from (normal draws and the compressor's from one generator
    seeded 0 on ``device``), so the encode spans' bytes by level equal the
    ledger's.  Writes the trace JSONL (exported before the accounting calls,
    whose own probe encodes would add untagged spans) and a metrics JSON
    carrying ``round_ledger(...).bytes_by_tag()``; returns their paths."""
    import torch
    from repro_torch.comm import codecs, round_cost, round_ledger
    from repro_torch.comm.accounting import PROBE_CAP, _hier_levels
    from repro_torch.configs.base import SyncConfig
    from repro_torch.core.distributed import make_sync_compressor
    from repro_torch.obs import registry, trace
    from repro_torch.utils.device import make_generator

    sync = SyncConfig(mode="hier", compressor=compressor, quant_bits=8, sync_period=sync_period)
    require(n_params <= PROBE_CAP, "the exact ledger match needs n_params <= the probe")
    levels = _hier_levels(sync)
    n_rounds = max(1, levels[-1].period)
    was = trace.enabled()
    trace.enable()
    trace.get_tracer().reset()
    registry.reset()
    comps = {lc.name: make_sync_compressor(lc.compressor, lc.compress_ratio, lc.quant_bits)
             for lc in levels}
    for t in range(n_rounds):
        with trace.span("round/step", round=t):
            for lc in levels:
                period = max(1, lc.period)
                if t % period != period - 1:
                    continue                 # this level does not sync at round t
                gen = make_generator(0, device)
                x = torch.randn(n_params, generator=gen, device=device)
                with trace.ambient(level=lc.name):
                    with trace.span("sync/pack", level=lc.name):
                        host = x.cpu()        # host staging of the payload
                    p = codecs.encode(comps[lc.name], x, generator=gen)   # codec/encode
                    with trace.span("comm/allreduce", level=lc.name, nbytes=p.nbytes):
                        wire = {k: v.copy() for k, v in p.planes.items()}   # the wire hop
                    y = codecs.decode(p, device)                         # codec/decode
                    with trace.span("sync/adopt", level=lc.name):
                        host = host + y.cpu()                            # model adoption
    del wire, host
    trace.set_meta(label="chip_smoke traced hier round", n_params=n_params,
                   n_rounds=n_rounds, sync=sync_meta(sync))
    trace_path = trace.export_jsonl(os.path.join(out_dir, "TRACE_round.jsonl"))
    trace.disable()
    trace.get_tracer().reset()
    if was:
        trace.enable()
    led = round_ledger(sync, n_params, n_rounds=n_rounds, device=device)
    registry.observe_round_cost(0, round_cost(sync, n_params, device=device))
    registry.ingest_ledger(led)
    metrics_path = registry.export_json(
        os.path.join(out_dir, "METRICS_round.json"),
        extra={"ledger_bytes_by_tag": {k: float(v) for k, v in led.bytes_by_tag().items()},
               "n_params": n_params, "n_rounds": n_rounds})
    registry.reset()
    return trace_path, metrics_path


def export_trace(phase, label, run, out_dir, tc):
    """(f) The run's trace through both exporters: every Chrome event an
    "X" event on a span's thread, and load_jsonl giving back the spans.
    Returns the JSONL's path."""
    from repro_torch.obs import trace
    tracer = trace.get_tracer()
    trace.set_meta(label=f"chip_smoke archtrain {label}", n_params=run["d"],
                   n_rounds=tc.total_steps, sync=sync_meta(tc.sync))
    spans = tracer.spans()
    path = trace.export_jsonl(os.path.join(out_dir, "TRACE_train.jsonl"))
    chrome = trace.export_chrome_trace(os.path.join(out_dir, "TRACE_train.json"))
    with open(chrome) as f:
        events = json.load(f)["traceEvents"]
    tids = {sp.tid for sp in spans}
    require(len(events) == len(spans) == tracer.n_recorded and all(
        ev["ph"] == "X" and ev["tid"] in tids and ev["name"] == sp.name
        for ev, sp in zip(events, spans)),
        f"{label}: Chrome trace: {len(events)} events for {len(spans)} spans")
    meta, back = trace.load_jsonl(path)
    require([s.to_json() for s in back] == [s.to_json() for s in spans]
            and meta["n_evicted"] == 0 and meta["sync"]["mode"] == tc.sync.mode,
            f"{label}: load_jsonl did not give back the exported spans")
    names = sorted({sp.name for sp in spans})
    log(phase, f"{label}: trace exported, {len(spans)} spans ({os.path.getsize(path)} B JSONL, "
               f"{os.path.getsize(chrome)} B Chrome JSON, all X events with their tid), "
               f"load_jsonl == the spans; names {names}")
    return path


def audit_round(phase, device, out_dir):
    """(g) The byte audit: traced_round at PROBE_CAP coordinates under
    qsgd_kernel (encode B2, decode B3; the inter payload's encode and
    decode held bit for bit to their plain versions on the same inputs),
    read by obs.report with the ledger: bytes_match True and exit 0; with
    one level's ledger bytes raised by 1, exit 1.  Returns the launch
    counts (the round's and the report's)."""
    from repro_torch import kernels
    from repro_torch.comm.accounting import PROBE_CAP
    from repro_torch.kernels import bitpack, ops, ref
    from repro_torch.kernels.bitpack import QBLOCK
    b3 = KernelProbe(bitpack, "unpack_dequant_2d", ref.unpack_dequant_ref)
    b2 = KernelProbe(b3, "quant_pack_2d", ref.quant_pack_ref)
    kernels.reset_launch_counts()
    ops._bp = b2
    try:
        trace_path, metrics_path = traced_round(out_dir, PROBE_CAP, "qsgd_kernel", device)
    finally:
        ops._bp = bitpack
    counts = kernels.launch_counts()
    on_card = device.type == "cuda"
    require(not on_card or counts["quant_pack_2d"] > 0 and counts["unpack_dequant_2d"] > 0,
            f"the audited round launched B2 {counts['quant_pack_2d']}, B3 "
            f"{counts['unpack_dequant_2d']} times")
    shape = (PROBE_CAP // QBLOCK, QBLOCK)
    for name, probe in (("B2", b2), ("B3", b3)):
        require(probe.checked is not None and probe.checked[0] == shape and probe.checked[1],
                f"(g) the inter payload's {name} != its plain version: {probe.checked}")
    log(phase, f"(g) traced hier round ({PROBE_CAP} coordinates, qsgd_kernel inter every "
               f"{AUDIT_PERIOD}, one root period): B2 {counts['quant_pack_2d']} launches (the "
               f"inter encode, then the ledger's and the round cost's probes), B3 "
               f"{counts['unpack_dequant_2d']} (the inter decode); the inter encode's B2 and "
               f"decode's B3 at {shape} == their plain versions bit for bit, max_abs_err "
               f"{b2.checked[2]} / {b3.checked[2]}; the report:")
    argv = [trace_path, "--metrics", metrics_path] + ([] if on_card else ["--device", str(device)])
    rc, res = run_report(phase, argv)
    require(rc == 0 and res["bytes_match"] is True and res["trace_bytes"] == res["ledger_bytes"],
            f"(g) report exit {rc}, bytes_match {res['bytes_match']}: trace "
            f"{res['trace_bytes']} ledger {res['ledger_bytes']}")
    log(phase, f"(g) bytes by level {res['trace_bytes']} == the ledger's, exit 0; with the "
               f"inter ledger bytes raised by 1:")
    with open(metrics_path) as f:
        doc = json.load(f)
    doc["ledger_bytes_by_tag"]["inter"] += 1                  # corrupt one level
    with open(metrics_path, "w") as f:
        json.dump(doc, f)
    bad, res = run_report(phase, argv)
    require(bad == 1 and res["bytes_match"] is False,
            f"(g) the report exited {bad} on a corrupted ledger, expected 1")
    log(phase, f"(g) exit {bad} on the corrupted ledger")
    counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    return counts


def archtrain_reduced(device):
    """(e) The reduced f32 MoE configs, 3 dense steps on the card and on the
    CPU from the same params and batches: losses within ARCHTRAIN_RTOL and
    every router call's top-(K+1) probabilities apart by > ROUTER_MARGIN
    (no top-k choice can flip between the two).  Returns {config: largest
    relative loss difference}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SyncConfig, TrainConfig
    from repro_torch.data.synthetic import SyntheticLMDataset, lm_batch_iterator
    from repro_torch.models import init_params, moe as moe_lib
    from repro_torch.training.steps import init_train_state, make_train_step
    from repro_torch.utils.tree import tree_map

    cpu, errs, margins = torch.device("cpu"), {}, []
    route = moe_lib.route

    def recording(router, xt, num_experts, top_k, *a, **kw):
        r = route(router, xt, num_experts, top_k, *a, **kw)
        p = r.probs.detach().double().sort(dim=-1, descending=True).values[:, :top_k + 1]
        margins.append(float((p[:, :-1] - p[:, 1:]).min()))
        return r

    moe_lib.route = recording
    try:
        for name in ARCHTRAIN_REDUCED:
            cfg = get_config(name).reduced()
            tc = TrainConfig(model=cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, lr=3e-3,
                             warmup_steps=10, total_steps=3, sync=SyncConfig(mode="dense"))
            it = lm_batch_iterator(SyntheticLMDataset(cfg.vocab_size, 20_000, seed=0),
                                   TRAIN_BATCH, TRAIN_SEQ, seed=1)
            batches = []
            for _ in range(3):
                tokens = torch.as_tensor(next(it)["tokens"]).long()
                batches.append({"tokens": tokens[:, :-1], "targets": tokens[:, 1:]})
            p_cpu = init_params(6, cfg, device="cpu")   # margins of 2.9e-5 and more on the CPU
            losses = []
            for dev in (device, cpu):
                params = tree_map(lambda a: a.to(dev, copy=True), p_cpu)
                state = init_train_state(torch.Generator(dev).manual_seed(0), params, tc, 1, 1)
                step = make_train_step(cfg, tc, 1, 1)
                run = []
                for b in batches:
                    state, m = step(state, {k: v.to(dev) for k, v in b.items()})
                    run.append(float(m["loss"]))
                losses.append(run)
                del state, params
            errs[name] = close(losses[0], losses[1], ARCHTRAIN_RTOL,
                               f"reduced {name}: card vs CPU losses")
    finally:
        moe_lib.route = route
    require(margins and min(margins) > ROUTER_MARGIN,
            f"reduced MoE training: a router's top-(K+1) margin {min(margins or [0])} <= "
            f"{ROUTER_MARGIN}")
    log("archtrain", "(e) reduced f32, 3 dense steps, card vs CPU from the same params and "
                     "batches, max relative loss difference: "
                     + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                     + f" (<= {ARCHTRAIN_RTOL}); {len(margins)} router calls, smallest "
                       f"top-(K+1) margin {min(margins):.3g} (> {ROUTER_MARGIN})")
    return errs


def phase_archtrain(device):
    """Training of the new architectures at full width, traced
    (ARCHTRAIN_RUNS: (a) mamba2-2.7b whole, dense; (b) mamba2-2.7b cut,
    efbv + qsgd_kernel, its trace exported and read back by obs.report
    (f); (c) seamless whole with source frames; (d) llama4 cut to one MoE
    layer); then (e) the reduced MoE configs card vs CPU and (g) the byte
    audit of a traced hier round.  Returns the
    launch counts of the path."""
    from repro_torch import kernels
    from repro_torch.configs.base import SyncConfig, TrainConfig
    from repro_torch.data.synthetic import SyntheticLMDataset, lm_batch_iterator

    t_phase = time.perf_counter()
    path = {name: 0 for name in kernels.KERNELS}
    out_dir = tempfile.mkdtemp()
    try:
        for label, arch, layers, sync_kw, steps, n_groups in ARCHTRAIN_RUNS:
            cfg = archtrain_config(arch, layers)
            tc = TrainConfig(model=cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, lr=3e-3,
                             warmup_steps=10, total_steps=steps, sync=SyncConfig(**sync_kw))
            batches = lm_batch_iterator(SyntheticLMDataset(cfg.vocab_size, 100_000, seed=0),
                                        TRAIN_BATCH, TRAIN_SEQ, seed=1)
            if cfg.enc_layers:
                batches = with_frames(cfg, batches, device)
            exported = sync_kw["mode"] != "dense"
            run = train_run("archtrain", label, cfg, tc, device, n_groups, 1, batches)
            trace_path = export_trace("archtrain", label, run, out_dir, tc) if exported else None
            del run["state"]
            free_cached(device)
            for k, v in run["counts"].items():
                path[k] += v
            aux = ""
            if cfg.moe:
                aux = (f"; aux term (loss - ce, weight {cfg.moe.aux_loss_weight}) "
                       f"{[float(f'{a - c:.4g}') for a, c in zip(run['losses'], run['ces'])]}")
            whole = archtrain_config(arch, None).num_layers
            frames = f", source frames {ARCHTRAIN_SRC}" if cfg.enc_layers else ""
            log("archtrain", f"{label}: {cfg.num_layers} of {whole} layers at full width "
                             f"({run['d']} params, {cfg.dtype}{frames}): {run_summary(run)}{aux}")
            if not exported:
                continue
            log("archtrain", f"(f) {label}: obs.report on the exported trace:")
            argv = [trace_path] + ([] if device.type == "cuda" else ["--device", str(device)])
            kernels.reset_launch_counts()
            rc, res = run_report("archtrain", argv)
            for k, v in kernels.launch_counts().items():
                path[k] += v
            kernels.reset_launch_counts()
            require(rc == 0 and res["bytes_match"] is None,
                    f"(f) report exit {rc}, bytes_match {res['bytes_match']}")
            del run
        errs = archtrain_reduced(device)
        for k, v in audit_round("archtrain", device, out_dir).items():
            path[k] += v
    finally:
        shutil.rmtree(out_dir)
    free_cached(device)
    log("archtrain", f"phase {time.perf_counter() - t_phase:.2f} s; kernels "
                     f"{json.dumps({k: v for k, v in path.items() if v})}; reduced "
                     f"{json.dumps(errs)}")
    return path


# ---------------------------------------------------------------------------
def peak_reset(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device):
    import torch
    return torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else 0.0


def whole_matrix_attention(q, k, v, kind, window, chunk):
    """The check's own attention: one f32 softmax over the whole (S, S)
    score matrix, q (B,S,H,hd), k/v (B,S,KV,hd) f32 -> (B,S,H,hd)."""
    import math
    import torch
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qf = (q * (1.0 / math.sqrt(hd))).reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bnkh->bqkgn", qf, k)
    i = torch.arange(S, device=q.device)
    ok = i[:, None] >= i[None, :]
    if kind == "attn_swa":
        ok &= (i[:, None] - i[None, :]) < window
    elif kind == "attn_chunk":
        ok &= (i[:, None] // chunk) == (i[None, :] // chunk)
    s = s.masked_fill(~ok[None, :, None, None, :], -1e30)
    out = torch.einsum("bqkgn,bnkh->bqkgh", torch.softmax(s, dim=-1), v)
    return out.reshape(B, S, H, hd)


def phase_longctx(device, prompt=LONG_PROMPT, frames=LONG_FRAMES, train_seq=LONG_TRAIN_SEQ,
                  check_seq=LONG_CHECK_SEQ):
    """Part A on the card: the tiled attention at lengths the whole score
    matrix cannot hold.  (a) h2o-danube-1.8b whole, one prompt of ``prompt``
    tokens (prefill_32k's length) then LONG_DECODE greedy decode steps, with
    BANDED off and on (the last-position logits' max abs difference); (b)
    seamless-m4t-large-v2's encoder on ``frames`` source frames plus a
    decoder prefill of LONG_DEC_PROMPT tokens cross-attending to it; (c) one
    dense danube train step (forward_train and the tiled backward) at
    ``train_seq``; (d) one danube layer's prefill attention at ``check_seq``
    against a whole-matrix f32 softmax, within LONG_ATOL.  Each run prints
    ms and its peak.  No kernel of the repo runs here."""
    import math
    import torch
    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SyncConfig, TrainConfig
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import embed, rmsnorm
    from repro_torch.models.transformer import _attn_cfg, _period
    from repro_torch.training import steps

    t_phase = time.perf_counter()
    cfg = get_config(ARCH)
    gen = torch.Generator(device=device).manual_seed(0)
    params = tm.init_params(0, cfg, device)
    toks = torch.randint(1, cfg.vocab_size, (1, prompt), generator=gen, device=device)
    last, greedy = {}, {}
    for banded in (False, True):
        attn.BANDED = banded
        free_cached(device)
        peak_reset(device)
        try:
            with torch.no_grad():
                (outs, tokens, cache), run_s = timed(device, lambda: decode_run(
                    cfg, params, {"tokens": toks}, LONG_DECODE))
        finally:
            attn.BANDED = False
        require(all(bool(torch.isfinite(o.float()).all()) for o in outs),
                f"(a) BANDED={banded}: non-finite logits")
        require(tuple(outs[0].shape) == (1, 1, cfg.padded_vocab()),
                f"(a) prefill logits {tuple(outs[0].shape)}")
        last[banded], greedy[banded] = outs[0].float(), tokens
        log("longctx", f"(a) {ARCH} whole, prefill {prompt} tokens and {LONG_DECODE} decode "
                       f"steps, BANDED={banded}: {1e3 * run_s:.2f} ms, peak "
                       f"{peak_gib(device):.2f} GiB")
        del outs, cache
    log("longctx", f"(a) last-position logits BANDED off vs on: max abs diff "
                   f"{max_abs_err(last[False], last[True]):.6g} (of max "
                   f"{float(last[False].abs().max()):.4g}); greedy tokens equal: "
                   f"{bool(torch.equal(greedy[False], greedy[True]))}")

    # (d) one layer's prefill attention against the whole f32 matrix
    acfg = _attn_cfg(cfg, cfg.layer_kinds()[0])
    with torch.no_grad():
        bp = _period(params["blocks"], 0)["pos0"]
        x = rmsnorm(bp["norm1"], embed(params["embed"], toks[:, :check_seq]), cfg.norm_eps)
        q, k, v = (t.float() for t in attn._project_qkv(
            bp["attn"], x, acfg["num_heads"], acfg["num_kv_heads"], acfg["head_dim"],
            acfg["qk_norm"], acfg["use_rope"], torch.arange(check_seq, device=device)[None],
            acfg["rope_theta"]))
        tiled = attn._flash_attention(q, k, v, acfg["kind"], acfg["window"], acfg["chunk"])
        whole = whole_matrix_attention(q, k, v, acfg["kind"], acfg["window"], acfg["chunk"])
    err = max_abs_err(tiled, whole)
    require(err <= LONG_ATOL, f"(d) tiled vs whole-matrix softmax: {err} > {LONG_ATOL}")
    log("longctx", f"(d) layer 0 prefill attention ({acfg['kind']}, S={check_seq}, f32, "
                   f"tiles {attn.BLOCK_Q}x{attn.BLOCK_K}) vs a whole-matrix f32 softmax: "
                   f"max_abs_err {err:.3g} <= {LONG_ATOL}")
    del tiled, whole, q, k, v, x

    # (c) one dense train step at train_seq
    tc = TrainConfig(model=cfg, seq_len=train_seq, global_batch=1, lr=3e-3, warmup_steps=10,
                     total_steps=1, sync=SyncConfig(mode="dense"))
    seq = torch.randint(1, cfg.vocab_size, (1, train_seq + 1), generator=gen, device=device)
    batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
    free_cached(device)
    peak_reset(device)
    state = steps.init_train_state(torch.Generator(device=device).manual_seed(1), params, tc, 1, 1)
    step = steps.make_train_step(cfg, tc, 1, 1)
    (state, metrics), step_s = timed(device, lambda: step(state, batch))
    loss = float(metrics["loss"])
    require(math.isfinite(loss), f"(c) loss {loss}")
    log("longctx", f"(c) {ARCH} dense train step, seq {train_seq}, batch 1 (remat "
                   f"{tc.remat}, AdamW): loss {loss:.4f}, {1e3 * step_s:.2f} ms, peak "
                   f"{peak_gib(device):.2f} GiB")
    del state, metrics, step, params, batch
    free_cached(device)

    # (b) seamless's encoder at `frames` source frames + a short decoder prefill
    scfg = get_config(SEAMLESS_ARCH)
    sparams = tm.init_params(0, scfg, device)
    dtype = tm.model_dtype(scfg)
    src = torch.randn((1, frames, scfg.enc_d_model or scfg.d_model), generator=gen,
                      device=device).to(dtype)
    dec = torch.randint(1, scfg.vocab_size, (1, LONG_DEC_PROMPT), generator=gen, device=device)
    peak_reset(device)
    with torch.no_grad():
        (logits, cache), s = timed(device, lambda: tm.prefill(
            sparams, scfg, {"tokens": dec, "src_embeds": src}))
    require(bool(torch.isfinite(logits.float()).all()), "(b) non-finite logits")
    require(tuple(cache["enc_memory"].shape) == (1, frames, scfg.enc_d_model or scfg.d_model),
            f"(b) enc_memory {tuple(cache['enc_memory'].shape)}")
    log("longctx", f"(b) {SEAMLESS_ARCH}: encoder ({scfg.enc_layers} layers) on {frames} "
                   f"frames + decoder prefill of {LONG_DEC_PROMPT} tokens: {1e3 * s:.2f} ms, "
                   f"peak {peak_gib(device):.2f} GiB")
    del sparams, src, logits, cache
    free_cached(device)
    log("longctx", f"phase {time.perf_counter() - t_phase:.2f} s")


def dp_config(layers=DP_LAYERS, reduced=False):
    """h2o-danube-1.8b at full width (``reduced``: its reduced config, for a
    rehearsal on the CPU) with its depth cut to ``layers`` (None: whole)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(ARCH).reduced() if reduced else get_config(ARCH)
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def dp_inputs(cfg, device, seed, rank):
    """Seeded params, one microbatch's grads (seq DP_SEQ) from batch seed
    ``seed``, rank ``rank``'s f32 control variates h_i and the shared h_bar
    (drawn leaf by leaf in ``tree_flatten`` order, so the check can replay
    them) -> (grads, h, h_bar)."""
    import torch
    from repro_torch import models as tm
    from repro_torch.utils.tree import tree_flatten, tree_unflatten
    params = tm.init_params(0, cfg, device)
    leaves, td = tree_flatten(params)
    toks = torch.randint(1, cfg.vocab_size, (1, DP_SEQ + 1),
                         generator=torch.Generator(device=device).manual_seed(seed),
                         device=device)
    req = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, _ = tm.loss_fn(tree_unflatten(td, req), cfg,
                             {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = tree_unflatten(td, [torch.zeros_like(p) if g is None else g
                                for g, p in zip(grads, leaves)])
    del req, params, leaves
    return grads, dp_controls(grads, DP_H_SEED + rank, device), \
        dp_controls(grads, DP_HBAR_SEED, device)


def dp_controls(like, seed, device):
    """A control-variate tree shaped as ``like``: f32 draws * 1e-3 from
    ``seed``, leaf by leaf."""
    import torch
    from repro_torch.utils.tree import tree_map
    gen = torch.Generator(device=device).manual_seed(seed)
    return tree_map(lambda t: dp_control(t.shape, gen, device), like)


def dp_control(shape, gen, device):
    import torch
    return torch.randn(tuple(shape), generator=gen, device=device).mul_(1e-3)


def dp_worker(grads, h, hb, world, rank, device, probe=None):
    """One ``efbv_sync_worker`` call under qsgd_kernel over the default group
    with rank ``rank``'s draws; with ``probe`` (a KernelProbe of B1), every
    B1 launch is held bit for bit to its plain version.  -> ((g_est, h_i,
    h_bar), seconds)."""
    import torch
    from repro_torch.configs.base import SyncConfig
    from repro_torch.core import distributed as tdist
    from repro_torch.core.ef_bv import efbv_sync_worker
    from repro_torch.kernels import ops, quant8
    sync = SyncConfig(mode="efbv", compressor="qsgd_kernel")
    c, (lam, nu) = tdist.build_compressor(sync), tdist.sync_params(sync, world)
    gen = torch.Generator(device=device).manual_seed(DP_DRAW_SEED + rank)
    if probe is not None:
        ops._q8 = probe
    try:
        return timed(device, lambda: efbv_sync_worker(grads, h, hb, c, lam, nu, generator=gen))
    finally:
        ops._q8 = quant8


def dp_main_path(grads, h, hb, world, rank, device):
    """The main path: the probed sync, its launch counts set to 0 before
    and read after.  -> (results, B1 launches, held checks, seconds)."""
    from repro_torch import kernels
    from repro_torch.kernels import quant8, ref
    probe = KernelProbe(quant8, "quant_dequant_2d", ref.quant_dequant_ref, every=True)
    kernels.reset_launch_counts()
    out, s = dp_worker(grads, h, hb, world, rank, device, probe)
    launches = kernels.launch_counts()["quant_dequant_2d"]
    held = [ch for ch in probe.checks if ch[1] == device.type]
    require(all(ch[2] for ch in held) and (len(held) == launches or device.type != "cuda"),
            f"dp rank {rank}: {launches} B1 launches, {len(held)} held, unequal "
            f"{[ch for ch in held if not ch[2]]}")
    return out, launches, held, s


def fingerprint(tree):
    """Per leaf, the sum of its bits as int64 (equal trees, equal sums)."""
    import torch
    from repro_torch.utils.tree import tree_leaves
    return torch.stack([t.contiguous().view(torch.int32).sum(dtype=torch.int64)
                        for t in tree_leaves(tree)])


def dp_check(grads, hb, out, world, rank, device, gathered):
    """Leaf by leaf: every rank's gradient (``gathered(leaf)`` stacks them,
    rank order), every rank's h_i and draws replayed from their seeds and
    this h_bar through ``core.distributed.efbv_sync``'s per-leaf path with
    G = world; this rank's (g_est, h_i, h_bar) must equal it bit for bit.
    -> the leaves checked."""
    import torch
    from repro_torch.configs.base import SyncConfig
    from repro_torch.core import distributed as tdist
    from repro_torch.kernels.ops import tile_rows
    from repro_torch.utils.tree import tree_leaves
    sync = SyncConfig(mode="efbv", compressor="qsgd_kernel")
    c, (lam, nu) = tdist.build_compressor(sync), tdist.sync_params(sync, world)
    gh = [torch.Generator(device=device).manual_seed(DP_H_SEED + r) for r in range(world)]
    gu = [torch.Generator(device=device).manual_seed(DP_DRAW_SEED + r) for r in range(world)]
    ge, nh, nhb = (tree_leaves(t) for t in out)
    for li, (g, b) in enumerate(zip(tree_leaves(grads), tree_leaves(hb))):
        stacked = gathered(g)
        h = torch.stack([dp_control(g.shape, gh[r], device) for r in range(world)])
        noise = [[torch.rand((tile_rows(g.numel()), 512), generator=gu[r], device=device)
                  for r in range(world)]]
        state = tdist.SyncState(h={"x": h}, h_bar={"x": b.clone()}, step=0)
        est, state = tdist.efbv_sync({"x": stacked}, state, c, lam, nu, bucket_size=0,
                                     noise=noise)
        require(bits_equal(est["x"], ge[li]) and bits_equal(state.h["x"][rank], nh[li])
                and bits_equal(state.h_bar["x"], nhb[li]),
                f"dp rank {rank} leaf {li}: efbv_sync_worker != efbv_sync (G={world})")
        del stacked, h, noise, state, est
    return len(ge)


def dp_rank(rank, world, on_card, store, out_dir, layers, reduced):
    """One spawned rank of dp (b): its own batch's grads on the card, the
    probed sync over the gloo group, the check, then an unprobed timing run
    (its results' fingerprints equal to the probed run's); its results to
    ``out_dir``/rank<r>.json."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    import torch.distributed as dist
    from repro_torch.utils.tree import tree_leaves
    torch.set_num_threads(2)
    device = torch.device("cuda", 0) if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world)
    try:
        grads, h, hb = dp_inputs(dp_config(layers, reduced), device, DP_BATCH_SEED + rank, rank)
        n = sum(g.numel() for g in tree_leaves(grads))
        peak_reset(device)
        out, launches, held, sync_s = dp_main_path(grads, h, hb, world, rank, device)
        del h                                    # the check and the timing replay it

        def gathered(g):
            buf = g.new_empty((world,) + tuple(g.shape))
            dist.all_gather(list(buf.unbind(0)), g.contiguous())
            return buf

        leaves = dp_check(grads, hb, out, world, rank, device, gathered)
        want = fingerprint(out)
        del out
        peak = peak_gib(device)
        h = dp_controls(grads, DP_H_SEED + rank, device)
        again, timing_s = dp_worker(grads, h, hb, world, rank, device)
        require(torch.equal(fingerprint(again), want),
                f"dp rank {rank}: the unprobed sync != the probed one")
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"launches": launches, "held": len(held),
                       "max_abs_err": max((ch[3] for ch in held), default=0.0),
                       "sync_ms": 1e3 * sync_s, "timing_ms": 1e3 * timing_s,
                       "peak_gib": peak, "leaves": leaves, "params": n}, f)
    finally:
        dist.destroy_process_group()


def dp_single(device, layers, reduced, store):
    """dp (a): a 1-rank NCCL group (gloo off the card), the whole model's
    grads, the probed sync, an unprobed timing run, then the single-process
    per-leaf efbv_sync with G = 1 on the same grads and draws.  -> B1
    launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import SyncConfig
    from repro_torch.core import distributed as tdist
    from repro_torch.utils.tree import tree_leaves, tree_map
    on_card = device.type == "cuda"
    dist.init_process_group("nccl" if on_card else "gloo", init_method=store, rank=0,
                            world_size=1)
    try:
        grads, h, hb = dp_inputs(dp_config(None, reduced), device, DP_BATCH_SEED, 0)
        n = sum(g.numel() for g in tree_leaves(grads))
        peak_reset(device)
        out, launches, held, sync_s = dp_main_path(grads, h, hb, 1, 0, device)
        require(launches > 0 or not on_card, "dp (a): B1 was not launched")
        want = fingerprint(out)
        again, timing_s = dp_worker(grads, h, hb, 1, 0, device)
        require(torch.equal(fingerprint(again), want), "dp (a): the unprobed sync != the probed one")
        del again
        peak = peak_gib(device)
        sync = SyncConfig(mode="efbv", compressor="qsgd_kernel")
        lam, nu = tdist.sync_params(sync, 1)
        state = tdist.SyncState(h=tree_map(lambda t: t[None], h), h_bar=hb, step=0)
        est, state = tdist.efbv_sync(
            tree_map(lambda t: t[None], grads), state, tdist.build_compressor(sync), lam, nu,
            bucket_size=0, generator=torch.Generator(device=device).manual_seed(DP_DRAW_SEED))
        pairs = zip(tree_leaves(out[0]) + tree_leaves(out[1]) + tree_leaves(out[2]),
                    tree_leaves(est) + [t[0] for t in tree_leaves(state.h)]
                    + tree_leaves(state.h_bar))
        require(all(bits_equal(a, b) for a, b in pairs),
                "dp (a): efbv_sync_worker's (g_est, h_i, h_bar) != efbv_sync (G=1)")
        log("dp", f"(a) {ARCH} whole ({n} params), 1-rank {dist.get_backend()} group: "
                  f"{launches} B1 launches, each == plain bit for bit (max_abs_err "
                  f"{max((ch[3] for ch in held), default=0.0)}); (g_est, h_i, h_bar) == "
                  f"efbv_sync per-leaf (G=1) bit for bit; sync {1e3 * sync_s:.2f} ms probed, "
                  f"{1e3 * timing_s:.2f} ms unprobed; peak {peak:.2f} GiB")
        return launches
    finally:
        dist.destroy_process_group()


def phase_dp(device, layers_b=DP_LAYERS, world=DP_RANKS, join_s=DP_JOIN_S, reduced=False):
    """Part C on the card: the data-parallel EF-BV sync
    (``core.ef_bv.efbv_sync_worker``) under qsgd_kernel, B1 on every rank,
    every B1 launch held bit for bit to its plain version.  (a) A 1-rank
    NCCL group (file store): h2o-danube-1.8b whole at full width, one
    microbatch's grads (seq DP_SEQ), one sync equal bit for bit to
    ``core.distributed.efbv_sync``'s per-leaf path with G = 1 on the same
    grads and draws.  (b) ``world`` spawned ranks on the one card over
    ``gloo`` (which stages CUDA tensors through host memory: not an NVLink
    figure), danube at full width cut to ``layers_b`` layers, each rank its
    own batch; each rank's (g_est, h_i, h_bar) equal bit for bit to the
    per-leaf efbv_sync with G = world on every rank's gathered grads and
    replayed draws.  ``reduced``: the reduced config (a CPU rehearsal).
    -> B1 launches of both."""
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    tmp = tempfile.mkdtemp()
    try:
        launches_a = dp_single(device, None, reduced, "file://" + os.path.join(tmp, "store_a"))
        free_cached(device)
        out_dir = os.path.join(tmp, "ranks")
        os.makedirs(out_dir)
        ctx = mp.start_processes(dp_rank, args=(world, on_card, "file://" + os.path.join(
            tmp, "store_b"), out_dir, layers_b, reduced), nprocs=world, join=False,
            start_method="spawn")
        deadline = time.monotonic() + join_s
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise SmokeFailure(f"dp (b): the {world} ranks did not finish in {join_s} s")
        ranks = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp)
    depth = dp_config(None, reduced).num_layers
    for r, res in enumerate(ranks):
        require(res["launches"] > 0 or not on_card, f"dp (b) rank {r}: B1 was not launched")
        log("dp", f"(b) rank {r}/{world} on one card over gloo: {ARCH} full width, "
                  f"{layers_b} of {depth} layers ({res['params']} params); "
                  f"{res['launches']} B1 launches, each == plain bit for bit (max_abs_err "
                  f"{res['max_abs_err']}); (g_est, h_i, h_bar) == efbv_sync per-leaf "
                  f"(G={world}) on {res['leaves']} leaves bit for bit; sync "
                  f"{res['sync_ms']:.2f} ms probed, {res['timing_ms']:.2f} ms unprobed (gloo, "
                  f"staged through host memory); peak {res['peak_gib']:.2f} GiB")
    launches_b = sum(res["launches"] for res in ranks)
    log("dp", f"phase {time.perf_counter() - t_phase:.2f} s; B1 launches (a) {launches_a}, "
              f"(b) {launches_b}")
    return launches_a + launches_b


# ---------------------------------------------------------------------------
def ep_tensors(cfg, device, seed):
    """One full-width MoE layer of ``cfg`` (``init_moe``, the model's init,
    in its dtype) and N(0, 1) tokens (2, MOE_PROMPT, d), as the layer's
    normalized input is scaled."""
    import torch
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.transformer import model_dtype
    m, dt = cfg.moe, model_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = moe_lib.init_moe(gen, cfg.d_model, cfg.d_ff, m.num_experts, cfg.mlp_gated,
                              m.shared_expert, dt, device)
    x = torch.randn((2, MOE_PROMPT, cfg.d_model), generator=gen, device=device).to(dt)
    r = torch.randn(x.shape, generator=gen, device=device)
    return params, x, r


def ep_dequant(x):
    """The tokens ``gather_quant`` gathers on a 1-rank "model" axis: per
    token absmax int8 codes (``round``) times their scales."""
    import torch
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return (torch.round(xf / scale).clamp(-127, 127).to(torch.int8).float() * scale).to(x.dtype)


def ep_nest(flat):
    """{"a/b": t} -> {"a": {"b": t}}."""
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, last = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def ep_run(fn, x, r, device, leaves):
    """fn(flat params, x) -> (y, aux) on copies of ``leaves`` (a flat
    {path: tensor}) that take gradients; forward + backward of
    sum(y * r) + aux, once to warm up (the first collective sets up the
    NCCL communicator), then timed -> (y, aux, grads of x and the leaves,
    CUDA-event ms, peak GiB of the timed run)."""
    import torch

    def once():
        xs = x.detach().clone().requires_grad_(True)
        ps = {k: v.detach().clone().requires_grad_(True) for k, v in leaves.items()}
        y, aux = fn(ps, xs)
        grads = torch.autograd.grad((y.float() * r).sum() + aux, [xs] + list(ps.values()))
        return y.detach(), aux.detach(), [g.detach() for g in grads]

    once()
    torch.cuda.synchronize(device)
    peak_reset(device)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = once()
    b.record()
    b.synchronize()
    return (*out, a.elapsed_time(b), peak_gib(device))


def phase_ep(device):
    """The expert-parallel MoE paths (Queue 1, item 8d) on a 1-rank NCCL
    group's (1, 1) ("data", "model") mesh: ``moe_ffn_shardmap``, with
    ``gather_quant`` and ``moe_ffn_alltoall``, their collectives real NCCL
    calls on the one rank, against the scatter ``moe_ffn`` on the same
    full-width MoE layer (llama4: 16 experts top-1 + shared; dbrx: 16
    experts top-4; bf16) and tokens, forward and backward (sum(y * r) +
    aux): outputs and gradients within EP_RTOL of the max, aux equal.
    gather_quant's routing sees the int8 tokens, so a near-tie picks
    another expert or drops another token: it is held to the scatter path
    on the tokens it gathers (``ep_dequant``), and its tokens' gradient
    (through the scales only) is not compared."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.transformer import _moe_kw

    if device.type != "cuda":
        raise SmokeFailure("ep: the 1-rank NCCL group needs the card")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "store"),
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        for arch, n_layers in MOE_CUTS:
            cfg = get_config(arch)
            kw = _moe_kw(cfg)
            params, x, r = ep_tensors(cfg, device, 0)
            leaves = {k: v for k, v in params.items() if k != "shared"}
            leaves.update({"shared/" + k: v for k, v in params.get("shared", {}).items()})
            scatter = lambda ps, xs: moe_lib.moe_ffn(ep_nest(ps), xs, **kw)   # noqa: E731
            want = ep_run(scatter, x, r, device, leaves)
            want_q = ep_run(scatter, ep_dequant(x), r, device, leaves)
            names = ["x"] + list(leaves)
            log("ep", f"{arch}: one full-width MoE layer (of {n_layers} layers as the arch phase "
                      f"cuts it: d {cfg.d_model}, ff {cfg.d_ff}, {cfg.moe.num_experts} experts "
                      f"top-{cfg.moe.top_k}{' + shared' if cfg.moe.shared_expert else ''}, "
                      f"{x.dtype}), tokens {tuple(x.shape)}: scatter moe_ffn forward + backward "
                      f"{want[3]:.2f} ms, peak {want[4]:.2f} GiB")
            # the rules' placements on the (1, 1) mesh; the one rank's local
            # tensor is the whole (from_local keeps the gradient's path)
            place = {"router": [Replicate(), Replicate()], "shared/w_in": [Replicate(), Shard(1)],
                     "shared/w_gate": [Replicate(), Shard(1)],
                     "shared/w_out": [Replicate(), Shard(0)]}

            def on_mesh(path):
                impl = moe_lib.moe_ffn_alltoall if path == "alltoall" else moe_lib.moe_ffn_shardmap
                extra = {"gather_quant": True} if "gather_quant" in path else {}

                def fn(ps, xs):
                    d = {k: DTensor.from_local(v, mesh, place.get(k, [Replicate(), Shard(0)]),
                                               run_check=False) for k, v in ps.items()}
                    xd = DTensor.from_local(xs, mesh, [Shard(0), Shard(2)], run_check=False)
                    y, aux = impl(ep_nest(d), xd, **kw, **extra)
                    return y.to_local(), aux.to_local()
                return fn

            for path in EP_PATHS:
                got = ep_run(on_mesh(path), x, r, device, leaves)
                quant = "gather_quant" in path
                ref = want_q if quant else want
                y_err = max_abs_err(got[0], ref[0])
                y_rel = y_err / float(ref[0].float().abs().max())
                g_rel = {n: max_abs_err(g, w) / max(float(w.float().abs().max()), 1e-30)
                         for n, g, w in zip(names, got[2], ref[2]) if not (quant and n == "x")}
                require(bool(torch.isfinite(got[0].float()).all()), f"ep {arch} {path}: non-finite")
                require(y_rel <= EP_RTOL, f"ep {arch} {path}: output {y_rel:.3g} of the max > "
                                          f"{EP_RTOL}")
                # top-1's renormalized gate is 1: the router's gradient from y is
                # rounding noise in both paths; its aux gradient is compared
                bad = {n: e for n, e in g_rel.items() if e > EP_RTOL
                       and not (n == "router" and cfg.moe.top_k == 1)}
                require(not bad, f"ep {arch} {path}: gradients over {EP_RTOL} of the max: {bad}")
                require(abs(float(got[1]) - float(ref[1])) <= EP_RTOL * abs(float(ref[1])),
                        f"ep {arch} {path}: aux {float(got[1])} vs {float(ref[1])}")
                log("ep", f"{arch} {path}: output max_abs_err {y_err:.4g} ({y_rel:.3g} of the "
                          f"max, <= {EP_RTOL}) against the scatter path"
                          + (" on the int8-gathered tokens" if quant else "")
                          + f", aux {float(got[1]):.6f} vs {float(ref[1]):.6f}; gradients of "
                            f"the max: " + ", ".join(f"{n} {e:.3g}" for n, e in g_rel.items())
                          + f"; forward + backward {got[3]:.2f} ms, peak {got[4]:.2f} GiB")
            del params, x, r, want, want_q, leaves
            free_cached(device)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp)
    log("ep", f"phase {time.perf_counter() - t_phase:.2f} s")


# ---------------------------------------------------------------------------
DRYRUN_SCRIPT = """
import json, sys
from repro_torch.launch import dryrun as dr
arch, shape, mp = json.loads(sys.argv[1])
rec = dr.run_one(arch, shape, mp)
rec.pop("traceback", None)
print(json.dumps(rec))
"""


def dryrun_subprocesses(out_dir):
    """(a), (c), (e) and (f) of the dryrun phase, started together, one
    process each: -> {name: Popen}."""
    env = dict(os.environ, PYTHONPATH=SRC)

    def start(*argv):
        return subprocess.Popen([sys.executable, *argv], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env, cwd=out_dir)

    procs = {f"(a) {i}": start("-c", DRYRUN_SCRIPT, json.dumps(cell))
             for i, cell in enumerate(DRYRUN_CELLS)}
    arch, shape = DRYRUN_CLI
    procs["(c)"] = start("-m", "repro_torch.launch.train", "--arch", arch, "--dry-run",
                         "--shape", shape, "--multi-pod")
    for i, (arch, shape, variants) in enumerate(PERF_RECORDS):
        procs[f"(e) {i}"] = start("-m", "repro_torch.launch.perf", "--arch", arch, "--shape",
                                  shape, "--variants", variants, "--out",
                                  os.path.join(out_dir, f"perf{i}.json"))
    arch, shape = SERVE_DRYRUN_CLI
    procs["(f)"] = start("-m", "repro_torch.launch.serve", "--arch", arch, "--dry-run",
                         "--shape", shape)
    return procs


def dryrun_record_line(rec):
    mem = rec["memory"]
    return (f"{rec['arch']} x {rec['shape']} x {rec['mesh']} ({rec['sync']}, fake "
            f"{rec['fake_device']} tensors): {rec['status']}, trace {rec['trace_s']} s "
            f"(host); per rank: arguments {mem['argument_size_in_bytes']} B, peak "
            f"{mem['peak_bytes']} B ({mem['peak_bytes'] / 2**30:.2f} GiB), output "
            f"{mem['output_size_in_bytes']} B; collectives {json.dumps(rec['collectives'])}")


def check_dryrun_cells(procs, out_dir, t_start):
    """Wait for (a), (c), (e) and (f); every cell, the CLIs' records and
    every perf record must be ok, and (f)'s record equal to (a)'s direct
    one of its cell in every field but trace_s."""
    outs = {}
    for name, p in procs.items():
        try:
            out, err = p.communicate(timeout=max(1.0, t_start + DRYRUN_JOIN_S
                                                 - time.perf_counter()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            raise SmokeFailure(f"dryrun {name}: not done {DRYRUN_JOIN_S} s after the phase's start")
        require(p.returncode == 0, f"dryrun {name} exited {p.returncode}: {err[-3000:]}")
        outs[name] = out
    traces, cells = {}, {}
    for i in range(len(DRYRUN_CELLS)):
        rec = json.loads(outs[f"(a) {i}"].strip().splitlines()[-1])
        require(rec["status"] == "ok", f"dryrun (a) {rec['arch']} x {rec['shape']}: "
                                       f"{rec['status']}: {rec.get('error') or rec.get('reason')}")
        traces[(rec["arch"], rec["shape"])] = rec["trace_s"]
        cells[(rec["arch"], rec["shape"], rec["mesh"])] = rec
        log("dryrun", "(a) " + dryrun_record_line(rec))
    for i, (arch, shape, variants) in enumerate(PERF_RECORDS):
        with open(os.path.join(out_dir, f"perf{i}.json")) as f:
            rec = json.load(f)
        require(rec["sync"] == ("efbv" if variants == "sync_efbv" else "dense")
                and rec["terms_s"]["compute_s"] > 0 and rec["coll_total"] > 0,
                f"dryrun (e) {arch} {shape} {variants}: {rec}")
        direct = traces.get((arch, shape))
        log("dryrun", f"(e) perf {arch} x {shape} [{variants or 'baseline'}] ({rec['mesh']}, "
                      f"sync {rec['sync']}): trace {rec['trace_s']} s host"
                      + (f" (the direct dry-run cell: {direct} s)" if direct else "")
                      + f"; terms {json.dumps(rec['terms_s'])}, dominant {rec['dominant']}, "
                        f"useful {rec['useful_ratio']:.4f}; per rank peak {rec['peak_gb']:.3f} GB, "
                        f"memory {json.dumps(rec['mem_gb'])}; collective bytes "
                      + json.dumps({k: v for k, v in rec.items() if k.startswith("coll_")}))
    arch, shape = DRYRUN_CLI
    path = os.path.join(out_dir, "results", "dryrun", f"{arch}__{shape}__mp__dense.json")
    require(os.path.exists(path), f"dryrun (c): launch.train --dry-run wrote no {path}")
    with open(path) as f:
        rec = json.load(f)
    require(rec["status"] == "ok", f"dryrun (c): {rec['status']}: {rec.get('error')}")
    log("dryrun", "(c) launch.train --dry-run --multi-pod: " + dryrun_record_line(rec))
    arch, shape = SERVE_DRYRUN_CLI
    path = os.path.join(out_dir, "results", "dryrun", f"{arch}__{shape}__sp__dense.json")
    require(os.path.exists(path), f"dryrun (f): launch.serve --dry-run wrote no {path}")
    with open(path) as f:
        rec = json.load(f)
    require(rec["status"] == "ok", f"dryrun (f): {rec['status']}: {rec.get('error')}")
    want = cells[(arch, shape, rec["mesh"])]
    diff = sorted(k for k in set(rec) | set(want)
                  if k != "trace_s" and rec.get(k) != want.get(k))
    require(not diff, f"dryrun (f): launch.serve's record differs from run_one's in {diff}")
    log("dryrun", f"(f) launch.serve --dry-run --shape {shape}: " + dryrun_record_line(rec)
        + f"; equal to (a)'s run_one record but for trace_s ({want['trace_s']} s there)")


def anchor_fill(step, cfg, device):
    """Random params (seed 0) and tokens, zero moments, in place."""
    import torch
    from repro_torch.launch import dryrun as dr
    gen = torch.Generator(device=device).manual_seed(0)
    state = step.inputs.get("state", step.inputs)
    for t in dr.local_tensors(state["params"]):
        t.normal_(0.0, 0.02, generator=gen)
    for t in dr.local_tensors(step.inputs["batch"]):
        t.random_(0, cfg.vocab_size, generator=gen)
    for t in dr.local_tensors({k: state[k] for k in ("mu", "nu") if k in state}):
        t.zero_()


def dryrun_anchor(device):
    """(b): the dry-run's one-device estimate of whole h2o-danube-1.8b's
    dense train step and prefill against the same step on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as dr

    if device.type != "cuda":
        raise SmokeFailure("dryrun (b): the memory anchor runs on the card")
    cfg = get_config(ARCH)
    for kind, seq in ANCHOR_RUNS:
        shape = InputShape(kind, seq, 1, kind)
        est = dr.trace_step(lambda: dr.build_single_step(cfg, shape, "full", "cuda"))["memory"]
        free_cached(device)
        base = torch.cuda.memory_allocated(device)
        step = dr.build_single_step(cfg, shape, "full", device)
        # the real inputs' bytes, counted apart from the dry-run's own count:
        # each storage once, and the caching allocator's growth (blocks of
        # 512 B) from building them
        storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                    for t in dr.local_tensors(step.inputs)}
        args = sum(storages.values())
        grown = torch.cuda.memory_allocated(device) - base
        blocks = sum(-(-n // 512) * 512 for n in storages.values())
        anchor_fill(step, cfg, device)
        peak_reset(device)
        t0 = time.perf_counter()
        out = step.run()
        torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        real = torch.cuda.max_memory_allocated(device) - base
        del step, out
        free_cached(device)
        require(args == est["argument_size_in_bytes"] and grown == blocks,
                f"dryrun (b) {kind}: argument bytes {args} on the card ({len(storages)} "
                f"storages, the allocator grew {grown} B for {blocks} B of blocks), "
                f"{est['argument_size_in_bytes']} estimated")
        ratio = real / est["peak_bytes"]
        log("dryrun", f"(b) {ARCH} whole, {kind} at (1, {seq}), remat full: arguments "
                      f"{args} B in {len(storages)} storages == estimate (the allocator "
                      f"grew {grown} B == their 512 B blocks); peak max_memory_allocated {real} B "
                      f"({real / 2**30:.2f} GiB) vs the dry-run's {est['peak_bytes']} B "
                      f"({est['peak_bytes'] / 2**30:.2f} GiB): ratio {ratio:.4f} (allowed "
                      f"{ANCHOR_RANGE[0]}-{ANCHOR_RANGE[1]}); the real step {ms:.2f} ms")
        require(ANCHOR_RANGE[0] <= ratio <= ANCHOR_RANGE[1],
                f"dryrun (b) {kind}: the card's peak is {ratio:.4f} x the estimate")


def flop_anchor(device):
    """(d): whole h2o-danube-1.8b's dense train step at (1, 4096) on the
    card under ``FlopCounterMode`` against the dry-run's fake trace of the
    same step (equal), ``costing.corrected_costs`` from 1 and 2 layers
    (within FLOP_ANCHOR_RTOL)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.costing import corrected_costs

    cfg = get_config(ARCH)
    kind, seq = ANCHOR_RUNS[0]
    shape = InputShape(kind, seq, 1, kind)
    fake = dr.trace_step(lambda: dr.build_single_step(cfg, shape, "full", "cuda"),
                         cost=True)["cost"]["flops"]
    t0 = time.perf_counter()
    cc = corrected_costs(cfg, None, shape, device="cuda")["corrected"]["flops"]
    cc_s = time.perf_counter() - t0
    free_cached(device)
    step = dr.build_single_step(cfg, shape, "full", device)
    anchor_fill(step, cfg, device)
    step.run()                                            # warm
    with FlopCounterMode(display=False) as fc:
        step.run()
    real = fc.get_total_flops()
    del step
    free_cached(device)
    require(real == fake, f"dryrun (d): the card's step counts {real} flops, the fake trace "
                          f"{fake}")
    rel = abs(cc - real) / real
    require(rel <= FLOP_ANCHOR_RTOL, f"dryrun (d): corrected_costs {cc} vs {real} ({rel:.4g})")
    log("dryrun", f"(d) flop anchor, {ARCH} whole dense train step at (1, {seq}): "
                  f"FlopCounterMode on the card {real} flops == the fake trace's {fake}; "
                  f"corrected_costs from 1 and 2 layers {cc:.0f} ({rel:.3g} off, <= "
                  f"{FLOP_ANCHOR_RTOL}; {cc_s:.2f} s host)")


def phase_dryrun(device):
    """The dry-run (ROADMAP Queue 1, items 8b, 8c): (a), (c) and (e) in
    subprocesses while (b) and (d) run on the card in this process; no
    kernel of the repo runs (the dry-run's B1 is its registered fake)."""
    t_phase = time.perf_counter()
    out_dir = tempfile.mkdtemp()
    procs = dryrun_subprocesses(out_dir)
    try:
        dryrun_anchor(device)
        flop_anchor(device)
        check_dryrun_cells(procs, out_dir, t_phase)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(out_dir)
    log("dryrun", f"phase {time.perf_counter() - t_phase:.2f} s")


# ---------------------------------------------------------------------------
def cuda_ms(fn, reps=5, warmup=1):
    """Median of ``reps`` CUDA-event timings of ``fn()``, after ``warmup``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_timing(rows, device, launches):
    """B1-B3 and B6 at the main path's (rows, 512) shape: bitwise check, then
    times (B6 timed between two timings of B2 on the same inputs)."""
    import torch
    from repro_torch.kernels import bitpack, quant8, ref, stream

    n = rows * 512
    g = torch.Generator(device=device).manual_seed(13)
    x = torch.randn((rows, 512), generator=g, device=device).mul_(0.02)
    x[::997] = 0.0
    u = torch.rand((rows, 512), generator=g, device=device)
    bytes_ = {"quant_dequant_2d": n * 12,
              "quant_pack_2d": n * 9 + rows * 4,
              "unpack_dequant_2d": n * 5 + rows * 4,
              "stream_quant_pack_2d": n * 9 + rows * 4}
    calls = {
        "quant_dequant_2d": (lambda: quant8.quant_dequant_2d(x, u),
                             lambda: ref.quant_dequant_ref(x, u), None),
        "quant_pack_2d": (lambda: bitpack.quant_pack_2d(x, u),
                          lambda: ref.quant_pack_ref(x, u), None),
        "stream_quant_pack_2d": (lambda: stream.stream_quant_pack_2d(x, u),
                                 lambda: ref.stream_quant_pack_ref(x, u, tile_rows=1 << 17),
                                 None),
    }
    errs = {**compare_kernels(x, u, 8), **compare_stream_kernel(x, u)}
    results = {}
    for name, (kern, plain, lib) in calls.items():
        results[name] = (cuda_ms(kern), cuda_ms(plain, reps=3), None)
    b2_again = cuda_ms(calls["quant_pack_2d"][0])
    # B1's wrapper launches directly; the repro::quant_dequant_2d op (the
    # dry-run's route for fake tensors) launches the same kernel through
    # torch's dispatcher: the op timed between two direct timings, at this
    # shape and at the train phase's 65536-row chunk
    for r in (rows, 65536):
        xs, us = x[:r], u[:r]
        direct = lambda: quant8.quant_dequant_2d(xs, us)          # noqa: E731
        op = lambda: quant8._quant_dequant_op(xs, us, 8)          # noqa: E731
        ab = [cuda_ms(f, reps=21) for f in (direct, op, op, direct)]
        if not torch.equal(direct(), op()):
            raise AssertionError("B1 through the op != B1 launched directly")
        log("timing", f"B1 ({r}x512) through the repro::quant_dequant_2d op: "
                      f"{ab[1]:.4f}, {ab[2]:.4f} ms between direct launches "
                      f"{ab[0]:.4f}, {ab[3]:.4f} ms (CUDA events, medians of 21)")
    q, s = bitpack.quant_pack_2d(x, u)
    del x, u
    gc.collect()
    torch.cuda.empty_cache()
    results["unpack_dequant_2d"] = (
        cuda_ms(lambda: bitpack.unpack_dequant_2d(q, s)),
        cuda_ms(lambda: ref.unpack_dequant_ref(q, s), reps=3),
        cuda_ms(lambda: torch.mul(q, s)))
    del q, s
    log("timing", f"B6 {results['stream_quant_pack_2d'][0]:.3f} ms between B2 "
                  f"{results['quant_pack_2d'][0]:.3f} and {b2_again:.3f} ms on the same inputs")
    out = []
    info = KERNEL_INFO + (("B6", "stream_quant_pack_2d", CODEC_INFO[2][2], CODEC_INFO[2][4]),)
    for kid, name, replaces, ops_per_elem in info:
        ms, plain_ms, lib_ms = results[name]
        t_bytes = 1e3 * bytes_[name] / HBM_BYTES_PER_S
        t_ops = 1e3 * ops_per_elem * n / F32_FLOPS
        entry = {"id": kid, "name": name, "route": "cuda", "source": KERNEL_SOURCE,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "library_ms": lib_ms}
        out.append(entry)
        log("timing", f"{kid} {name} ({rows}x512): {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                      f"bound {entry['bound_ms']:.3f} ms ({entry['bound_by']}, "
                      f"{bytes_[name] / 1e9:.2f} GB), library "
                      f"{'n/a' if lib_ms is None else f'{lib_ms:.3f} ms'}, "
                      f"{100 * entry['bound_ms'] / ms:.1f}% of bound")
    return out


def delta_inputs(device, arch=MAMBA_ARCH, seed=17):
    """One dense user at ``arch``'s full layout, without the model's
    weights: (layout, f32 base blocks, a pool holding a row for every block
    and the zero row 0, the user's table (every block its own row, in a
    random order), the engine's empty tree)."""
    import torch
    from repro_torch.comm.buckets import bucket_layout, empty_tree
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve.deltas import DEFAULT_BLOCK

    layout = bucket_layout(init_params(0, get_config(arch), device="meta"), DEFAULT_BLOCK)
    nb, bs = layout.n_buckets, layout.bucket_size
    g = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn((nb, bs), generator=g, device=device)
    pool = torch.randn((nb + 1, bs), generator=g, device=device).mul_(0.01)
    pool[0] = 0.0
    table = torch.randperm(nb, generator=g, device=device).add_(1).to(torch.int32)
    return layout, base, pool, table, empty_tree(layout, device)


def phase_delta_timing(device, launches):
    """D1 at mamba2-2.7b's full layout for one dense user: bit for bit
    against its plain version, then its time (CUDA events, medians) beside
    its byte bound (base and the pool's row read once, each leaf written
    once) and the plain version's.  A call's time holds the wrapper's host
    checks of base, pool and table, during which the device waits; the
    device time per call (``queued_ms``) does not."""
    import torch
    from repro_torch.comm.buckets import empty_tree
    from repro_torch.kernels import delta_apply as da
    from repro_torch.utils.tree import tree_leaves

    free_cached(device)
    layout, base, pool, table, tree = delta_inputs(device)
    work = da.work_list(layout, tree)
    plain_tree = empty_tree(layout, device)
    before = da.delta_apply.launches
    da.delta_apply(base, pool, table, tree, layout, work)
    da.delta_apply_plain(base, pool, table, plain_tree, layout)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    for j, (a, b) in enumerate(zip(tree_leaves(tree), tree_leaves(plain_tree))):
        bits = {2: torch.int16, 4: torch.int32}[a.element_size()]
        require(a.dtype == b.dtype and torch.equal(a.view(bits), b.view(bits)),
                f"D1 != its plain version at leaf {j} of the full layout")
    ms = cuda_ms(lambda: da.delta_apply(base, pool, table, tree, layout, work), reps=21)
    device_ms = queued_ms(lambda: da.delta_apply(base, pool, table, tree, layout, work))
    plain_ms = cuda_ms(lambda: da.delta_apply_plain(base, pool, table, plain_tree, layout))
    timed = da.delta_apply.launches - before
    nbytes = sum(size * (8 + leaf.element_size())
                 for size, leaf in zip(layout.sizes, tree_leaves(tree))) + 4 * layout.n_buckets
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    kid, name, replaces, source = DELTA_INFO
    log("timing", f"{kid} {name} ({MAMBA_ARCH}'s layout, d = {layout.d}, one dense user): "
                  f"{ms:.3f} ms, bound {bound_ms:.3f} ms (bytes, {nbytes / 1e9:.2f} GB), "
                  f"{100 * bound_ms / ms:.1f}% of bound; device {device_ms:.3f} ms a call "
                  f"queued, {100 * bound_ms / device_ms:.1f}% of bound; plain {plain_ms:.3f} ms; "
                  f"bit for bit the plain version; {launches} launches on the serve and arch "
                  f"paths, {timed} here")
    del base, pool, tree, plain_tree, work
    free_cached(device)
    return {"id": kid, "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": 0.0, "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def phase_mask_timing(d, device, launches):
    """B4 and B5 at the codec path's d: bitwise check, then times beside the
    plain versions and the byte bound (1 B per coordinate of mask, 1/8 B of
    words)."""
    import torch
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=device).manual_seed(17)
    mask = torch.rand(d, generator=g, device=device) < 0.01
    errs = compare_mask_kernels(mask)
    W = -(-d // 32)
    words = ops.pack_bits(mask)
    m2d = padded_mask(mask, 32 * W).view(32, W)
    times = {"pack_mask_2d": (cuda_ms(lambda: ops.pack_bits(mask)),
                              cuda_ms(lambda: ref.pack_mask_ref(m2d), reps=3)),
             "unpack_mask_2d": (cuda_ms(lambda: ops.unpack_bits(words, d)),
                                cuda_ms(lambda: ref.unpack_mask_ref(words.view(1, W)), reps=3))}
    del mask, m2d, words
    gc.collect()
    torch.cuda.empty_cache()
    out = []
    for kid, name, replaces, source, ops_per_elem in CODEC_INFO[:2]:
        ms, plain_ms = times[name]
        nbytes = d + 4 * W
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * ops_per_elem * d / F32_FLOPS
        entry = {"id": kid, "name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name], "max_abs_err": errs[name],
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "library_ms": None}
        out.append(entry)
        log("timing", f"{kid} {name} (d={d}): {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                      f"{entry['bound_ms']:.3f} ms ({entry['bound_by']}, {nbytes / 1e9:.2f} GB), "
                      f"library n/a, {100 * entry['bound_ms'] / ms:.1f}% of bound")
    return out


def queued_ms(fn, n=20, sleep_cycles=100_000_000):
    """Device ms per call of ``n`` calls queued back to back behind a device
    sleep, so the host's launch overhead stays off the device's clock."""
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def search_compares(scores, k, live=256):
    """Compares B8's selecting search makes on these scores (f32, (rows,
    cols), all >= +0), replaying its steps per column: a full-column step
    compares every key, a gathered step the 256 gathered slots, the gather
    one pass.  Returns (compares, the k-th largest key per column)."""
    import torch
    rows, cols = scores.shape
    keys = scores.contiguous().view(torch.int32).to(torch.int64) | (1 << 31)
    cand = torch.zeros(cols, dtype=torch.int64, device=scores.device)
    at, above = torch.full_like(cand, rows), torch.zeros_like(cand)
    gathered = torch.zeros(cols, dtype=torch.bool, device=scores.device)
    compares = torch.zeros_like(cand)
    for b in range(31, -1, -1):
        t = cand | (1 << b)
        c = (keys >= t).sum(0)
        compares += torch.where(gathered, live, rows)
        take = c >= k
        cand, at, above = torch.where(take, t, cand), torch.where(take, c, at), torch.where(take, above, c)
        new = ~gathered & (at - above <= live) if b > 0 else torch.zeros_like(gathered)
        compares += torch.where(new, rows, 0)
        gathered |= new
    return int(compares.sum()), cand


def peak_delta(device, fn):
    """(peak allocation above the live tensors before ``fn()``, peak above
    what is allocated after it, with its result alive), in bytes."""
    import torch
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    peak, after = torch.cuda.max_memory_allocated(device), torch.cuda.memory_allocated(device)
    del out
    return peak - before, peak - after


def phase_prune_timing(layer, counts, selecting, errs, wide_counts):
    """B7 and B8 (both modes) at one full-width w_in: times (median of 5
    queued runs), bounds and the kernels JSON entries; then prune_scored's
    old route (scored_args + tau-given B8) against its selecting route,
    split by CUDA events (medians of 20), torch.topk alone on the plain
    score matrix, and the peak allocation of one wanda call of each."""
    import torch
    from repro_torch.core import symwanda as sw
    from repro_torch.kernels import nm_prune, ops, ref, wanda_score

    W, X = layer
    device = W.device
    d_in, d_out = W.shape
    n = d_in * d_out
    es = W.element_size()
    k = ops.keep_count(d_in, 0.5)
    med = lambda fn, reps: statistics.median(queued_ms(fn, reps) for _ in range(5))
    ev = lambda fn: cuda_ms(fn, reps=20)
    rows = {}
    # per element: abs, the score's multiplies / divides / add, the compare
    # and the product
    score_ops = {"wanda": 4, "ria": 7, "symwanda": 10}

    def row(key, label, ms, plain_ms, nbytes, nops):
        t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * nops / F32_FLOPS
        rows[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations")
        log("timing", f"{label} ({d_in}x{d_out} {W.dtype}): {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, bound {rows[key]['bound_ms']:.4f} ms "
                      f"({rows[key]['bound_by']}, {nbytes / 1e6:.1f} MB, {nops / 1e9:.3f} G "
                      f"ops), {100 * rows[key]['bound_ms'] / ms:.1f}% of bound")

    for mode in B8_MODES:
        wp, kw, (r, c) = ops.scored_args(W, X, mode, 0.5)
        tau = kw.pop("tau")
        given = lambda: wanda_score.wanda_prune_2d(wp, tau=tau, **kw)
        select = lambda: wanda_score.wanda_prune_2d(wp, tau=None, k=k, rows=r, cols=c, **kw)
        # w read once, out and mask written once, the f32 statistics read
        # once; tau read (given) or written (selecting)
        vec = {"wanda": d_in + d_out,                  # xnorm, tau
               "ria": 2 * (d_in + d_out),              # + rowsum, colsum
               "symwanda": d_in + 2 * d_out}[mode]     # + ynorm
        nbytes = 3 * es * n + 4 * vec
        row(f"given {mode}", f"B8 wanda_prune_2d tau given {mode}", med(given, 20),
            med(lambda: ref.wanda_prune_ref(wp, tau=tau, **kw), 5), nbytes, score_ops[mode] * n)
        scores = ref.wanda_scores_ref(wp, **kw)
        compares, key = search_compares(scores, k)
        require(torch.equal((key & 0x7fffffff).to(torch.int32).view(torch.float32), tau),
                f"{mode}: the replayed search's k-th keys != torch.topk's tau")
        # + two operations (compare, add) for each compare of the search
        row(f"select {mode}", f"B8 wanda_prune_2d selecting {mode} ({compares / n:.2f} "
            f"search compares an element)", med(select, 20),
            med(lambda: ref.wanda_prune_ref(wp, tau=None, k=k, **kw), 5), nbytes,
            score_ops[mode] * n + 2 * compares)
        rows[f"select {mode}"]["topk_ms"] = ev(lambda: torch.topk(scores.T, k))
        del scores

        def old_route():
            wp_, kw_, (r_, c_) = ops.scored_args(W, X, mode, 0.5)
            out, mask = wanda_score.wanda_prune_2d(wp_, **kw_)
            return out[:r_, :c_], mask[:r_, :c_]

        new_route = lambda: ops.prune_scored(W, X, mode, 0.5)
        sp = ops._statistics(W, X, mode, 0.5, 0.5)
        split = {"statistics": ev(lambda: ops._statistics(W, X, mode, 0.5, 0.5)),
                 "scores+topk": ev(lambda: torch.topk(ref.wanda_scores_ref(W, **sp).T,
                                                       k).values[:, -1]),
                 "mask": ev(given), "old": ev(old_route),
                 "selecting": ev(select), "new": ev(new_route)}
        del sp
        log("timing", f"prune_scored {mode}: old route {split['old']:.4f} ms (statistics "
                      f"{split['statistics']:.4f} / plain scores + torch.topk "
                      f"{split['scores+topk']:.4f} / tau-given B8 {split['mask']:.4f}); new "
                      f"route {split['new']:.4f} ms (statistics {split['statistics']:.4f} / "
                      f"selecting B8 {split['selecting']:.4f}); torch.topk(scores.T, {k}) "
                      f"alone {rows[f'select {mode}']['topk_ms']:.4f} ms (CUDA events, "
                      f"medians of 20)")
        if mode == "wanda":
            for label, fn in (("old", old_route), ("new", new_route)):
                above, temp = peak_delta(device, fn)
                log("timing", f"prune_scored wanda, {label} route: peak allocation "
                              f"{above / 1e6:.1f} MB above the live tensors before the call, "
                              f"{temp / 1e6:.1f} MB above its result")

    S = sw.score_wanda(W, X)
    row("2:4", "B7 nm_prune_2d 2:4", med(lambda: nm_prune.nm_prune_2d(W, S, 2, 4), 20),
        med(lambda: ref.nm_prune_ref(W, S, 2, 4), 5),
        3 * es * n + 4 * n,                    # + the f32 scores
        17 * n)             # per element: 4 + 4 compares, their 8 adds, the product
    del S
    entries = []
    for (kid, name, replaces), key in zip(PRUNE_INFO, ("2:4", "select wanda")):
        # launches on both prune paths: the trained h2o-danube checkpoint and
        # the qwen1.5-4b ladder (every B8 launch of both selecting)
        entry = {"id": kid, "name": name, "route": "cuda", "source": PRUNE_SOURCE,
                 "replaces": replaces, "launches": counts[name] + wide_counts[name],
                 "launches_by_path": {f"prune {ARCH} (trained)": counts[name],
                                      f"prune {WIDE_ARCH}": wide_counts[name]},
                 "max_abs_err": errs[name], **{f: rows[key][f] for f in (
                     "ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None}
        if name == "wanda_prune_2d":
            # the prune path runs the selecting mode; both modes, every score
            # mode; torch.topk on the plain scores is the selection's yardstick
            entry["modes"] = {
                "selecting": {"launches": selecting + wide_counts[name],
                              **{m: rows[f"select {m}"]
                                                        for m in B8_MODES}},
                "tau_given": {"launches": counts[name] - selecting,
                              **{m: rows[f"given {m}"] for m in B8_MODES}}}
        entries.append(entry)
    return entries


def main():
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SmokeFailure(f"{SRC}/repro_torch not found: run from the repository")
    sys.path.insert(0, SRC)
    import torch
    smi = phase_device()
    device = torch.device("cuda", 0)
    from repro_torch.configs import get_config
    phase_build()
    phase_kernels(device)
    phase_lint(device)
    counts, rows, serve_payload_bytes = phase_serve(get_config(ARCH), device)
    for kid, name, _, _ in KERNEL_INFO + (DELTA_INFO,):
        require(counts[name] > 0, f"{kid} {name} was not launched on the main path")
    phase_ref(device)
    codec_counts, d = phase_codec(get_config(ARCH), device, serve_payload_bytes)
    for kid, name, _, _, _ in CODEC_INFO:
        require(codec_counts[name] > 0, f"{kid} {name} was not launched on the codec path")
    # the chain: train at full width, save the efbv run's params, prune them
    ckpt_dir = tempfile.mkdtemp()
    try:
        train_counts, saved = phase_train(get_config(ARCH), device,
                                          os.path.join(ckpt_dir, "ckpt"))
        for kid, name in (("B1", "quant_dequant_2d"), ("B2", "quant_pack_2d")):
            require(train_counts[name] > 0, f"{kid} {name} was not launched on the train path")
        prune_counts, selecting, prune_errs, layer = phase_prune(get_config(ARCH), device, saved)
    finally:
        shutil.rmtree(ckpt_dir)
    del saved
    gc.collect()
    for kid, name, _ in PRUNE_INFO:
        require(prune_counts[name] > 0, f"{kid} {name} was not launched on the prune path")
    wide_counts = phase_prune_wide(get_config(WIDE_ARCH), device)
    phase_paper(device)
    cohort_counts = phase_cohort(device, d, serve_payload_bytes)
    for kid, name in (("B2", "quant_pack_2d"), ("B3", "unpack_dequant_2d")):
        require(cohort_counts[name] > 0, f"{kid} {name} was not launched on the cohort path")
    arch_counts = phase_arch(device)
    for kid, name, _, _ in KERNEL_INFO + (DELTA_INFO,):
        require(arch_counts[name] > 0, f"{kid} {name} was not launched on the arch path")
    archtrain_counts = phase_archtrain(device)
    for kid, name, _, _ in KERNEL_INFO:
        require(archtrain_counts[name] > 0, f"{kid} {name} was not launched on the archtrain path")
    phase_longctx(device)
    dp_launches = phase_dp(device)
    require(dp_launches > 0, "B1 quant_dequant_2d was not launched on the dp path")
    phase_ep(device)
    phase_dryrun(device)
    # each kernel's launches on the paths that exercise it (B1: serve + train +
    # arch + archtrain + dp; B2: serve + train + cohort + arch + archtrain; B3:
    # serve + cohort + arch + archtrain)
    launches = {**counts, **{name: codec_counts[name] for _, name, _, _, _ in CODEC_INFO}}
    launches["quant_dequant_2d"] += dp_launches
    for name in ("quant_dequant_2d", "quant_pack_2d"):
        launches[name] += train_counts[name]
    for name in ("quant_pack_2d", "unpack_dequant_2d"):
        launches[name] += cohort_counts[name]
    for _, name, _, _ in KERNEL_INFO:
        launches[name] += arch_counts[name] + archtrain_counts[name]
    kernels = phase_timing(rows, device, launches)
    kernels += phase_mask_timing(d, device, launches)
    kernels += phase_prune_timing(layer, prune_counts, selecting, prune_errs, wide_counts)
    kernels.append(phase_delta_timing(device, counts["delta_apply"] + arch_counts["delta_apply"]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
