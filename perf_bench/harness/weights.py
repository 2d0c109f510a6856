"""Weights made by the benchmark from the seed, on the device, in the type
they are served in.

The leaves are described by the benchmark's own layout (``leaf_specs``),
derived from the configuration file alone: one ``LeafSpec`` per stacked
leaf, in sorted path order; the blocks' leaves come from the
configuration's family (``perf_bench/families/<family>.py``), built with
``mat`` and ``norm``.  That order is the flat vector the delta
compressor and the EF-BV sync quantize in 512-element rows, so the plain
reference works in the same flat space.  A driver checks that the program's
tree has exactly these paths, shapes and dtypes before it hands the weights
over.

All leaves of one dtype live in one flat buffer, drawn by one
``torch.randn`` call from a generator on the device and scaled leaf by leaf
in place; the program's tree is a set of views into those buffers.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch


def fold(*parts) -> int:
    """A 63-bit seed derived from any printable parts (the seed, a purpose,
    an index)."""
    h = hashlib.blake2b(":".join(str(p) for p in parts).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def generator(device, *parts) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(fold(*parts))
    return g


@dataclass(frozen=True)
class LeafSpec:
    path: str                 # "blocks/pos0/attn/wq"
    shape: Tuple[int, ...]    # stacked over layers for block leaves
    dtype: str                # "bfloat16" | "float32"
    init: str                 # normal | ones | zeros | a_log | const
    std: float = 0.0          # normal: the draw's std; const: the value
    pert: float = 0.0         # std of a user's personalization, before rel_scale

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def stacked(self) -> bool:
        return self.path.startswith("blocks/")


def padded_vocab(cfg: dict, multiple: int = 16) -> int:
    return -(-cfg["vocab_size"] // multiple) * multiple


def mat(cfg: dict, path: str, shape: Tuple[int, ...]) -> LeafSpec:
    """A weight (fan_in, fan_out) stacked over the layers: N(0, 1/fan_in),
    and a user's personalization of the same std."""
    std = 1.0 / math.sqrt(shape[0])
    return LeafSpec(path, (cfg["num_layers"],) + shape, cfg["dtype"], "normal", std, std)


def norm(cfg: dict, path: str, dim: int, stacked: bool = True) -> LeafSpec:
    """An RMSNorm scale of ones, stacked over the layers unless ``stacked``
    is false."""
    return LeafSpec(path, ((cfg["num_layers"],) if stacked else ()) + (dim,), cfg["dtype"],
                    "ones", 0.0, 1.0)


def leaf_specs(cfg: dict) -> List[LeafSpec]:
    """Every leaf of the configuration's model, sorted by path: the
    embedding, the final norm and an untied output matrix, and the blocks'
    leaves that ``perf_bench/families/<family>.py`` lays out."""
    from perf_bench.harness import bench

    dt, D, V = cfg["dtype"], cfg["d_model"], padded_vocab(cfg)
    # embeddings N(0, 1/d): unit-spread logits at any width (0.0198 at d 2560)
    emb = 1.0 / math.sqrt(D)
    specs = [LeafSpec("embed/tok", (V, D), dt, "normal", emb, emb),
             norm(cfg, "final_norm/scale", D, stacked=False)]
    specs += bench.load_py("families", cfg["family"]).block_leaves(cfg)
    if not cfg.get("tie_embeddings", False):
        specs.append(LeafSpec("embed/unembed", (D, V), dt, "normal", emb, emb))
    return sorted(specs, key=lambda s: s.path.split("/"))


def to_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class Weights:
    """One flat buffer per dtype, and each leaf's (dtype, offset) in it."""

    def __init__(self, specs: List[LeafSpec], buffers: Dict[str, torch.Tensor],
                 offsets: Dict[str, int]):
        self.specs = specs
        self.buffers = buffers
        self.offsets = offsets

    def leaf(self, s: LeafSpec) -> torch.Tensor:
        o = self.offsets[s.path]
        return self.buffers[s.dtype][o: o + s.numel].view(s.shape)

    def tree(self) -> dict:
        """The nested dict of views the program takes as its params."""
        out: dict = {}
        for s in self.specs:
            node = out
            *parents, last = s.path.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = self.leaf(s)
        return out

    def flat_f32(self) -> torch.Tensor:
        """Every leaf as f32, concatenated in path order (the flat space)."""
        d = sum(s.numel for s in self.specs)
        dev = next(iter(self.buffers.values())).device
        out = torch.empty(d, dtype=torch.float32, device=dev)
        o = 0
        for s in self.specs:
            out[o: o + s.numel].copy_(self.leaf(s).reshape(-1))
            o += s.numel
        return out

    def leaf_at(self, path: str) -> torch.Tensor:
        return self.leaf(next(s for s in self.specs if s.path == path))


def _layout(specs: List[LeafSpec]):
    sizes: Dict[str, int] = {}
    offsets: Dict[str, int] = {}
    for s in specs:
        offsets[s.path] = sizes.get(s.dtype, 0)
        sizes[s.dtype] = offsets[s.path] + s.numel
    return sizes, offsets


def _fill_special(w: Weights, s: LeafSpec) -> None:
    t = w.leaf(s)
    if s.init == "ones":
        t.fill_(1.0)
    elif s.init == "zeros":
        t.zero_()
    elif s.init == "const":
        t.fill_(s.std)
    elif s.init == "a_log":
        H = s.shape[-1]
        t.copy_(torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                         device=t.device)).expand(s.shape))


def make_weights(seed: int, cfg: dict, device) -> Weights:
    """The base model's weights from ``seed``: one normal draw per dtype
    buffer, each "normal" leaf scaled to its std in place."""
    specs = leaf_specs(cfg)
    sizes, offsets = _layout(specs)
    buffers = {dt: torch.randn(n, generator=generator(device, seed, "weights", dt),
                               dtype=to_dtype(dt), device=device)
               for dt, n in sizes.items()}
    w = Weights(specs, buffers, offsets)
    for s in specs:
        if s.init == "normal":
            w.leaf(s).mul_(s.std)
        else:
            _fill_special(w, s)
    return w


def personalize(base: Weights, seed: int, user: int, rel_scale: float,
                out: Weights = None) -> Weights:
    """User ``user``'s dense personalization: every leaf plus
    ``rel_scale * pert * N(0, 1)``, drawn per dtype buffer in one call and
    written into ``out`` (reused between users) or a new set of buffers."""
    if out is None:
        out = Weights(base.specs, {k: torch.empty_like(v) for k, v in base.buffers.items()},
                      base.offsets)
    for dt, buf in out.buffers.items():
        torch.randn(buf.shape, generator=generator(buf.device, seed, "user", user, dt),
                    dtype=buf.dtype, device=buf.device, out=buf)
    for s in base.specs:
        out.leaf(s).mul_(rel_scale * s.pert).add_(base.leaf(s))
    return out


def by_path(tree) -> Dict[str, torch.Tensor]:
    """The program's tree as {"blocks/pos0/attn/wq": leaf, ...}."""
    from repro_torch.utils.tree import tree_flatten_with_path

    flat, _ = tree_flatten_with_path(tree)
    return {k.strip("[]'").replace("']['", "/"): t for k, t in flat}


def check_program_tree(specs: List[LeafSpec], program_tree) -> None:
    """Raise unless the program's tree (``init_params`` on ``meta``) has
    exactly the benchmark's leaves: the same paths, shapes and dtypes."""
    theirs = [(k, tuple(t.shape), str(t.dtype).split(".")[-1])
              for k, t in by_path(program_tree).items()]
    ours = [(s.path, tuple(s.shape), s.dtype) for s in specs]
    if theirs != ours:
        diff = [(a, b) for a, b in zip(ours, theirs) if a != b][:4]
        raise RuntimeError(f"the program's params differ from the benchmark's layout: "
                           f"{len(ours)} vs {len(theirs)} leaves; first differences {diff}")
