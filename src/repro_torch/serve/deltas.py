"""Per-user personalized deltas stored as wire payloads (port of
``repro/serve/deltas.py``).

The store keeps ONE base model, as f32 blocks on the device, plus, per user,
the wire payload of a compressed delta (host numpy planes, what a parameter
server would hold).  Deltas live in the bucketized block space of
``comm.buckets``; blocks are the pool's page unit.

Certification: ``delta_from_params`` refuses a payload unless
``decode(payload)`` equals the compressor's own carrier element for element.
With ``qsgd_kernel`` the payload comes from kernel B2, the carrier from
kernel B1 and, on the card, the decode from kernel B3, so every ``put``
holds the three kernels to each other.  ``put`` charges ``serve/page_out``;
the pool charges ``serve/page_in`` on a miss.

Randomness: a user's stochastic rounding draws from a generator seeded with
``user_seed(seed, uid)``, made fresh for the encode and for the carrier so
both see the same noise; tests inject the JAX package's draw with ``noise=``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch

from repro_torch.comm.buckets import BucketLayout, bucketize, debucketize
from repro_torch.comm.codecs import Payload, decode, encode
from repro_torch.comm.ledger import PAGE_OUT_TAG, CommLedger
from repro_torch.core.compressors import Compressor, make_compressor
from repro_torch.utils.device import fold_seed, make_generator
from repro_torch.utils.tree import tree_flatten_with_path, tree_unflatten

# Delta-block coordinates per page: a multiple of every codec granule
# (quantizer blocks 512/2048, QBLOCK rows), so pages align with wire planes.
DEFAULT_BLOCK = 4096


class DeltaCertificationError(RuntimeError):
    """decode(payload) disagreed with the compressor's carrier."""


def user_seed(seed: int, user_id: int) -> int:
    """The per-user compression seed, deterministic in (seed, user)."""
    return fold_seed(seed, user_id)


def delta_from_params(base_blocks: torch.Tensor, layout: BucketLayout,
                      personalized, compressor: Compressor,
                      seed: Optional[int] = None,
                      noise: Optional[torch.Tensor] = None) -> Payload:
    """Diff ``personalized`` against the base in block space, compress, pack,
    and certify: the payload's decode equals ``compressor(delta)`` or this
    raises :class:`DeltaCertificationError`.  ``noise`` (if given) feeds both
    the encode and the carrier; else each draws from a fresh generator
    seeded with ``seed``."""
    pers_blocks, p_layout = bucketize(personalized, layout.bucket_size)
    if p_layout.shapes != layout.shapes:
        raise ValueError("personalized tree shape mismatch vs base: "
                         f"{p_layout.shapes} != {layout.shapes}")
    delta = pers_blocks.sub_(base_blocks).reshape(-1)   # in place: ours
    device = delta.device

    def gen():
        return None if seed is None else make_generator(seed, device)

    payload = encode(compressor, delta, noise=noise, generator=gen())
    carrier = compressor(delta, noise=noise, generator=gen())
    del delta, pers_blocks
    decoded = decode(payload, device=device)
    # elementwise exact (a quant decode may emit +0.0 where the carrier has
    # -0.0: equal), the same certificate as the JAX package's
    ok = decoded.shape == carrier.shape and bool((decoded == carrier).all())
    if not ok:
        raise DeltaCertificationError(
            f"decode(encode(delta)) != compressor carrier for {compressor.name}")
    return payload


def delta_blocks(payload: Payload, layout: BucketLayout, device=None) -> torch.Tensor:
    """Decode a stored payload to ``(n_blocks, block_size)`` f32 blocks."""
    return decode(payload, device=device).float().reshape(
        layout.n_buckets, layout.bucket_size)


def params_from_delta(base_blocks: torch.Tensor, layout: BucketLayout,
                      payload: Payload, dtype=None):
    """Materialize the personalized tree: debucketize(base + delta).  The
    engine never does this per request; it is the oracle the delta path is
    certified against, and the export path."""
    eff = base_blocks + delta_blocks(payload, layout, base_blocks.device)
    return debucketize(eff, layout, dtype=dtype)


class DeltaStore:
    """Base blocks (device) + per-user payloads (host) + the byte ledger."""

    def __init__(self, base_params, compressor: Optional[Compressor] = None,
                 block_size: int = DEFAULT_BLOCK, seed: int = 0,
                 ledger: Optional[CommLedger] = None):
        self.base_blocks, self.layout = bucketize(base_params, block_size)
        self.device = self.base_blocks.device
        self.compressor = compressor or make_compressor("top_k", k_frac=0.01)
        self.seed = int(seed)
        self.ledger = ledger if ledger is not None else CommLedger()
        self._payloads: Dict[int, Payload] = {}
        self._events = 0

    def user_seed(self, uid: int) -> int:
        return user_seed(self.seed, uid)

    def __contains__(self, uid: int) -> bool:
        return int(uid) in self._payloads

    def __len__(self) -> int:
        return len(self._payloads)

    def user_ids(self) -> List[int]:
        return sorted(self._payloads)

    def put(self, uid: int, personalized_params,
            noise: Optional[torch.Tensor] = None) -> Payload:
        """Store user ``uid``'s model as a certified compressed delta."""
        uid = int(uid)
        payload = delta_from_params(self.base_blocks, self.layout,
                                    personalized_params, self.compressor,
                                    seed=self.user_seed(uid), noise=noise)
        return self.put_payload(uid, payload)

    def put_payload(self, uid: int, payload: Payload) -> Payload:
        """Store a pre-encoded delta payload (e.g. straight off the uplink)."""
        uid = int(uid)
        self._payloads[uid] = payload
        self.ledger.record(self._events, f"trainer->store/u{uid}",
                           payload.nbytes, kind="inter", tag=PAGE_OUT_TAG)
        self._events += 1
        return payload

    def payload(self, uid: int) -> Payload:
        return self._payloads[int(uid)]

    def nbytes(self, uid: int) -> int:
        return self._payloads[int(uid)].nbytes

    def blocks(self, uid: int) -> torch.Tensor:
        """Decoded ``(n_blocks, block_size)`` delta blocks, on the device."""
        return delta_blocks(self._payloads[int(uid)], self.layout, self.device)

    def personalized_params(self, uid: int, dtype=None):
        """Materialize the user's full tree (oracle / export path)."""
        return params_from_delta(self.base_blocks, self.layout,
                                 self._payloads[int(uid)], dtype=dtype)

    def total_payload_bytes(self) -> int:
        return sum(p.nbytes for p in self._payloads.values())


def personalize_leaves(base_params, seed: int, match: Iterable[str] = ("norm",),
                       scale: float = 0.05):
    """FedP3-style layer personalization: perturb only the leaves whose path
    mentions one of ``match``; every other leaf is the base tensor itself
    (shared, not copied).  Leaf i's noise draws from a generator seeded with
    ``fold_seed(seed, i)``.  A bench/test generator, not a training path."""
    flat, treedef = tree_flatten_with_path(base_params)
    pats = tuple(str(m).lower() for m in match)
    leaves = []
    for i, (name, leaf) in enumerate(flat):
        if any(p in name.lower() for p in pats):
            gen = make_generator(fold_seed(seed, i), leaf.device)
            noise = torch.randn(leaf.shape, generator=gen, dtype=torch.float32,
                                device=leaf.device)
            leaf = (leaf.float() + scale * noise).to(leaf.dtype)
        leaves.append(leaf)
    return tree_unflatten(treedef, leaves)
