"""Collectives of the ring and the pods on ``torch.distributed`` (port of
``repro.dist.collectives``, plus the ring's one-hop shift).

Every function takes the rank's :class:`RankLayout` and the name of one of
its groups (``"ring"``, ``"data"``, ``"model"``, ``"pod"``): JAX's
``ppermute``/``psum``/``pmax`` over a mesh axis become a ring shift, an
``all_reduce(SUM)`` and an ``all_reduce(MAX)`` over that group. A group of
one rank makes each of them the identity. Under gloo a CUDA tensor goes
through a pinned host buffer (in chunks of at most ``HOST_CHUNK`` elements),
so gloo only ever sees host tensors; under NCCL tensors stay on the card.

``compressed_psum``: the JAX package sums the int8 payload as int16, which
neither gloo nor NCCL reduces. Here each rank all-gathers the int8 payload
and sums it locally in int16: the same values under the same 258-shard
bound, and one byte per element per rank on the wire (a quarter of f32).

Each collective is reported to an active ``dist.analysis.count_cost`` under
the name of its JAX primitive (``psum``, ``pmax``, ``all_gather``,
``ppermute``) with its payload bytes, shape and dtype, groups of one rank included (JAX's
jaxpr holds a ``psum`` over an axis of size 1 too).
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import prng
from repro_torch.dist import analysis
from repro_torch.dist.sharding import POD_AXIS, RankLayout

_Q_MAX = 127.0          # int8 symmetric range
_M32 = 0xFFFF_FFFF
# elements per host round trip of a CUDA tensor under gloo (256 MiB of int32)
HOST_CHUNK = 1 << 26


def group_index(layout: RankLayout, name: str) -> int:
    """This rank's position in group ``name`` (its axis index)."""
    return layout.group(name)[1].index(layout.rank)


def _via_host(t: torch.Tensor, layout: RankLayout) -> bool:
    return t.is_cuda and layout.backend == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce_(t: torch.Tensor, layout: RankLayout, name: str, op: str = "sum") -> torch.Tensor:
    """In-place ``all_reduce`` of ``t`` over group ``name`` (``op``: sum or
    max); returns ``t``."""
    group, ranks = layout.group(name)
    analysis.charge_collective({"sum": "psum", "max": "pmax"}[op], analysis.tensor_bytes(t),
                               t.shape, t.dtype)
    if len(ranks) == 1:
        return t
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if not _via_host(t, layout):
        dist.all_reduce(t, rop, group=group)
        return t
    flat = t.view(-1)
    for lo in range(0, flat.numel(), HOST_CHUNK):
        part = flat[lo:lo + HOST_CHUNK]
        h = _host(part)
        dist.all_reduce(h, rop, group=group)
        part.copy_(h)
    return t


def all_gather(t: torch.Tensor, layout: RankLayout, name: str) -> torch.Tensor:
    """[n, *t.shape]: every rank's ``t`` in group order, on ``t``'s device."""
    group, ranks = layout.group(name)
    analysis.charge_collective("all_gather", analysis.tensor_bytes(t), t.shape, t.dtype)
    if len(ranks) == 1:
        return t[None].clone()
    src = _host(t) if _via_host(t, layout) else t.contiguous()
    outs = [torch.empty_like(src) for _ in ranks]
    dist.all_gather(outs, src, group=group)
    return torch.stack(outs).to(t.device)


class Shift:
    """One hop of a ring over group ``name`` (JAX's ``ppermute`` with
    ``ring_perm(n)``): each rank sends its tensors to the next rank of the
    group and receives the previous rank's. Constructing it starts the
    transfers; ``wait`` returns the received tensors on the senders' device,
    so the caller can sample in between."""

    def __init__(self, layout: RankLayout, name: str, tensors: List[torch.Tensor]):
        group, ranks = layout.group(name)
        for t in tensors:               # one transfer (a JAX ppermute) per tensor
            analysis.charge_collective("ppermute", analysis.tensor_bytes(t), t.shape, t.dtype)
        self._device = tensors[0].device
        if len(ranks) == 1:
            self._reqs, self._bufs = [], [t.clone() for t in tensors]
            return
        me = ranks.index(layout.rank)
        dst, src = ranks[(me + 1) % len(ranks)], ranks[(me - 1) % len(ranks)]
        host = _via_host(tensors[0], layout)
        sends = [_host(t) if host else t.contiguous() for t in tensors]
        self._bufs = [torch.empty_like(s) for s in sends]
        ops = [dist.P2POp(dist.isend, s, dst, group, tag=i) for i, s in enumerate(sends)]
        ops += [dist.P2POp(dist.irecv, b, src, group, tag=i) for i, b in enumerate(self._bufs)]
        self._sends = sends          # alive until the sends complete
        self._reqs = dist.batch_isend_irecv(ops)

    def wait(self) -> List[torch.Tensor]:
        for r in self._reqs:
            r.wait()
        self._sends = None
        return [b.to(self._device) for b in self._bufs]


def shift(layout: RankLayout, name: str, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """:class:`Shift` posted and waited for at once."""
    return Shift(layout, name, tensors).wait()


# ------------------------------------------------------ cross-pod merges ---


def quantize(x: torch.Tensor, scale: torch.Tensor, seed: int, shard: int, leaf: int,
             offset: int = 0) -> torch.Tensor:
    """int8 stochastic rounding of ``x / scale`` (f32), the JAX package's
    per-leaf step: uniforms from ``prng.uniform01(seed, counter, shard ·
    0x85EBCA6B + leaf · 0xC2B2AE35)`` with element counters starting at
    ``offset`` (a chunk of a leaf passes its first flat index)."""
    scaled = x / scale
    floor = torch.floor(scaled)
    counters = (torch.arange(x.numel(), dtype=torch.int64, device=x.device) + offset) & _M32
    salt = (shard * 0x85EB_CA6B + leaf * 0xC2B2_AE35) & _M32
    u = prng.uniform01(seed & _M32, counters.view(x.shape), salt)
    q = floor + (u < scaled - floor).to(torch.float32)
    return torch.clamp(q, -_Q_MAX, _Q_MAX).to(torch.int8)


def shared_scale(amax: torch.Tensor, layout: RankLayout, axis: str) -> torch.Tensor:
    """The f32 scale the shards of ``axis`` share: pmax of |x| over 127
    (1 where every shard is zero)."""
    amax = all_reduce_(amax.to(torch.float32).reshape(1).clone(), layout, axis, "max")[0]
    return torch.where(amax > 0, amax / _Q_MAX, torch.ones((), device=amax.device))


def sum_payload(q: torch.Tensor, layout: RankLayout, axis: str) -> torch.Tensor:
    """Σ over ``axis`` of the int8 payloads, as int16: all-gathered, summed
    locally."""
    return all_gather(q, layout, axis).to(torch.int16).sum(dim=0, dtype=torch.int16)


def compressed_psum(tree: Any, layout: RankLayout, axis: str, seed: int = 0) -> Any:
    """psum of a float pytree (tensor, or dict/list/tuple of tensors) over
    ``axis`` with an int8-quantized payload; the JAX package's values.

    Per leaf: scale = pmax(|leaf|)/127 shared across the axis, stochastic
    rounding decorrelated per leaf, shard and ``seed``, int16 sum of the int8
    payloads, rescale. Unbiased: E[result] is the exact psum. Pass a fresh
    ``seed`` per aggregation boundary.
    """
    me = group_index(layout, axis)
    leaves, rebuild = _flatten(tree)
    out = []
    for i, leaf in enumerate(leaves):
        x = leaf.to(torch.float32)
        scale = shared_scale(x.abs().max() if x.numel() else torch.zeros((), device=x.device),
                             layout, axis)
        total = sum_payload(quantize(x, scale, seed, me, i), layout, axis)
        out.append(total.to(torch.float32) * scale)
    return rebuild(out)


def elastic_aggregate(state: Any, state_ref: Any, live, layout: RankLayout,
                      axis: str = POD_AXIS) -> Tuple[Any, int]:
    """Merge Δ = state − state_ref over the live shards of ``axis``, in place
    on ``state``'s leaves (integer or float tensors): a dead shard's Δ is
    dropped and every shard, dead ones included, gets ref + Σ live Δ.
    ``live`` is this shard's flag (nonzero = alive). Returns (state, number
    of live shards)."""
    alive = bool(live)
    leaves, rebuild = _flatten(state)
    refs, _ = _flatten(state_ref)
    for s, r in zip(leaves, refs):
        s.sub_(r)
        if not alive:
            s.zero_()
        all_reduce_(s, layout, axis)
        s.add_(r)
    n = torch.tensor([int(alive)], dtype=torch.int32,
                     device=leaves[0].device if leaves else "cpu")
    return rebuild(leaves), int(all_reduce_(n, layout, axis)[0])


def _flatten(tree):
    """(leaves, rebuild) of a tensor or a dict/list/tuple of tensors (dicts
    in sorted-key order, as JAX flattens them)."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda xs: xs[0]
    if isinstance(tree, dict):
        keys = sorted(tree)
        return [tree[k] for k in keys], lambda xs: dict(zip(keys, xs))
    return list(tree), lambda xs: type(tree)(xs)
