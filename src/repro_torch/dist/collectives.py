"""Collectives of the ring and the pods on ``torch.distributed`` (port of
``repro.dist.collectives``, plus the ring's one-hop shift).

Every function takes the rank's :class:`RankLayout` and the name of one of
its groups (``"ring"``, ``"data"``, ``"model"``, ``"pod"``, ``"dp"``,
``"world"``): JAX's ``ppermute``/``psum``/``pmax``/``all_gather``/
``psum_scatter`` over a mesh axis become a ring shift, an
``all_reduce(SUM)``, an ``all_reduce(MAX)``, an ``all_gather`` and a
reduce-scatter over that group. A group of one rank makes each of them the
identity. Under gloo a CUDA tensor goes through a pinned host buffer (in
chunks of at most ``HOST_CHUNK`` elements), so gloo only ever sees host
tensors; under NCCL tensors stay on the card. Under gloo a reduce-scatter is
an ``all_reduce`` and the rank's slice (one path for every torch, whether
its gloo has ``reduce_scatter`` or not).

Ranks that share one card (gloo with ``ranks_per_device`` > 1, NCCL's
refusal): a CUDA tensor's sum, max and gather stay on the card. Each group
has a workspace a rank on the card that every rank of the group maps (CUDA
IPC, ``_CardGroup``): each rank copies its part into its own workspace, the
group meets at a barrier in host memory, and each rank reads every rank's
part, a sum taken in group order (bf16 and f16 in f32, rounded once), so
every rank holds the same bits. The workspace has two halves used in turn:
a rank writes a half again only after the group's next barrier, which a
rank reaches only once its reads of that half are done.

With gradients (the steps of the recsys, GNN and LM cells across ranks):
``psum`` is a sum whose result feeds compute that every rank of the group
repeats, so its backward is the identity (every rank already holds the
whole cotangent; summing it again would multiply the gradient by the group's
size); ``grad_psum`` is its conjugate (Megatron's "f" to ``psum``'s "g"):
the identity forward, where a replicated tensor enters compute that the
group's ranks split (a column-parallel product, a vocab-parallel head), and
the sum of the ranks' partial cotangents backward; ``all_gather_rows``
concatenates the group's row blocks and its backward is the reduce-scatter
of the cotangent (the gathered tensor feeds compute that differs from rank
to rank, as an FSDP weight does across data replicas);
``all_gather_replicated`` concatenates them for compute that every rank of
the group repeats, and its backward is the rank's own block of the cotangent;
``reduce_scatter_rows`` is the reduce-scatter and its backward the
``all_gather``. ``pmax`` is a max without a gradient.

``compressed_psum``: the JAX package sums the int8 payload as int16, which
neither gloo nor NCCL reduces. Here each rank all-gathers the int8 payload
and sums it locally in int16: the same values under the same 258-shard
bound, and one byte per element per rank on the wire (a quarter of f32).

Each collective is reported to an active ``dist.analysis.count_cost`` under
the name of its JAX primitive (``psum``, ``pmax``, ``all_gather``,
``reduce_scatter``, ``ppermute``) with its payload bytes, shape and dtype, groups of one rank included (JAX's
jaxpr holds a ``psum`` over an axis of size 1 too).
"""
from __future__ import annotations

import gc
import mmap
import os
import socket
import tempfile
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import prng
from repro_torch.dist import analysis
from repro_torch.dist.sharding import POD_AXIS, RankLayout, block_index

_Q_MAX = 127.0          # int8 symmetric range
_M32 = 0xFFFF_FFFF
# elements per host round trip of a CUDA tensor under gloo (256 MiB of int32)
HOST_CHUNK = 1 << 26
# bytes of one half of a rank's workspace for ranks that share a card
CARD_CHUNK = 1 << 25
CARD_TIMEOUT_S = 1800.0     # the longest a rank waits for its group at an exchange


def group_index(layout: RankLayout, name: str) -> int:
    """This rank's position in group ``name`` (its axis index)."""
    return layout.group(name)[1].index(layout.rank)


def _via_host(t: torch.Tensor, layout: RankLayout) -> bool:
    return t.is_cuda and layout.backend == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


class _CardGroup:
    """The workspaces of one group whose ranks share a card: this rank's
    [2 · CARD_CHUNK] bytes and every rank's, mapped here (``parts``, in
    group order); ``parts`` is None where the group's ranks are not all on
    one card of one host. The ranks meet at a barrier of host memory: one
    int64 a rank in a file that the group's first rank makes and every rank
    maps, the count of exchanges each has written (a gloo barrier goes
    through the sockets and gloo's threads). Built collectively,
    at the group's first collective of a CUDA tensor."""

    def __init__(self, group, ranks: List[int], me: int, device: torch.device):
        from torch.multiprocessing.reductions import reduce_tensor
        self.group, self.me, self.turn = group, me, 0
        self.buf = _ipc_empty(2 * CARD_CHUNK, device)
        where = (socket.gethostname(), str(torch.cuda.get_device_properties(device).uuid))
        path = None
        if me == 0:
            fd, path = tempfile.mkstemp(prefix="repro_torch_card_")
            os.ftruncate(fd, 8 * len(ranks))
            os.close(fd)
        # one share of the workspace for each other rank: each receiver gives its
        # own back when it lets go (torch counts a CUDA IPC share's receivers)
        shares = [None if i == me else reduce_tensor(self.buf) for i in range(len(ranks))]
        objs: List[Any] = [None] * len(ranks)
        dist.all_gather_object(objs, (where, shares, path), group=group)
        self.parts: Optional[List[torch.Tensor]] = None
        if all(w == where for w, _, _ in objs):
            self.parts = [self.buf if i == me else theirs[me][0](*theirs[me][1])
                          for i, (_, theirs, _) in enumerate(objs)]
            with open(objs[0][2], "r+b") as f:
                self._map = mmap.mmap(f.fileno(), 8 * len(ranks))
            self.counts = torch.frombuffer(self._map, dtype=torch.int64)
        dist.barrier(group=group)
        if path is not None:
            os.unlink(path)                 # the ranks' mappings outlive the name

    def exchange(self, src: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``src`` (uint8, at most CARD_CHUNK bytes, the same
        length on every rank), as views of the workspaces in group order;
        valid until this group's next exchange but one."""
        n = src.numel()
        base = (self.turn % 2) * CARD_CHUNK
        self.turn += 1
        self.buf[base:base + n].copy_(src)
        # the copy is done, and so are this rank's reads of the other half
        torch.cuda.current_stream(self.buf.device).synchronize()
        self.counts[self.me] = self.turn
        t0 = time.monotonic()
        while int(self.counts.min()) < self.turn:
            if time.monotonic() - t0 > CARD_TIMEOUT_S:
                raise RuntimeError(f"a rank of the group missed exchange {self.turn} for "
                                   f"{CARD_TIMEOUT_S:.0f} s")
            os.sched_yield()
        return [p[base:base + n] for p in self.parts]


def _ipc_empty(n: int, device: torch.device) -> torch.Tensor:
    """n bytes on the card in a segment of their own that CUDA IPC can share:
    with ``expandable_segments`` on, the caching allocator's segments are
    not such, so it is turned off around this allocation."""
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "") + "," + \
        os.environ.get("PYTORCH_ALLOC_CONF", "")
    if "expandable_segments:True" not in conf:
        return torch.empty(n, dtype=torch.uint8, device=device)
    with warnings.catch_warnings():          # deprecated for a new name in later torch
        warnings.simplefilter("ignore", FutureWarning)
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
        try:
            return torch.empty(n, dtype=torch.uint8, device=device)
        finally:
            torch.cuda.memory._set_allocator_settings("expandable_segments:True")


_CARD: Dict[Tuple[int, ...], _CardGroup] = {}


def _card(t: torch.Tensor, layout: RankLayout, name: str) -> Optional[_CardGroup]:
    """The group's card workspaces where ``t`` is a CUDA tensor and the
    group's ranks share its card (else None)."""
    if not (t.is_cuda and layout.backend == "gloo" and layout.ranks_per_device > 1):
        return None
    group, ranks = layout.group(name)
    key = tuple(ranks)
    if key not in _CARD:
        _CARD[key] = _CardGroup(group, ranks, ranks.index(layout.rank), t.device)
    cg = _CARD[key]
    return cg if cg.parts is not None else None


def release_card_workspaces() -> None:
    """Let go of the other ranks' workspaces, then of this rank's (every rank
    of the world calls it before the world ends)."""
    for cg in _CARD.values():
        cg.parts = None
    if _CARD:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.ipc_collect()
        dist.barrier()
    _CARD.clear()
    if torch.cuda.is_initialized():
        torch.cuda.ipc_collect()


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes, flat (uint8)."""
    return t.reshape(-1).view(torch.uint8)


def _card_reduce_(t: torch.Tensor, cg: _CardGroup, op: str) -> torch.Tensor:
    half = t.dtype in (torch.bfloat16, torch.float16)     # summed in f32, rounded once
    flat = _bytes(t)
    step = CARD_CHUNK - CARD_CHUNK % t.element_size()
    for lo in range(0, flat.numel(), step):
        part = flat[lo:lo + step]
        vals = [v.view(t.dtype) for v in cg.exchange(part)]
        acc = vals[0].to(torch.float32 if half else t.dtype, copy=True)
        for v in vals[1:]:
            if op == "sum":
                acc.add_(v)
            else:
                torch.maximum(acc, v, out=acc)
        part.view(t.dtype).copy_(acc)
    return t


def all_reduce_(t: torch.Tensor, layout: RankLayout, name: str, op: str = "sum") -> torch.Tensor:
    """In-place ``all_reduce`` of ``t`` over group ``name`` (``op``: sum or
    max); returns ``t``."""
    analysis.charge_collective({"sum": "psum", "max": "pmax"}[op], analysis.tensor_bytes(t),
                               t.shape, t.dtype)
    return _reduce_(t, layout, name, op)


def _reduce_(t: torch.Tensor, layout: RankLayout, name: str, op: str) -> torch.Tensor:
    group, ranks = layout.group(name)
    if len(ranks) == 1:
        return t
    cg = _card(t, layout, name)
    if cg is not None:
        return _card_reduce_(t, cg, op)
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
    cg = _card(t, layout, name)
    if cg is not None:
        out = torch.empty((len(ranks),) + tuple(t.shape), dtype=t.dtype, device=t.device)
        src = _bytes(t.contiguous())
        dst = _bytes(out).view(len(ranks), src.numel())
        for lo in range(0, src.numel(), CARD_CHUNK):
            for i, v in enumerate(cg.exchange(src[lo:lo + CARD_CHUNK])):
                dst[i, lo:lo + v.numel()] = v
        return out
    host = _via_host(t, layout)
    src = _host(t) if host else t.contiguous()
    outs = [torch.empty(src.shape, dtype=src.dtype, pin_memory=host) if host
            else torch.empty_like(src) for _ in ranks]
    dist.all_gather(outs, src, group=group)
    out = torch.empty((len(ranks),) + tuple(t.shape), dtype=t.dtype, device=t.device)
    for i, o in enumerate(outs):
        out[i].copy_(o)
    return out


def all_gather_v(t: torch.Tensor, layout: RankLayout, name: str) -> List[torch.Tensor]:
    """Every rank's ``t`` in group order, where the ranks' dim 0 may differ
    (trailing dims and dtype agree): the counts first, then the payloads
    padded to the longest, each cut back to its count."""
    counts = all_gather(torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device),
                        layout, name)[:, 0].tolist()
    most = max(counts)
    pad = t.new_zeros((most,) + tuple(t.shape[1:]))
    pad[:t.shape[0]] = t
    full = all_gather(pad, layout, name)
    return [full[i, :n] for i, n in enumerate(counts)]


def reduce_scatter(t: torch.Tensor, layout: RankLayout, name: str) -> torch.Tensor:
    """This rank's block of the group's sum of ``t``: ``t`` [n·k, ...] →
    [k, ...], the block at the rank's group index (JAX's ``psum_scatter``
    with ``tiled=True``). NCCL: ``reduce_scatter_tensor``; gloo: an
    ``all_reduce`` of a copy and the slice."""
    group, ranks = layout.group(name)
    n = len(ranks)
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split into {n} blocks")
    analysis.charge_collective("reduce_scatter", analysis.tensor_bytes(t), t.shape, t.dtype)
    if n == 1:
        return t.clone()
    k = t.shape[0] // n
    if layout.backend == "nccl":
        out = torch.empty((k,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
        return out
    me = ranks.index(layout.rank)
    total = _reduce_(t.contiguous().clone(), layout, name, "sum")
    return total[me * k:(me + 1) * k].clone()


def all_assemble(t: torch.Tensor, spec, layout: RankLayout) -> torch.Tensor:
    """The global tensor of which ``t`` is this rank's block under the
    layout ``spec`` (``sharding.local_view``'s), on every rank: each rank's
    block all_gathered over "world" and put in its place (the torch twin of
    ``sharding.assemble``; blocks that several ranks hold are equal)."""
    parts = all_gather(t.contiguous(), layout, "world")
    blocks = [block_index(spec, layout, r) for r in range(layout.world_size)]
    shape = [t.shape[d] * (blocks[0][d][0] if d < len(spec) else 1) for d in range(t.dim())]
    out = t.new_empty(shape)
    for r, blk in enumerate(blocks):
        out[tuple(slice(i * t.shape[d], (i + 1) * t.shape[d])
                  for d, (_, i) in enumerate(blk))] = parts[r]
    return out


# ------------------------------------------------- collectives with gradients ---


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, layout, name):
        return all_reduce_(t.clone(), layout, name)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(t: torch.Tensor, layout: RankLayout, name: str) -> torch.Tensor:
    """The sum of ``t`` over group ``name`` where it feeds compute that every
    rank of the group repeats (a row-sharded lookup, a loss): its gradient
    passes through unchanged. ``t`` is consumed: without a gradient to carry
    the sum is taken in its buffer."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _Psum.apply(t, layout, name)
    return all_reduce_(t, layout, name)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, layout, name):
        ctx.layout, ctx.name = layout, name
        return all_gather(t, layout, name).flatten(0, 1)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.layout, ctx.name), None, None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, layout, name):
        ctx.layout, ctx.name = layout, name
        return reduce_scatter(t, layout, name)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.layout, ctx.name).flatten(0, 1), None, None


class _GradPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, layout, name):
        ctx.layout, ctx.name = layout, name
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.layout, ctx.name), None, None


def grad_psum(t: torch.Tensor, layout: RankLayout, name: str) -> torch.Tensor:
    """``t`` itself, where it enters compute that the ranks of group ``name``
    split (each rank's heads, columns, experts or vocab slice): the gradient
    that reaches ``t`` is the sum over the group of the ranks' partial
    cotangents, so every rank holds the whole one (``psum``'s conjugate)."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _GradPsum.apply(t, layout, name)
    return t


def pmax(t: torch.Tensor, layout: RankLayout, name: str) -> torch.Tensor:
    """The elementwise max of ``t`` over group ``name`` (a new tensor; no
    gradient)."""
    return all_reduce_(t.detach().contiguous().clone(), layout, name, "max")


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, layout, name):
        ctx.index, ctx.k = group_index(layout, name), t.shape[0]
        return all_gather(t, layout, name).flatten(0, 1)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index * ctx.k:(ctx.index + 1) * ctx.k], None, None


def all_gather_replicated(t: torch.Tensor, layout: RankLayout, name: str) -> torch.Tensor:
    """The group's row blocks of ``t`` concatenated in group order, for
    compute that every rank of the group then repeats: its gradient is the
    rank's own block of the cotangent (every rank holds the same whole one)."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _GatherReplicated.apply(t, layout, name)
    return all_gather(t, layout, name).flatten(0, 1)


def gather_dim(t: torch.Tensor, layout: RankLayout, name: str, dim: int,
               replicated: bool = False) -> torch.Tensor:
    """``all_gather_rows`` (or, ``replicated``, ``all_gather_replicated``)
    of ``t``'s blocks along ``dim``."""
    gather = all_gather_replicated if replicated else all_gather_rows
    if dim == 0:
        return gather(t, layout, name)
    return gather(t.movedim(dim, 0), layout, name).movedim(0, dim)


def all_gather_rows(t: torch.Tensor, layout: RankLayout, name: str) -> torch.Tensor:
    """The group's row blocks of ``t`` concatenated in group order ([n·k,
    ...] from [k, ...] a rank); its gradient is the reduce-scatter of the
    cotangent (the rank's block of the group's summed cotangents)."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _GatherRows.apply(t, layout, name)
    return all_gather(t, layout, name).flatten(0, 1)


def reduce_scatter_rows(t: torch.Tensor, layout: RankLayout, name: str) -> torch.Tensor:
    """``reduce_scatter`` of ``t``; its gradient is the ``all_gather`` of the
    cotangent (each rank's block, concatenated)."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _ScatterRows.apply(t, layout, name)
    return reduce_scatter(t, layout, name)


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
