"""Cost counting and the analytic byte reports (port of
``repro.dist.analysis``).

``count_cost(fn, *args)`` is the counterpart of JAX's ``trace_cost``: where
JAX walks the jaxpr of ``fn``, the port runs ``fn`` once under a
``TorchDispatchMode`` and counts every aten op that reaches it, forward and
backward alike (autograd hands the mode its backward ops too, so hold the
mode around the whole step and each product counts once):

- **flops**: matrix products only, 2·batch·m·n·contract for ``mm``,
  ``addmm``, ``bmm``, ``baddbmm`` (and ``mv``, ``addmv``, ``dot``), which
  is what ``einsum``, ``matmul`` and ``linear`` decompose to: the rule of
  JAX's ``_dot_flops``, which counts ``dot_general`` only;
- **bytes**: every op's tensor inputs plus outputs, as JAX's ``_eqn_bytes``
  (a sparse tensor counts its indices and values);
- **moved_bytes**: what the ops move through memory, the roofline's memory
  term: a view moves nothing, a gather (``index_select``, ``index``,
  ``gather``, ``embedding``) reads its indices and writes its output, not
  the whole source, and a scatter into a tensor (``index_copy_``,
  ``index_put_``, ``index_add_``, ``scatter_``…) reads its indices and
  source and writes as much; every other op its inputs plus outputs (eager
  ops are not fused);
- **kernels**: the port's own CUDA kernels are called through ``ctypes`` and
  no mode sees them. Each ``kernels/*/ops.py`` wrapper runs its body inside
  :func:`kernel_call`, which hides the body's aten ops from the count (the
  plain version on the CPU, the allocations around a launch on the card)
  and charges the bytes the kernel must move, by name, so the CPU and the
  card count the same;
- **collectives**: ``dist/collectives.py`` reports each collective it
  issues by JAX's primitive name (``psum``, ``pmax``, ``all_gather``,
  ``ppermute``) with its payload bytes, shape and dtype, in place of JAX's parse of compiled
  HLO (``collective_bytes``, ``hlo_collective_counts``), which torch has no
  counterpart of and which is not ported.

``sampler_epoch_bytes`` and ``model_shard_report`` are pure Python, copied
formula for formula from the JAX package (DESIGN.md §9, §10).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    moved_bytes: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(default_factory=dict)
                                   # JAX primitive name → calls
    collective_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
                                   # JAX primitive name → payload bytes
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
                                   # kernel name → {"calls", "bytes"} charged
    collective_log: List[Tuple[str, Tuple[int, ...], str, float]] = dataclasses.field(
        default_factory=list)      # each collective in order: (JAX primitive name,
                                   # payload shape, dtype, bytes)


# the costs being counted, innermost last; kernel bodies hide their aten ops
# from them while ``_hidden`` is above 0
_active: List[Cost] = []
_hidden = [0]

_aten = torch.ops.aten
_MM = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default,
       _aten.mv.default, _aten.addmv.default, _aten.dot.default}


_GATHER = {_aten.index_select.default, _aten.index.Tensor, _aten.gather.default,
           _aten.embedding.default, _aten.take.default}
_SCATTER = {_aten.index_copy_.default, _aten.index_copy.default, _aten.index_put_.default,
            _aten.index_put.default, _aten.index_add_.default, _aten.index_add.default,
            _aten.scatter_.src, _aten.scatter.src, _aten.scatter_add_.default,
            _aten.scatter_add.default, _aten._index_put_impl_.default}


def _mm_flops(func, args) -> float:
    """2·batch·m·n·contract of one matrix product (the bias of ``addmm``,
    ``baddbmm`` and ``addmv`` is not a product)."""
    a, b = (args[1], args[2]) if func in (_aten.addmm.default, _aten.baddbmm.default,
                                          _aten.addmv.default) else (args[0], args[1])
    if func in (_aten.dot.default,):
        return 2.0 * a.shape[0]
    if func in (_aten.mv.default, _aten.addmv.default):
        return 2.0 * a.shape[0] * a.shape[1]
    if func in (_aten.bmm.default, _aten.baddbmm.default):
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def tensor_bytes(t: torch.Tensor) -> float:
    """Bytes of ``t``'s elements (a sparse COO tensor: its indices and
    values)."""
    if t.is_sparse:
        return float(t._indices().numel() * t._indices().element_size()
                     + t._values().numel() * t._values().element_size())
    return float(t.numel() * t.element_size())


def _bytes(tree) -> float:
    return sum(tensor_bytes(x) for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor))


def _is_view(func) -> bool:
    """Whether ``func`` returns a view of an argument (it moves nothing)."""
    v = getattr(func, "is_view", None)
    if v is None:
        v = any(a.alias_info is not None and not a.alias_info.is_write
                for a in func._schema.arguments)
    return bool(v)


def _moved_bytes(func, args, kwargs, out) -> float:
    if _is_view(func):
        return 0.0
    if func in _GATHER:
        return _bytes((args[1:], kwargs)) + _bytes(out)
    if func in _SCATTER:
        return 2.0 * _bytes((args[1:], kwargs))
    return _bytes((args, kwargs)) + _bytes(out)


class _Counter(TorchDispatchMode):
    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _hidden[0]:
            if func in _MM:
                self.cost.flops += _mm_flops(func, args)
            self.cost.bytes += _bytes((args, kwargs)) + _bytes(out)
            self.cost.moved_bytes += _moved_bytes(func, args, kwargs, out)
        return out


def _counted(per_op: bool, fn: Callable[..., Any], *args: Any, **kwargs: Any):
    cost = Cost()
    _active.append(cost)
    try:
        with (_Counter(cost) if per_op else contextlib.nullcontext()):
            out = fn(*args, **kwargs)
    finally:
        _active.pop()
    return cost, out


def count_cost(fn: Callable[..., Any], *args: Any, **kwargs: Any):
    """Run ``fn(*args, **kwargs)`` once and count its cost. Returns
    ``(Cost, fn's result)``: unlike JAX's abstract trace this executes, so
    the arguments are real tensors (data-dependent ops need their values)."""
    return _counted(True, fn, *args, **kwargs)


def count_collectives(fn: Callable[..., Any], *args: Any, **kwargs: Any):
    """``count_cost`` without the per-op count: ``(Cost, fn's result)``
    where the Cost holds the collectives (and the kernels' calls) of one run
    of ``fn`` and its flops and op bytes stay 0, so the run is timed as it
    is (the dispatch mode of ``count_cost`` sees every aten op)."""
    return _counted(False, fn, *args, **kwargs)


def in_kernel() -> bool:
    """Whether the ops running now are the body of a hand-written kernel's
    wrapper under an active count (hidden from it)."""
    return bool(_hidden[0])


@contextlib.contextmanager
def kernel_call(name: str):
    """Around a hand-written kernel's wrapper: hide the aten ops of its body
    from an active count and charge ``charge(name, bytes)`` instead. Yields
    a function that takes the kernel's bytes (call it once the output
    shapes are known); without an active count both are no-ops."""
    if not _active:
        yield lambda nbytes: None
        return
    charged = []
    _hidden[0] += 1
    try:
        yield charged.append
    finally:
        _hidden[0] -= 1
    for nbytes in charged:
        for cost in _active:
            k = cost.kernels.setdefault(name, {"calls": 0.0, "bytes": 0.0})
            k["calls"] += 1
            k["bytes"] += float(nbytes)
            cost.bytes += float(nbytes)
            cost.moved_bytes += float(nbytes)


def charge_collective(kind: str, nbytes: float, shape: Sequence[int] = (),
                      dtype: Optional[Any] = None) -> None:
    """Record one collective of JAX primitive name ``kind`` moving
    ``nbytes`` of payload from this rank, a tensor of ``shape`` and
    ``dtype`` (the sharding audit reads them, ``analysis.shardcheck``)."""
    for cost in _active:
        cost.collectives[kind] = cost.collectives.get(kind, 0.0) + 1
        cost.collective_bytes[kind] = cost.collective_bytes.get(kind, 0.0) + float(nbytes)
        cost.collective_log.append((kind, tuple(int(d) for d in shape),
                                    str(dtype).replace("torch.", ""), float(nbytes)))


# ------------------------------------------------------ analytic reports ---


def sampler_epoch_bytes(n_tokens: float, n_topics: int, k_d: float,
                        n_mh: int = 4, vocab: int | None = None,
                        rebuild_epochs: int = 1) -> Dict[str, float]:
    """Analytic per-epoch HBM traffic of the two sampler families (§9).

    The dense plane scan streams three f32 [T, K] planes per token block
    (phi rows, psi broadcast, theta rows) and writes [T] ids — per-token
    traffic ≈ 3·K·4 B regardless of sparsity. The alias-MH probe reads the
    doc's (topic, count) pair rows once per doc proposal (⌈n_mh/2⌉ of the
    n_mh steps) plus O(1) scalar gathers per probe (phi/psi/alpha/table
    entries for proposal + acceptance), so per-token traffic ≈
    ⌈n_mh/2⌉·2·k_d·4 + n_mh·10·4 B. Word-table rebuilds stream the full
    [V, K] phi once and write three table planes — amortized over
    ``rebuild_epochs`` epochs (the aggregation-boundary cadence).

    Returns dense / alias_sample / alias_rebuild / alias (total) bytes per
    epoch plus the dense:alias ratio — the number ``launch/dryrun.py``
    prints next to each lda_train cell so ``--sampler`` choices are visible
    before a run.
    """
    dense = float(n_tokens) * 3.0 * n_topics * 4.0
    per_token = (math.ceil(n_mh / 2) * 2.0 * k_d * 4.0
                 + float(n_mh) * 10.0 * 4.0)
    alias_sample = float(n_tokens) * per_token
    alias_rebuild = 0.0
    if vocab:
        # read int32 phi once, write f32 wq/wp + int32 wa
        alias_rebuild = float(vocab) * n_topics * 4.0 * 4.0 / max(
            1, rebuild_epochs)
    total = alias_sample + alias_rebuild
    return {
        "dense_bytes_per_epoch": dense,
        "alias_sample_bytes_per_epoch": alias_sample,
        "alias_rebuild_bytes_per_epoch": alias_rebuild,
        "alias_bytes_per_epoch": total,
        "dense_over_alias": dense / total if total else float("inf"),
    }


def model_shard_report(n_topics: int, vocab: int, data_shards: int,
                       model_shards: int, n_tokens: float,
                       docs_per_shard: int = 0, doc_topic_cap: int = 0
                       ) -> Dict[str, float]:
    """Analytic per-device HBM + rotation traffic under word-sharded model
    parallelism (DESIGN.md §10).

    The ring over ``data_shards = M`` devices splits Φ into M vocab shards;
    ``model_shards = P`` further splits each shard's rows into P resident
    slices, so per-device model state is ``V·K / (M·P)`` rows × 16 B (int32
    Φ + f32 wq + f32 wp + int32 wa — the alias path; the dense path carries
    only the 4 B Φ plane). Doc-side state (θ pairs) stays data-parallel —
    unchanged by P.

    Rotation traffic per device per epoch: every resident token's 4-plane
    metadata (wl, dl, uid + the z re-ship) makes M one-hop shifts around
    the data ring (``16·n_tokens/(M·P)·M = 16·n_tokens/P`` B), and each
    round's θ/pair reconstruction gathers 2 planes over P−1 model-axis hops
    (``8·(P−1)·n_tokens/P`` B) plus a K-sized ψ resync all_reduce per
    round. P divides the data-ring term too (each device now rotates only
    its slice's bucket), so total link bytes stay within ~1.5× of
    replicated at any P while model HBM shrinks ~P×.
    """
    M, P = int(data_shards), int(max(1, model_shards))
    rows_dev = -(-int(vocab) // (M * P))
    phi_b = rows_dev * n_topics * 4.0
    tables_b = rows_dev * n_topics * 12.0
    theta_b = (float(docs_per_shard) * 2.0 * doc_topic_cap * 4.0
               if doc_topic_cap else float(docs_per_shard) * n_topics * 4.0)
    tok_dev = float(n_tokens) / (M * P)        # resident tokens per device
    stack_b = tok_dev * 4.0 * 4.0
    rot_data = 16.0 * float(n_tokens) / P      # M hops × 4 planes × 4 B
    rot_model = 8.0 * (P - 1) * float(n_tokens) / P
    rot_psi = M * (P if P > 1 else 1) * n_topics * 4.0 * 2.0
    return {
        "data_shards": float(M), "model_shards": float(P),
        "phi_bytes_per_device": phi_b,
        "tables_bytes_per_device": tables_b,
        "theta_bytes_per_device": theta_b,
        "stack_bytes_per_device": stack_b,
        "hbm_bytes_per_device": phi_b + tables_b + theta_b + stack_b,
        "rotation_data_bytes_per_epoch": rot_data,
        "rotation_model_bytes_per_epoch": rot_model,
        "rotation_psi_bytes_per_epoch": rot_psi,
        "rotation_bytes_per_epoch": rot_data + rot_model + rot_psi,
    }
