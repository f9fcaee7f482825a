"""Mesh-axis vocabulary, rank coordinates and layouts of the port's
process-per-device model (port of the ring/pod and recsys parts of
``repro.dist.sharding``).

The JAX package runs one controller over a ``("pod", "data", "model")``
mesh and splits each global array by a ``PartitionSpec``. The port runs one
process per mesh coordinate, numbered row-major as JAX's mesh::

    rank = pod · D · Pm + data · Pm + model

and each rank holds exactly the block that ``shard_map`` hands JAX's body
for that device (leading singleton dims included). A layout here is a tuple
with one entry per leading dim: ``None`` (whole), an axis name, or a tuple of
axis names (the dim split over their row-major product), the meaning of a
``PartitionSpec``. ``local_view`` cuts a rank's block out of a global array;
``assemble`` puts the blocks of every rank back together, so tests and
checkpoints speak the JAX package's global layout.

The flattened intra-pod axes ``("data", "model")`` form the diagonal ring of
the layer-1 sampler; with word-sharded model parallelism (``P > 1``) the ring
rotates over ``"data"`` only and ``"model"`` holds resident Φ row slices;
``"pod"`` carries the layer-2 configurations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

RING_AXES: Tuple[str, str] = ("data", "model")
POD_AXIS: str = "pod"
MESH_AXES: Tuple[str, str, str] = (POD_AXIS,) + RING_AXES


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """One rank's place in a (pods, data, model) mesh and the process groups
    it talks over. ``groups`` maps a group name (``"ring"``: the pod's
    flattened ring; ``"data"``: the pod's ranks of one model index;
    ``"model"``: the pod's ranks of one data index; ``"pod"``: the ranks of
    one (data, model) coordinate across pods; ``"dp"``: the (pod, data)
    ranks of one model index, JAX's ``dp_axes(multi_pod)``; ``"world"``) to
    ``(process group, its global ranks in group order)``; it is empty for a
    layout built only to cut or assemble views. ``backend`` is ``"gloo"``,
    ``"nccl"`` or ``"mirror"`` (``launch.mesh.mirror_ranks``: no process
    groups, every other rank holding this rank's values)."""

    pods: int
    data: int
    model: int
    rank: int = 0
    backend: str = "gloo"
    device: str = "cpu"
    ranks_per_device: int = 1
    groups: Any = dataclasses.field(default=None, compare=False, hash=False, repr=False)

    def __post_init__(self) -> None:
        for name in ("pods", "data", "model"):
            if getattr(self, name) < 1:
                raise ValueError(f"RankLayout.{name} must be >= 1")
        if not 0 <= self.rank < self.world_size:
            raise ValueError(f"rank {self.rank} outside a world of {self.world_size}")

    @property
    def world_size(self) -> int:
        return self.pods * self.data * self.model

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.pods, self.data, self.model)

    def coords(self, rank: Optional[int] = None) -> Tuple[int, int, int]:
        """(pod, data, model) of ``rank`` (default: this rank)."""
        r = self.rank if rank is None else rank
        return (r // (self.data * self.model), (r // self.model) % self.data, r % self.model)

    @property
    def pod_index(self) -> int:
        return self.coords()[0]

    @property
    def data_index(self) -> int:
        return self.coords()[1]

    @property
    def model_index(self) -> int:
        return self.coords()[2]

    def at(self, rank: int) -> "RankLayout":
        """The same mesh seen from ``rank`` (no groups)."""
        return dataclasses.replace(self, rank=rank, groups=None)

    def group(self, name: str):
        """(process group, global ranks in group order) of ``name``."""
        if not self.groups:
            raise RuntimeError("this RankLayout has no process groups (built without "
                               "launch.mesh.init_ranks)")
        return self.groups[name]

    @property
    def is_writer(self) -> bool:
        """Whether this rank writes logs, metrics, checkpoints and snapshots."""
        return self.rank == 0


def ring_size(layout: RankLayout) -> int:
    """Number of ranks on the flattened intra-pod ring."""
    return layout.data * layout.model


def ring_perm(n: int) -> List[Tuple[int, int]]:
    """The one-hop rotation of a ring of ``n`` (source, destination) pairs."""
    return [(i, (i + 1) % n) for i in range(n)]


def flat_ring_index(layout: RankLayout) -> int:
    """This rank's position on the flattened ring."""
    return layout.data_index * layout.model + layout.model_index


def data_ring_size(layout: RankLayout) -> int:
    """Ring length when the model axis holds resident Φ slices (= data size)."""
    return layout.data


def model_axis_size(layout: RankLayout) -> int:
    return layout.model


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


# ---------------------------------------------------------------- layouts ---


def ring_spec(*trailing: Any) -> tuple:
    """Leading dim split over the flattened ring."""
    return (RING_AXES, *trailing)


def pod_ring_spec(*trailing: Any) -> tuple:
    """[pods, ring, ...]: pod-leading, then ring-split."""
    return (POD_AXIS, RING_AXES, *trailing)


def pod_spec(*trailing: Any) -> tuple:
    """Leading dim split over pods only (per-configuration replicas)."""
    return (POD_AXIS, *trailing)


def wshard_spec(*trailing: Any) -> tuple:
    """Φ/alias-table layout of word-sharded sessions: coarse vocab shards over
    "data" (dim 0), row slices over "model" (dim 1)."""
    return (RING_AXES[0], RING_AXES[1], *trailing)


def wshard_stack_spec() -> tuple:
    """[S, M, P·capb] token stacks: data shards over "data", the bucket-major
    capacity dim over "model"."""
    return (RING_AXES[0], None, RING_AXES[1])


def pod_wshard_spec(*trailing: Any) -> tuple:
    return (POD_AXIS, RING_AXES[0], RING_AXES[1], *trailing)


def pod_wshard_stack_spec() -> tuple:
    return (POD_AXIS, RING_AXES[0], None, RING_AXES[1])


def replicated() -> tuple:
    return ()


def dp_axes(multi_pod: bool = False):
    """The data-parallel axis (or axes): batch dims shard over these."""
    return (POD_AXIS, RING_AXES[0]) if multi_pod else RING_AXES[0]


# ------------------------------------------ recsys: row-sharded tables ---


def recsys_param_specs(shapes: Any) -> dict:
    """Embedding tables row-shard over "model" (the Φ vocab-shard story,
    models/recsys.py); per-row linear terms follow their table; dense MLPs
    replicate (they are MB-scale)."""
    def spec(name: str, shape: Any) -> tuple:
        if name.endswith("table") or name == "linear_w":
            return ("model", *([None] * (len(shape) - 1)))
        return ()
    return {k: spec(k, v) for k, v in shapes.items()}


def recsys_batch_spec(multi_pod: bool = False) -> tuple:
    """[B, F] id/dense batches: batch over the data-parallel axes."""
    return (dp_axes(multi_pod), None)


def table_rows_spec() -> tuple:
    """[rows, D] candidate/embedding planes: rows over "model"."""
    return ("model", None)


# ------------------------- LM: FSDP over the data axes × TP over "model" ---


def lm_param_specs(cfg: Any) -> dict:
    """Specs matching ``models.transformer.param_shapes(cfg)``'s structure.

    Projection weights split their TP-natural dim over ``"model"`` (column
    parallel for wq/wk/wv/w1/w3, row parallel for wo/w2) and the shared
    ``d_model`` dim over ``"data"`` (FSDP); norm scales replicate; the
    embedding splits its vocab rows over ``"model"`` (vocab-parallel).
    """
    layers = {
        "ln1": (None, None), "ln2": (None, None),
        "wq": (None, "data", "model"),
        "wk": (None, "data", "model"),
        "wv": (None, "data", "model"),
        "wo": (None, "model", "data"),
    }
    if cfg.qk_norm:
        layers.update({"qnorm": (None, None), "knorm": (None, None)})
    if cfg.moe is None:
        layers.update({"w1": (None, "data", "model"),
                       "w3": (None, "data", "model"),
                       "w2": (None, "model", "data")})
    else:
        layers["moe_router"] = (None, None, None)
        if cfg.moe.moe_shard == "expert":
            ew = (None, "model", None, None)         # expert parallelism
            layers.update({"moe_w1": ew, "moe_w3": ew, "moe_w2": ew})
        else:                                        # per-expert tensor parallel
            layers.update({"moe_w1": (None, None, None, "model"),
                           "moe_w3": (None, None, None, "model"),
                           "moe_w2": (None, None, "model", None)})
        if cfg.moe.n_shared_experts:
            layers.update({"moe_sw1": (None, "data", "model"),
                           "moe_sw3": (None, "data", "model"),
                           "moe_sw2": (None, "model", "data")})
    specs = {"embed": ("model", None), "layers": layers, "ln_f": (None,)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, "model")
    return specs


def lm_batch_spec(multi_pod: bool = False) -> tuple:
    """[B, S] token batches: batch over the data-parallel axes."""
    return (dp_axes(multi_pod), None)


def lm_cache_spec(multi_pod: bool = False) -> tuple:
    """[L, B, S, KV, dh] KV cache: batch over dp, sequence over "model"
    (the assigned archs' KV head counts rarely divide 16, the sequence
    always does)."""
    return (None, dp_axes(multi_pod), "model", None, None)


def moe_expert_spec() -> tuple:
    """[E, C, d] dispatch buffer under expert parallelism: experts → "model"."""
    return ("model", None, None)


# ------------------------------ GNN: pure data parallelism over nodes/edges ---


def gnn_param_specs(shapes: Any) -> dict:
    """GraphSAGE weights are KB-scale: replicate everywhere."""
    return {k: () for k in shapes}


def gnn_rows_spec(multi_pod: bool = False) -> tuple:
    """Node/edge row arrays: rows split over every mesh axis."""
    return (((POD_AXIS,) if multi_pod else ()) + RING_AXES,)


def divisible_rows_spec(n: int, layout: "RankLayout", multi_pod: bool = False) -> tuple:
    """Row spec over the largest dp-first axis set whose product divides n
    (small row counts, e.g. per-graph labels, cannot always use the full
    ``gnn_rows_spec`` flattening)."""
    axes = ((POD_AXIS,) if multi_pod else ()) + RING_AXES
    sizes = {POD_AXIS: layout.pods, "data": layout.data, "model": layout.model}
    chosen: List[str] = []
    prod = 1
    for ax in axes:
        size = sizes[ax]
        if size > 1 and n % (prod * size) == 0:
            chosen.append(ax)
            prod *= size
    return (tuple(chosen),) if chosen else (None,)


def stack_spec(n_model_shards: int = 1) -> tuple:
    """Layout of the [S, M, cap] token stacks of a single-pod ring: split over
    the flattened ring, or with word sharding (``n_model_shards > 1``) over
    "data" and the capacity dim over "model"."""
    return wshard_stack_spec() if n_model_shards > 1 else ring_spec()


def row_slice(n_rows: int, layout: RankLayout, axis: str = "model") -> Tuple[int, int]:
    """[lo, hi) of this rank's contiguous block of ``n_rows`` rows split over
    ``axis`` (a row-sharded table: ``P(axis, None)``)."""
    size = dict(zip(MESH_AXES, layout.shape))[axis]
    if n_rows % size:
        raise ValueError(f"{n_rows} rows do not split into {size} blocks")
    idx = dict(zip(MESH_AXES, layout.coords()))[axis]
    per = n_rows // size
    return idx * per, (idx + 1) * per


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block(spec: Sequence, layout: RankLayout, rank: int, shape: Sequence[int]):
    """Per dim of ``spec``: (number of blocks, this rank's block index)."""
    sizes = dict(zip(MESH_AXES, layout.shape))
    coords = dict(zip(MESH_AXES, layout.coords(rank)))
    out = []
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        n = math.prod(sizes[a] for a in axes)
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coords[a]
        if shape[d] % n:
            raise ValueError(f"dim {d} of size {shape[d]} does not split into {n} blocks")
        out.append((n, idx))
    return out


def block_index(spec: Sequence, layout: RankLayout, rank: int) -> List[Tuple[int, int]]:
    """Per dim of ``spec``: (number of blocks, rank ``rank``'s block index)."""
    return _block(spec, layout, rank, [0] * len(spec))


def block_shape(shape: Sequence[int], spec: Sequence, layout: RankLayout,
                rank: Optional[int] = None) -> Tuple[int, ...]:
    """The shape of the block of a global array of ``shape`` that rank
    ``rank`` (default: the layout's own) holds under ``spec`` (JAX's
    ``NamedSharding.shard_shape``); raises where a split dim does not divide."""
    r = layout.rank if rank is None else rank
    blocks = _block(spec, layout, r, shape)
    return tuple(int(d) // blocks[i][0] if i < len(blocks) else int(d)
                 for i, d in enumerate(shape))


def local_view(x, spec: Sequence, layout: RankLayout, rank: Optional[int] = None):
    """The block of the global array ``x`` (numpy array or tensor) that rank
    ``rank`` (default: the layout's own) holds under ``spec``; a view, not a
    copy."""
    r = layout.rank if rank is None else rank
    sl = []
    for d, (n, idx) in enumerate(_block(spec, layout, r, x.shape)):
        size = x.shape[d] // n
        sl.append(slice(idx * size, (idx + 1) * size))
    return x[tuple(sl)]


def assemble(views: Sequence, spec: Sequence, layout: RankLayout):
    """The global array from every rank's block (``views[rank]``, numpy), the
    inverse of :func:`local_view`. Blocks that several ranks hold (dims not
    split over every axis) must agree; the first rank's is taken."""
    import numpy as np

    first = np.asarray(views[0])
    shape = list(first.shape)
    for d, (n, _) in enumerate(_block(spec, layout, 0, [0] * len(spec))):
        shape[d] *= n
    out = np.empty(shape, first.dtype)
    seen = set()
    for r, v in enumerate(views):
        v = np.asarray(v)
        key = tuple(idx for _, idx in _block(spec, layout, r, [0] * len(spec)))
        if key in seen:
            continue
        seen.add(key)
        sl = tuple(slice(idx * v.shape[d], (idx + 1) * v.shape[d])
                   for d, idx in enumerate(key))
        out[sl] = v
    return out
