"""Cell builders: (architecture × input shape × layout) → a runnable step
(port of the recsys half of ``repro.configs.base``; the LDA cells are in
``configs/peacock_lda.py``).

A ``Cell`` holds the step function, a maker of its arguments (real inputs
and state drawn on a device from a generator, or empty ``meta`` tensors of
the same shapes, where JAX's cell holds ``ShapeDtypeStruct`` stand-ins), the
layout spec of each argument (JAX's in_shardings, in the port's tuple idiom
of ``dist/sharding.py``) and the analytic MODEL_FLOPS. It has no ``lower``:
PyTorch runs eagerly. The dry run (``launch/dryrun.py``) cuts the global
arguments to one rank's bytes with the specs.

Step functions by shape kind:
  train_*      → recsys train step: fwd + bwd, SGD on the table rows a batch
                 touches, AdamW on the dense parameters
  serve_*      → recsys batch forward; retrieval_cand → streamed top-k scoring
  (LDA)        → one rank's ring Gibbs epoch / RT-LDA serving batch

A recsys cell of more than one rank is built (its specs and formulas are
what the dry run records) but its step raises: the row-sharded recsys step
across ranks is not ported (ROADMAP item 13b, "Open from it"). The LM and
GNN halves are not ported (ROADMAP items 13e, 13d).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.models import recsys as rec_mod
from repro_torch.optim.adamw import AdamW


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    step_kind: str                 # train | serve | retrieval | lda_train | lda_serve
    fn: Callable
    make_args: Callable[..., Tuple[Any, ...]]
                                   # (generator, device, params=None) → fn's
                                   # global args (device "meta": empty stand-ins)
    model_flops: float             # analytic useful FLOPs per step
    model_coll_bytes: float = 0.0  # analytic GLOBAL collective traffic per step of
                                   # JAX's sharded step (the same formula); one
                                   # rank exchanges nothing
    donate: Tuple[int, ...] = ()   # args the step updates in place or consumes
    note: str = ""
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
                                   # analytic side-channel merged into the
                                   # dry-run record (e.g. sampler_traffic)
    arg_specs: Tuple[Any, ...] = ()
                                   # per arg: a layout spec, or a dict of them
                                   # for a dict arg (JAX's in_shardings)
    arg_roles: Tuple[str, ...] = ()
                                   # per arg: the role its bytes count under


@dataclasses.dataclass
class ArchSpec:
    arch_id: str
    family: str                    # recsys | lda (lm | gnn: ROADMAP 13e, 13d)
    shapes: Dict[str, Dict[str, Any]]
    build: Callable[[str, Any], Optional[Cell]]   # (shape, layout)
    skip: Dict[str, str] = dataclasses.field(default_factory=dict)  # shape → reason

    def cell(self, shape: str, layout=None) -> Optional[Cell]:
        if shape in self.skip:
            return None
        return self.build(shape, layout)


# ===========================================================================
# RecSys family
# ===========================================================================

RECSYS_SHAPES = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
}

# the train step's optimizers: SGD on the tables (MLPerf reference practice,
# no optimizer state for the 10⁸-row tables), AdamW on the dense parameters
TABLE_LR = 0.01
DENSE_OPT = AdamW(lr=1e-3, weight_decay=0.0)


def _split_table_params(params):
    tables = {k: v for k, v in params.items() if k.endswith("table") or k == "linear_w"}
    dense = {k: v for k, v in params.items() if k not in tables}
    return tables, dense


def _param_dtype(name: str) -> torch.dtype:
    """Tables live in bf16 (as in JAX's cell, ``base.py:396``); the rest,
    ``linear_w`` included, in f32."""
    return torch.bfloat16 if name.endswith("table") else torch.float32


def _params(cfg, generator, dev) -> Dict[str, torch.Tensor]:
    """``cfg``'s parameters on ``dev``: drawn by ``init_params`` (tables bf16,
    drawn chunk by chunk), or empty ``meta`` tensors of the same shapes and
    dtypes."""
    if dev.type == "meta":
        return {k: torch.empty(s, dtype=_param_dtype(k), device=dev)
                for k, s in sorted(cfg.param_shapes().items())}
    return rec_mod.init_params(cfg, generator, dev, torch.bfloat16)


def one_rank_only(fn: Callable, layout, what: str) -> Callable:
    """``fn`` itself at one rank; across ranks a step that raises when called,
    saying that ``what`` is not ported (the cell is still built: the dry run
    records its specs and formulas)."""
    if layout is None or layout.world_size == 1:
        return fn

    def refused(*args, **kwargs):
        raise NotImplementedError(
            f"{what} across {layout.world_size} ranks is not ported; build the cell "
            "with a RankLayout of one rank or None")
    return refused


_SHARDED_RECSYS = ("the recsys {} step with its tables row-sharded over 'model' (ROADMAP "
                   "item 13b, 'Open from it')")


def _input_specs(inputs, bspec) -> tuple:
    """JAX's input shardings: [B] arrays over the data-parallel axes, [B, ...]
    arrays as ``bspec``."""
    return tuple((bspec[0],) if x.dim() == 1 else bspec for x in inputs)


def build_recsys_cell(cfg, forward_fn, input_maker, flops_fn,
                      shape_name: str, layout=None) -> Cell:
    """Generic builder; ``input_maker(batch, generator, device)`` → the model
    inputs after params. ``layout``: a ``RankLayout`` (None: one rank); the
    arguments are global, ``arg_specs`` split them over the layout's mesh."""
    info = RECSYS_SHAPES[shape_name]
    B = info["batch"]
    shapes = cfg.param_shapes()
    emb_dim = cfg.embedding.dim if hasattr(cfg, "embedding") else cfg.embed_dim
    multi_pod = layout is not None and layout.pods > 1
    pspecs = shd.recsys_param_specs(shapes)
    bspec = shd.recsys_batch_spec(multi_pod)
    probe = input_maker(1, None, "meta") if input_maker is not None else ()
    n_inputs, input_specs = len(probe), _input_specs(probe, bspec)

    if info["kind"] == "retrieval":
        N = info["n_candidates"]

        def retrieval(query, cand):
            return rec_mod.retrieval_scores(query, cand, top_k=100)

        def make_args(generator, device="cuda", params=None):
            dev = resolve_device(device)
            if dev.type == "meta":
                return (torch.empty((B, emb_dim), device=dev),
                        torch.empty((N, emb_dim), device=dev))
            return (torch.randn((B, emb_dim), generator=generator, device=dev),
                    torch.randn((N, emb_dim), generator=generator, device=dev))

        return Cell(cfg.name, shape_name, "retrieval",
                    one_rank_only(retrieval, layout, _SHARDED_RECSYS.format("retrieval")),
                    make_args,
                    model_flops=2.0 * B * N * emb_dim,
                    arg_specs=((None, None), shd.table_rows_spec()),
                    arg_roles=("query", "candidates"))

    table_bytes = 4.0 * sum(
        float(np.prod(s)) for k, s in shapes.items()
        if k.endswith("table") or k == "linear_w")
    n_fields = cfg.embedding.n_fields if hasattr(cfg, "embedding") else 2
    lookup_bytes = 4.0 * B * n_fields * emb_dim   # psum of gathered rows

    if info["kind"] == "serve":
        def serve(params, *inputs):
            return forward_fn(cfg, params, *inputs)

        def make_args(generator, device="cuda", params=None):
            dev = resolve_device(device)
            params = _params(cfg, generator, dev) if params is None else params
            return (params, *input_maker(B, generator, dev))

        return Cell(cfg.name, shape_name, "serve",
                    one_rank_only(serve, layout, _SHARDED_RECSYS.format("serve")), make_args,
                    model_flops=flops_fn(B, False), model_coll_bytes=lookup_bytes,
                    arg_specs=(pspecs, *input_specs),
                    arg_roles=("params",) + ("inputs",) * n_inputs)

    # train: the tables' SGD touches only the rows the batch reads (their
    # sparse gradients from the row-gradient kernel), in place; the dense
    # parameters get AdamW, functionally, over a state of the dense ones only
    _, dense_shapes = _split_table_params(shapes)

    def train_step(params, opt_state, labels, *inputs):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = rec_mod.bce_loss(forward_fn(cfg, leaves, *inputs), labels)
        names = sorted(leaves)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
        tab_g, dense_g = _split_table_params(grads)
        tab_p, dense_p = _split_table_params(params)
        for k in tab_p:
            rec_mod.sgd_rows_(tab_p[k], tab_g[k], TABLE_LR)
        new_dense, opt_state = DENSE_OPT.update(dense_g, opt_state, dense_p)
        return {**tab_p, **new_dense}, opt_state, loss.detach()

    def make_args(generator, device="cuda", params=None):
        """(params, opt_state, labels [B] f32 in {0, 1}, *inputs): AdamW's
        state over the dense parameters only, zeros at step 0, as a dict
        (JAX's ``{"step", "m", "v"}``). ``params`` given are used as they
        are (their tables are then updated in place by the step)."""
        dev = resolve_device(device)
        params = _params(cfg, generator, dev) if params is None else params
        dense = {k: params[k] for k in sorted(dense_shapes)}
        zeros = lambda: {k: torch.zeros_like(v) for k, v in dense.items()}
        opt_state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
                     "m": zeros(), "v": zeros()}
        labels = torch.empty((B,), device=dev) if dev.type == "meta" else \
            torch.randint(0, 2, (B,), generator=generator, device=dev).to(torch.float32)
        return (params, opt_state, labels, *input_maker(B, generator, dev))

    dense_specs = {k: pspecs[k] for k in sorted(dense_shapes)}
    opt_specs = {"step": (), "m": dense_specs, "v": dense_specs}
    return Cell(cfg.name, shape_name, "train",
                one_rank_only(train_step, layout, _SHARDED_RECSYS.format("train")), make_args,
                model_flops=flops_fn(B, True), donate=(0, 1),
                # JAX's formula: lookup psum fwd + dense table-grad reduce over
                # "data" + dense-param grad all-reduce
                model_coll_bytes=2 * lookup_bytes + table_bytes,
                arg_specs=(pspecs, opt_specs, (bspec[0],), *input_specs),
                arg_roles=("params", "opt_state", "labels") + ("inputs",) * n_inputs)
