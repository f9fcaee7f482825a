"""AdamW with global-norm clipping (port of ``repro.optim.adamw``).

Runs on dicts of tensors (nested dicts too), in the JAX version's order of
f32 operations. The state is a plain ``AdamWState`` (or a dict with the
same keys, kept in that form), not a ``torch.optim.Optimizer``, so JAX's
state converts one to one (``repro_torch.convert.adamw_state_from_numpy``).
``update`` is functional: it returns new parameters and a new state.

Across ranks (``update``'s ``layout`` and ``specs``: the leaves are the
rank's blocks of sharded parameters, as ``sharding.local_view`` cuts them)
the clipping norm is the global one: each leaf's Σx² is summed over the
ranks that split it and counted once over the ranks that replicate it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Union

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32, 0-d
    m: Any
    v: Any


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (keys in sorted order, as
    ``jax.tree.leaves`` walks a dict)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        leaves = _leaves(params)
        dev = leaves[0].device if leaves else torch.device("cpu")
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          m=_map(torch.zeros_like, params),
                          v=_map(torch.zeros_like, params))

    def update(self, grads, state, params, layout=None, specs=None):
        """``layout`` and ``specs`` (the leaves' layout specs, a tree of the
        grads' structure): the rank's blocks, clipped by the global norm."""
        as_dict = isinstance(state, dict)
        if as_dict:
            state = AdamWState(state["step"], state["m"], state["v"])
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr

        scale = None
        if self.clip_norm is not None:
            gnorm = global_norm(grads, layout, specs)
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), stepf)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), stepf)

        def leaf(p, g, mm, vv):
            # one leaf at a time, so that no second copy of every gradient
            # (clipped) is ever whole; JAX's operations in JAX's order
            if scale is not None:
                g = g * scale
            m = b1 * mm + (1 - b1) * g
            v = b2 * vv + (1 - b2) * g * g
            mhat = m / c1
            vhat = v / c2
            return p - lr * (mhat / (torch.sqrt(vhat) + self.eps) + self.weight_decay * p), m, v

        out = _map(leaf, params, grads, state.m, state.v)
        new_params, m, v = (_map(lambda t, i=i: t[i], out) for i in range(3))
        new_state = {"step": step, "m": m, "v": v} if as_dict else AdamWState(
            step=step, m=m, v=v)
        return new_params, new_state


def global_norm(tree, layout=None, specs=None) -> torch.Tensor:
    """sqrt of the sum over the leaves (in ``jax.tree.leaves`` order) of Σ x²
    in f32. Across ranks (``layout`` of more than one rank, ``specs`` the
    leaves' layout specs) each leaf's Σ x² is the sum over the world of its
    blocks, each block counted on one rank only (the first of its replicas:
    index 0 on every axis its spec does not split), in one ``all_reduce``;
    the leaves' totals are then summed in the same order."""
    sums = [torch.sum(torch.square(leaf.to(torch.float32))) for leaf in _leaves(tree)]
    if layout is not None and layout.world_size > 1:
        from repro_torch.dist import collectives as coll
        from repro_torch.dist.sharding import MESH_AXES, _axes

        coords = dict(zip(MESH_AXES, layout.coords()))
        owned = []
        for s, spec in zip(sums, _leaves(specs)):
            split = {a for entry in spec for a in _axes(entry)}
            first = all(coords[a] == 0 for a in MESH_AXES if a not in split)
            owned.append(s if first else torch.zeros_like(s))
        sums = coll.all_reduce_(torch.stack(owned), layout, "world").unbind(0)
    total = 0
    for s in sums:
        total = total + s
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
