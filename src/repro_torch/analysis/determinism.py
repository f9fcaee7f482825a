"""Determinism auditor: the ops behind the bitwise kill→resume contract,
watched as an epoch runs (the counterpart of ``repro.analysis.determinism``).

The recovery guarantee (DESIGN.md §4) is *bitwise*: a killed session resumed
from its checkpoint replays the exact same z stream. JAX checks it by
walking the epoch's jaxpr; torch has no jaxpr, so the port runs one epoch
under a ``TorchDispatchMode`` (:class:`Audit`, the pattern of
``dist/analysis._Counter``) and looks at every aten op that reaches it,
outside the bodies of the hand-written kernels (the card runs those as one
launch each, held bit for bit against their plain versions):

* **No float accumulating scatter** (error). ``index_add_``,
  ``scatter_add_``, ``scatter_reduce_``, ``index_reduce_`` and
  ``index_put_(accumulate=True)`` on a float tensor add colliding indices
  in an order the card does not fix (atomics); the count accumulators
  (Φ, Ψ, Θ) are int32 by design, where any order gives the same bits.
  JAX's "no float scatter-add".

* **No torch RNG** (error): ``rand*``, ``normal_``, ``uniform_``,
  ``bernoulli``, ``multinomial``, ``exponential_``, ``randperm`` and their
  kin inside the epoch. Draws come from ``core/prng`` counters keyed on
  (seed, token uid): stateless, order-free and stable under resharding,
  where a generator's stream depends on the order of the calls. JAX's "no
  ``jax.random``".

* **Device → host reads** (info): ``_local_scalar_dense`` (``.item()``,
  ``int(t)``) and copies from the card to the CPU. JAX's host callbacks
  have no eager counterpart; a read is no fault, but each one stalls the
  host on the card, so the count is reported to read.
"""
from __future__ import annotations

import os
import traceback
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.report import Finding, error, info
from repro_torch.dist import analysis

_FLOAT_ACCUMULATE = {"index_add", "index_add_", "scatter_add", "scatter_add_",
                     "scatter_reduce", "scatter_reduce_", "index_reduce", "index_reduce_"}
_INDEX_PUT = {"index_put", "index_put_", "_index_put_impl", "_index_put_impl_"}
_RNG = {"rand", "rand_like", "randn", "randn_like", "randint", "randint_like", "randperm",
        "normal", "normal_", "uniform", "uniform_", "bernoulli", "bernoulli_", "multinomial",
        "exponential", "exponential_", "random", "random_", "geometric_", "cauchy_",
        "log_normal_", "poisson", "native_dropout"}
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the audit's own machinery, and torch's, are never the site of an op
_SKIP = (os.path.dirname(os.path.abspath(__file__)) + os.sep,
         os.path.join(_PACKAGE, "dist", "analysis.py"),
         os.path.dirname(os.path.abspath(torch.__file__)) + os.sep)


def _site() -> str:
    """The innermost frame outside torch and the audit that issued the op:
    ``core/distributed.py:132`` in the port, else ``file.py:line``."""
    for frame in reversed(traceback.extract_stack()):
        path = os.path.abspath(frame.filename)
        if path.startswith(_SKIP):
            continue
        if path.startswith(_PACKAGE + os.sep):
            return f"{os.path.relpath(path, _PACKAGE)}:{frame.lineno}"
        return f"{os.path.basename(path)}:{frame.lineno}"
    return "<epoch>"


def _accumulates(name: str, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> bool:
    if name in _FLOAT_ACCUMULATE:
        return True
    if name in _INDEX_PUT:
        return bool(kwargs.get("accumulate", args[3] if len(args) > 3 else False))
    if name in ("scatter", "scatter_"):
        return kwargs.get("reduce", args[4] if len(args) > 4 else None) is not None
    return False


def _to_host(name: str, args: Tuple[Any, ...], kwargs: Dict[str, Any], out: Any) -> bool:
    if name == "_local_scalar_dense":
        return True
    if name in ("_to_copy", "copy_") and len(args) >= 1:
        src = args[1] if name == "copy_" else args[0]
        dst = args[0] if name == "copy_" else out
        return (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                and src.device.type != "cpu" and dst.device.type == "cpu")
    return False


class Audit(TorchDispatchMode):
    """Record what breaks bitwise replay while it is active. Enter it around
    ``dist.analysis.count_cost`` (:func:`audit` does) so the kernels' plain
    bodies on the CPU stay hidden, as the card's launches are."""

    def __init__(self):
        super().__init__()
        self.findings: List[Finding] = []
        self.host_reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if analysis.in_kernel():
            return out
        name = func.overloadpacket.__name__
        if _accumulates(name, args, kwargs) and args and isinstance(args[0], torch.Tensor) \
                and args[0].is_floating_point():
            where = _site()
            self.findings.append(error(
                "determinism.float-scatter-add",
                f"float accumulating {name} on {str(args[0].dtype).replace('torch.', '')}"
                f"{list(args[0].shape)}: the card adds colliding indices in no fixed order, "
                "which breaks the bitwise kill→resume contract; keep count accumulators "
                "int32 (phi/psi/theta) and cast at the read site instead",
                location=where, op=name, dtype=str(args[0].dtype), shape=list(args[0].shape)))
        elif name in _RNG:
            where = _site()
            self.findings.append(error(
                "determinism.torch-random",
                f"torch RNG op '{name}' inside the epoch: sampler randomness must come "
                "from core/prng counter hashing keyed on (seed, token uid); a generator's "
                "stream depends on the order of its calls and on the layout",
                location=where, op=name))
        elif _to_host(name, args, kwargs, out):
            self.host_reads += 1
        return out


def audit(fn, *args: Any, **kwargs: Any):
    """Run ``fn(*args, **kwargs)`` once under :class:`Audit` and
    ``count_cost``. Returns ``(findings, host_reads, cost, result)``: the
    error findings in op order, the number of device → host reads, the
    epoch's ``Cost`` (its collectives for ``analysis.shardcheck``) and
    ``fn``'s result."""
    mode = Audit()
    with mode:
        cost, out = analysis.count_cost(fn, *args, **kwargs)
    return list(mode.findings), mode.host_reads, cost, out


def verdict(findings: List[Finding], host_reads: int, label: str) -> List[Finding]:
    """The findings of one audited epoch, closed by the info findings that
    read it: the host reads, and ``determinism.clean`` when nothing failed."""
    out = list(findings)
    out.append(info("determinism.host-reads",
                    f"{label}: {host_reads} device → host read(s) in the epoch (each "
                    "stalls the host on the card; none is a fault)",
                    location=label, host_reads=host_reads))
    if not findings:
        out.append(info("determinism.clean",
                        f"{label} is replay-safe: no float accumulating scatter, no torch "
                        "RNG op", location=label))
    return out
