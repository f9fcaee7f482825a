"""Architecture registry: ``--arch <id>`` resolution for the launch scripts
(port of ``repro.configs``).

The port registers the four recsys architectures and peacock-lda. The LM
and GNN ids that the JAX package registers are named in ``NOT_PORTED`` with
their shapes and the ROADMAP item that ports them; ``get_arch`` of one of
them raises naming that item, and the dry run records their cells as
skipped.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchSpec

_LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
_GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")

# id → (family, ROADMAP item, shape names), in the JAX registry's order
NOT_PORTED = {
    "minicpm-2b": ("lm", "13e", _LM_SHAPES),
    "smollm-135m": ("lm", "13e", _LM_SHAPES),
    "qwen3-0.6b": ("lm", "13e", _LM_SHAPES),
    "phi3.5-moe-42b-a6.6b": ("lm", "13e", _LM_SHAPES),
    "qwen2-moe-a2.7b": ("lm", "13e", _LM_SHAPES),
    "graphsage-reddit": ("gnn", "13d", _GNN_SHAPES),
}


def not_ported_reason(arch_id: str) -> str:
    family, item, _ = NOT_PORTED[arch_id]
    return (f"{arch_id}: the {family.upper()} family is not ported to PyTorch yet "
            f"(ROADMAP item {item})")


def all_specs() -> Dict[str, ArchSpec]:
    from repro_torch.configs import peacock_lda, recsys_archs

    out: Dict[str, ArchSpec] = {}
    out.update(recsys_archs.specs())
    out["peacock-lda"] = peacock_lda.spec()
    return out


def all_ids() -> list:
    """Every id of the JAX registry, in its order: the not-ported LM and GNN
    ids first, then the ported ones."""
    return list(NOT_PORTED) + list(all_specs())


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(not_ported_reason(arch_id))
    specs = all_specs()
    if arch_id not in specs:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(all_ids())}")
    return specs[arch_id]
