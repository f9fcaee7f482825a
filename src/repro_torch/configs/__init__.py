"""Architecture registry: ``--arch <id>`` resolution for the launch scripts
(port of ``repro.configs``).

The port registers every id of the JAX registry, in its order: the five LM
architectures, graphsage-reddit, the four recsys architectures and
peacock-lda.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchSpec


def all_specs() -> Dict[str, ArchSpec]:
    from repro_torch.configs import gnn_archs, lm_archs, peacock_lda, recsys_archs

    out: Dict[str, ArchSpec] = {}
    out.update(lm_archs.specs())
    out["graphsage-reddit"] = gnn_archs.spec()
    out.update(recsys_archs.specs())
    out["peacock-lda"] = peacock_lda.spec()
    return out


def all_ids() -> list:
    """Every id of the registry, in the JAX registry's order."""
    return list(all_specs())


def get_arch(arch_id: str) -> ArchSpec:
    specs = all_specs()
    if arch_id not in specs:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(specs)}")
    return specs[arch_id]
