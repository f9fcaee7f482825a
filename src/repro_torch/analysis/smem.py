"""Launch-budget pass for sm_90: the port's counterpart of
``repro.analysis.vmem``.

A TPU kernel lives or dies on VMEM; a Hopper kernel on its launch: at most
1,024 threads a block, 48 KiB of shared memory a block unless the source
opts in with ``cudaFuncSetAttribute`` (then 227 KiB), 65,536 registers an
SM, and every C ``int`` argument within int32 (ctypes cuts a larger Python
int silently). Two halves, each reading one source of truth:

* **The plans** (anywhere, at any geometry). Each ``kernels/*/kernel.py``
  wrapper computes a :class:`repro_torch.kernels.LaunchPlan` before it
  launches (the instantiation and the int arguments it passes) and
  launches its arguments, so the plans here are the ones the wrappers
  construct, not a re-derivation; :func:`repo_kernel_plans` asks the same
  plan functions at a session's geometry (the 32,768 × 100,000 alias
  table, a package of a whole shard) and :func:`check_plans` holds their
  int arguments to int32. Every grid in ``csrc`` is one-dimensional and no
  larger than such an argument (or the card's resident blocks, or about a
  128th of ``embedding_bag_bwd``'s items), so this bounds grid.x too. No
  tensor is made.

* **The built kernels** (on the card). Each ``csrc/<name>.cu`` exports
  ``<name>_attributes``: ``cudaFuncGetAttributes`` and the occupancy API on
  every instantiation its launch function can reach, at the block and
  dynamic shared bytes that launch passes, with its opt-in
  (``kernels.attributes``). :func:`check_attributes` holds them to sm_90:
  ``binaryVersion`` 90 (built for sm_90a), threads ≤ 1,024, registers ×
  threads ≤ 65,536, static + dynamic shared bytes ≤ the limit, at least
  one block an SM, and every planned instantiation among them; spills
  (``localSizeBytes``) are a warning; blocks an SM are reported. On the CPU
  the attributes are unknown and said so.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from repro_torch import kernels as kernels_mod
from repro_torch.analysis.report import Finding, error, info, warning
from repro_torch.kernels import LaunchPlan

SM90_BINARY = 90


# ------------------------------------------------------------------ plans ---


def repo_kernel_plans(n_topics: int, rows_per_device: int, docs_per_shard: int,
                      doc_topic_cap: int, package_len: int, n_mh: int = 4,
                      sampler: str = "dense", embedding_dim: int = 64,
                      bag_fields: int = 8) -> List[LaunchPlan]:
    """The launches a session with this geometry would make, from the
    wrappers' own plan functions (the signature of
    ``repro.analysis.vmem.repo_kernel_plans``).

    ``sampler="dense"`` plans the Gumbel-max scan over a package;
    ``"alias"`` the word tables' build over a rank's rows (one launch, as
    ``sparse.make_word_tables`` makes it) and the MH probe over a package
    (pair rows of ``doc_topic_cap`` slots). The embedding bag and its row
    gradient are always planned, at a [16, bag_fields] bag of
    ``embedding_dim`` f32 columns (their tables ride device memory whole,
    so the plan does not depend on the table), keeping the audit over every
    ``kernels/*``. ``docs_per_shard`` sizes nothing a launch takes and is
    kept for the signature.
    """
    from repro_torch.kernels.alias import kernel as ak
    from repro_torch.kernels.embedding_bag import kernel as ek
    from repro_torch.kernels.gibbs import kernel as gk

    del docs_per_shard
    K, rows, T = int(n_topics), max(1, int(rows_per_device)), max(1, int(package_len))
    cap = max(1, int(doc_topic_cap or K))
    if sampler == "alias":
        plans = [ak.alias_build_plan(rows, K), ak.mh_resample_plan(T, K, cap, n_mh)]
    else:
        plans = [gk.gibbs_argmax_plan(T, K)]
    B, D, F = 16, int(embedding_dim), int(bag_fields)
    plans.append(ek.bag_plan(D, 0, B, F, True, 0))
    plans += ek.bwd_plans(F, D, 0, ek.bwd_vec(D, 4, 0), ek.bwd_copy(D, 4, 0), 0)
    return plans


def check_plans(plans: Sequence[LaunchPlan]) -> List[Finding]:
    """A verdict per plan: an error naming each int argument int32 cannot
    carry, else info."""
    findings: List[Finding] = []
    for plan in plans:
        problems = kernels_mod.plan_problems(plan)
        data = {"library": plan.library, "kernel": plan.kernel,
                "int_args": dict(plan.int_args)}
        where = f"{plan.library}:{plan.kernel}"
        if problems:
            findings.append(error(
                "smem.launch",
                f"{plan.kernel} cannot launch at this geometry: " + "; ".join(problems)
                + " — shrink the package or the rows a launch, or split the launch",
                location=where, **data))
        else:
            findings.append(info("smem.launch",
                                 f"{plan.kernel}: int arguments {dict(plan.int_args)} fit int32",
                                 location=where, **data))
    return findings


# ------------------------------------------------------- built kernels ------


def card_attributes(names: Optional[Sequence[str]] = None) -> Optional[List[Dict[str, Any]]]:
    """Every built kernel instantiation's attributes (``kernels.attributes``
    of each library, built first if stale), or None where there is no card."""
    from repro_torch import has_card

    if not has_card():
        return None
    names = kernels_mod.kernel_names() if names is None else list(names)
    kernels_mod.build(names)
    return [a for name in names for a in kernels_mod.attributes(name)]


def attribute_line(a: Dict[str, Any]) -> str:
    """One kernel's numbers, as the smoke and the report print them."""
    return (f"{a['library']}:{a['kernel']}: {a['regs']} regs a thread x {a['threads']} threads, "
            f"{a['static_smem']:,} static + {a['dynamic_smem']:,} dynamic shared bytes, "
            f"{a['local_bytes']} spill bytes, {a['blocks_per_sm']} blocks/SM, "
            f"binaryVersion {a['binary_version']}")


def check_attributes(attrs: Optional[Sequence[Dict[str, Any]]],
                     plans: Sequence[LaunchPlan] = ()) -> List[Finding]:
    """Hold the built kernels to sm_90, and check that every planned
    instantiation is among them; ``attrs`` None (no card) gives one info
    finding."""
    if attrs is None:
        return [info("smem.attributes",
                     "built kernels not read: no card here, so registers, shared memory, "
                     "spills and blocks an SM are unknown (the plans were checked)",
                     location="csrc")]
    findings: List[Finding] = []
    for a in attrs:
        where = f"{a['library']}:{a['kernel']}"
        limit = kernels_mod.shared_limit(bool(a["opt_in"]))
        regs = int(a["regs"]) * int(a["threads"])
        smem = int(a["static_smem"]) + int(a["dynamic_smem"])
        bad = []
        if int(a["binary_version"]) != SM90_BINARY:
            bad.append(f"binaryVersion {a['binary_version']}, not {SM90_BINARY} (not built "
                       "for sm_90a)")
        if not 0 < int(a["threads"]) <= kernels_mod.MAX_THREADS_PER_BLOCK:
            bad.append(f"{a['threads']} threads a block (1 to "
                       f"{kernels_mod.MAX_THREADS_PER_BLOCK})")
        if regs > kernels_mod.REGISTERS_PER_SM:
            bad.append(f"{a['regs']} regs x {a['threads']} threads = {regs:,} > "
                       f"{kernels_mod.REGISTERS_PER_SM:,} registers an SM")
        if smem > limit:
            bad.append(f"{smem:,} shared bytes a block > {limit:,}"
                       + ("" if a["opt_in"] else " without cudaFuncSetAttribute in the source"))
        if int(a["dynamic_smem"]) > int(a["max_dynamic_smem"]):
            bad.append(f"{a['dynamic_smem']:,} dynamic shared bytes > the kernel's allowed "
                       f"{a['max_dynamic_smem']:,}")
        if int(a["threads"]) > int(a["max_threads"]):
            bad.append(f"{a['threads']} threads > the kernel's {a['max_threads']}")
        if int(a["blocks_per_sm"]) < 1:
            bad.append("no block fits an SM")
        data = dict(a, shared_limit=limit)
        if bad:
            findings.append(error("smem.built", f"{where}: " + "; ".join(bad),
                                  location=where, **data))
        else:
            findings.append(info("smem.built", attribute_line(a), location=where, **data))
        if int(a["local_bytes"]) > 0:
            findings.append(warning("smem.spills",
                                    f"{where} spills {a['local_bytes']} bytes a thread to "
                                    "local memory", location=where, **data))
    built = {(a["library"], a["kernel"]) for a in attrs}
    for plan in plans:
        where = f"{plan.library}:{plan.kernel}"
        if (plan.library, plan.kernel) not in built:
            findings.append(error("smem.plan",
                                  f"the plan launches {where}, which "
                                  f"{plan.library}_attributes does not list",
                                  location=where))
    return findings
