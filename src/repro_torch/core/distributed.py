"""Peacock's ring sampler on one device: the alias-MH family (port of the
M = 1 part of ``repro.core.distributed``).

With a ring of one device (M = 1, one data shard, one vocab shard) the
diagonal-ring epoch of the JAX package is one round: the device rebuilds the
sparse Θ pairs of its data shard from the stack's z, samples its one
sub-block in packages of L tokens against its resident Φ and the stale alias
tables, and writes the new z back into the stack. The rotations and the Ψ
all-reduce are the identity on one device. This is what ``Trainer`` runs on
one device with ``sampler="alias"``.

The global layout is the JAX package's: phi [1, rows, K] int32, psi [K]
int32, stacks [S=1, M=1, cap] (word_local, doc_local, uid, z) and the tables
appended after the seed (wq/wp/wa shaped like phi, ap/aa [K]). uid is int64
holding uint32 values. ``phi``, ``psi`` and ``z`` are updated in place.

The dense ring (``sampler="dense"``), rings of more than one device and
word-sharded model parallelism are not ported yet; the epoch builder raises
for them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import sparse
from repro_torch.data.corpus import ShardedCorpus
from repro_torch.kernels.alias import ops as alias_ops


@dataclasses.dataclass(frozen=True)
class RingConfig:
    n_topics: int
    vocab_size: int            # global V (for the V*beta smoothing term)
    rows_per_shard: int
    docs_per_shard: int
    cap: int                   # tokens per (data, vocab) sub-block
    package_len: int           # L — pipeline package size (§3.1.2)
    n_rounds: int = 1          # = ring size M; only 1 is ported
    model_shards: int = 1      # P — word-sharded model parallelism; only 1
    sampler: str = "alias"     # sparsity-aware alias-table MH; "dense" (the
                               # exact [T, K] plane scan) is not ported
    n_mh: int = 4              # MH steps per token (alias sampler)
    doc_topic_cap: int = 0     # pair-row pitch for sparse Θ (0 → n_topics);
                               # must be ≥ max distinct topics per doc


def _sample_subblock_mh(phi, psi, pairs, w, d, z, uid, alpha, beta, seed: int,
                        cfg: RingConfig, tables: sparse.AliasTables):
    """Sample one sub-block in packages of L tokens with the alias-MH probe.

    phi [rows, K] and psi [K] int32 (updated in place), pairs (topic, count)
    [docs, cap_p]; w/d/z/uid [cap]. Sentinels (w < 0) are sampled at w = 0,
    d = 0 and their results discarded through masked count updates. Returns
    (phi, psi, pairs, z_new).
    """
    L = cfg.package_len
    if cfg.cap % L:
        raise ValueError(f"package_len={L} must divide cap={cfg.cap}")
    tp, ct = pairs
    out = []
    for lo in range(0, cfg.cap, L):
        pkg = slice(lo, lo + L)
        wk, dk, zk = w[pkg], d[pkg], z[pkg]
        valid = wk >= 0
        w_s = torch.where(valid, wk, 0)
        d_s = torch.where(valid, dk, 0)
        z_new = alias_ops.mh_resample(
            phi, psi, tp, ct, tables.wq, tables.wp, tables.wa, alpha, tables.ap,
            tables.aa, w_s, d_s, zk, uid[pkg], seed, beta, cfg.vocab_size, cfg.n_mh)
        z_new = torch.where(valid, z_new, zk)
        sparse.move_counts(phi, psi, w_s, zk, z_new, valid.to(torch.int32))
        tp, ct = sparse.apply_deltas(tp, ct, d_s, zk, z_new, valid)
        out.append(z_new)
    return phi, psi, (tp, ct), torch.cat(out)


def build_epoch_body(cfg: RingConfig):
    """The one-device ring epoch of the alias family.

    ``epoch(phi, psi, wl, dl, uid, z, alpha, beta, seed, wq, wp, wa, ap, aa)``
    runs one round: pairs rebuilt from the stack, the sub-block sampled, z
    written back. Returns (phi, psi, wl, dl, uid, z), phi/psi/z updated in
    place. Raises for what is not ported: the dense sampler, more than one
    round (a ring of several devices) and model sharding.
    """
    if cfg.sampler != "alias":
        raise NotImplementedError(f"sampler={cfg.sampler!r}: only the alias ring is ported")
    if cfg.n_rounds != 1 or cfg.model_shards != 1:
        raise NotImplementedError(
            f"n_rounds={cfg.n_rounds}, model_shards={cfg.model_shards}: only a ring "
            "of one device (n_rounds = model_shards = 1) is ported")
    cap_p = cfg.doc_topic_cap or cfg.n_topics

    def epoch(phi, psi, wl, dl, uid, z, alpha, beta, seed: int, wq, wp, wa, ap, aa):
        tabs = sparse.AliasTables(wq[0], wp[0], wa[0], ap, aa)
        flat_valid = wl.reshape(-1) >= 0
        pairs = sparse.pairs_from_assignments(dl.reshape(-1), z.reshape(-1), flat_valid,
                                              cfg.docs_per_shard, cap_p)
        _, _, _, z_new = _sample_subblock_mh(
            phi[0], psi, pairs, wl[0, 0], dl[0, 0], z[0, 0], uid[0, 0], alpha, beta,
            int(seed), cfg, tabs)
        z[0, 0] = z_new
        return phi, psi, wl, dl, uid, z

    return epoch


def host_counts(sc: ShardedCorpus, n_topics: int, phi=None, psi=None):
    """Accumulate one segment's z0 into host (phi [M, rows, K], psi [K]) int64.

    Pass the previous segment's output back in to fold several segments into
    one global count state.
    """
    S, M, cap = sc.word_local.shape
    if phi is None:
        phi = np.zeros((M, sc.rows_per_shard, n_topics), np.int64)
    if psi is None:
        psi = np.zeros((n_topics,), np.int64)
    valid = np.asarray(sc.word_local) >= 0
    # vocab shard of sub-block index m is m (by construction)
    for m in range(M):
        w = np.asarray(sc.word_local[:, m])[valid[:, m]]
        zz = np.asarray(sc.z0[:, m])[valid[:, m]]
        np.add.at(phi[m], (w, zz), 1)
        np.add.at(psi, zz, 1)
    return phi, psi


def device_arrays(sc: ShardedCorpus, n_topics: int, device="cuda"):
    """Host → device: the [S, M, cap] stacks and phi/psi counted from z0.

    The counts are the same as ``host_counts``'s, accumulated on the device
    (int32 ``index_put_``), so a full-width Φ never passes through host
    memory. Returns (phi [M, rows, K] int32, psi [K] int32, word_local,
    doc_local, uid int64, z0).
    """
    dev = resolve_device(device)
    wl = torch.from_numpy(np.ascontiguousarray(sc.word_local, np.int32)).to(dev)
    dl = torch.from_numpy(np.ascontiguousarray(sc.doc_local, np.int32)).to(dev)
    uid = torch.from_numpy(np.asarray(sc.uid).astype(np.int64)).to(dev)
    z = torch.from_numpy(np.ascontiguousarray(sc.z0, np.int32)).to(dev)
    S, M, _ = wl.shape
    valid = wl >= 0
    m_of = torch.arange(M, device=dev)[None, :, None].expand_as(wl)
    zv = z[valid].long()
    one = torch.ones_like(zv, dtype=torch.int32)
    phi = torch.zeros((M, sc.rows_per_shard, n_topics), dtype=torch.int32, device=dev)
    phi.index_put_((m_of[valid], wl[valid].long(), zv), one, accumulate=True)
    psi = torch.zeros((n_topics,), dtype=torch.int32, device=dev)
    psi.index_put_((zv,), one, accumulate=True)
    return phi, psi, wl, dl, uid, z


def gather_phi(phi_sharded: torch.Tensor, sc: ShardedCorpus) -> torch.Tensor:
    """The global [V, K] phi reassembled from ring shards (eval, serving), on
    the device of ``phi_sharded``."""
    dev = phi_sharded.device
    shard = torch.from_numpy(np.asarray(sc.shard_of_word, np.int64)).to(dev)
    local = torch.from_numpy(np.asarray(sc.local_of_word, np.int64)).to(dev)
    return phi_sharded[shard, local]
