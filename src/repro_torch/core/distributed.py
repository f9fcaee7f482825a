"""Peacock's ring sampler on one device (port of the M = 1 part of
``repro.core.distributed``).

With a ring of one device (M = 1, one data shard, one vocab shard) the
diagonal-ring epoch of the JAX package is one round: the device rebuilds the
doc-topic state of its data shard from the stack's z, samples its one
sub-block in packages of L tokens against its resident Φ, and writes the new
z back into the stack. The rotations and the Ψ all-reduce are the identity on
one device. This is what ``Trainer`` runs on one device, in both sampler
families:

- ``sampler="dense"``: Θ rebuilt as a count plane (dense [docs, K], or
  ``small_theta``'s [cap+1, K] over the sampled docs, int32 or int8), each
  package drawn by the fused Gumbel-max scan ``gibbs_argmax`` over [L, K]
  planes with the token's own assignment removed (¬ivd);
- ``sampler="alias"``: Θ as sparse (topic, count) pairs and the alias-MH
  probe against stale proposal tables.

¬ivd in the dense family has two forms. By default ψ goes to the kernel as an
[L, K] plane with 1 taken off at (t, z_t), like Φ and Θ. With
``column_exclusion`` ψ goes as its [K] row and its self-exclusion is folded
into Φ's z column, (φ+β)·(ψ_z+Vβ)/(ψ_z−1+Vβ) − β: the form of the JAX
package's kernel branch, taken here on every device. (The JAX package's plain
branch adds a log difference instead, which can differ in the last ulp.)

The global layout is the JAX package's: phi [1, rows, K] int32, psi [K]
int32, stacks [S=1, M=1, cap] (word_local, doc_local, uid, z) and, for the
alias family, the tables appended after the seed (wq/wp/wa shaped like phi,
ap/aa [K]). uid is int64 holding uint32 values. ``phi``, ``psi`` and ``z``
are updated in place. Θ is weighted by the stack's valid mask; the ring has
no sentinel rollback (padding tokens keep their z and move no count).

Rings of more than one device and word-sharded model parallelism are not
ported yet (ROADMAP queue 1, item 11); the epoch builder raises for them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import gibbs, sparse
from repro_torch.data.corpus import ShardedCorpus
from repro_torch.kernels.alias import ops as alias_ops
from repro_torch.kernels.gibbs import ops as gibbs_ops


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
    sampler: str = "dense"     # "dense" = exact [T, K] plane scan;
                               # "alias" = sparsity-aware alias-table MH
    n_mh: int = 4              # MH steps per token (alias sampler)
    doc_topic_cap: int = 0     # pair-row pitch for sparse Θ (0 → n_topics);
                               # must be ≥ max distinct topics per doc
    # dense-family knobs (the JAX package's hill-climbed variant):
    theta_dtype: torch.dtype = torch.int32  # int8: 4× less Θ-rebuild traffic
                                            # (wraps past 127 repeats of a topic)
    column_exclusion: bool = False # ¬ivd of ψ folded into Φ's z column (ψ
                                   # stays one [K] row) instead of a ψ plane
    small_theta: bool = False      # rebuild Θ only for the ≤ cap docs sampled
                                   # this round ([cap+1, K], not [docs, K])


def _packages(cfg: RingConfig):
    L = cfg.package_len
    if L <= 0 or cfg.cap % L:
        raise ValueError(f"package_len={L} must divide cap={cfg.cap}")
    return [slice(lo, lo + L) for lo in range(0, cfg.cap, L)]


def _sample_subblock(phi, psi, theta, w, d, z, uid, alpha, beta, seed: int,
                     cfg: RingConfig):
    """Sample one sub-block in packages of L tokens with the Gumbel-max scan.

    phi [rows, K] and psi [K] int32 and theta [docs, K] (``cfg.theta_dtype``)
    are updated in place; w/d/z/uid [cap]. Sentinels (w < 0) are drawn at
    w = 0, d = 0 and their results discarded through masked count updates.
    Returns (phi, psi, theta, z_new).
    """
    out = []
    for pkg in _packages(cfg):
        wk, dk, zk = w[pkg], d[pkg], z[pkg]
        valid = wk >= 0
        w_s = torch.where(valid, wk, 0).long()
        d_s = torch.where(valid, dk, 0).long()
        zl = zk.long()
        if cfg.column_exclusion:
            at = (torch.arange(zl.shape[0], device=zl.device), zl)
            phi_rows = phi[w_s].to(torch.float32)
            phi_rows[at] -= 1.0
            theta_rows = theta[d_s].to(torch.float32)
            theta_rows[at] -= 1.0
            psi_f = psi.to(torch.float32)
            psi_z = psi_f[zl]
            vb = cfg.vocab_size * beta
            corr = (psi_z + vb) / (psi_z - 1.0 + vb)
            phi_rows[at] = (phi_rows[at] + beta) * corr - beta
            psi_arg = psi_f
        else:
            phi_rows, psi_arg, theta_rows = gibbs._self_excluded(phi, psi, theta, w_s, d_s, zl)
        z_new = gibbs_ops.gibbs_argmax(phi_rows, psi_arg, theta_rows, alpha, beta,
                                       uid[pkg], seed, cfg.vocab_size, 1.0)
        del phi_rows, psi_arg, theta_rows
        z_new = torch.where(valid, z_new, zk)
        sparse.move_counts(phi, psi, w_s, zk, z_new, valid.to(torch.int32))
        dtheta = valid.to(theta.dtype)
        theta.index_put_((d_s, zl), -dtheta, accumulate=True)
        theta.index_put_((d_s, z_new.long()), dtheta, accumulate=True)
        out.append(z_new)
    return phi, psi, theta, torch.cat(out)


def _sample_subblock_mh(phi, psi, pairs, w, d, z, uid, alpha, beta, seed: int,
                        cfg: RingConfig, tables: sparse.AliasTables):
    """Sample one sub-block in packages of L tokens with the alias-MH probe.

    phi [rows, K] and psi [K] int32 (updated in place), pairs (topic, count)
    [docs, cap_p]; w/d/z/uid [cap]. Sentinels (w < 0) are sampled at w = 0,
    d = 0 and their results discarded through masked count updates. Returns
    (phi, psi, pairs, z_new).
    """
    tp, ct = pairs
    out = []
    for pkg in _packages(cfg):
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


def _rebuild_theta(flat_d, flat_z, flat_valid, d_sub, cfg: RingConfig):
    """Θ of the visiting stack, weighted by its valid mask: dense [docs, K],
    or with ``small_theta`` one row per doc sampled this round plus a scratch
    row ([cap+1, K]). Returns (theta, the sub-block's doc rows in it)."""
    dev = flat_z.device
    valid = flat_valid.to(cfg.theta_dtype)
    if cfg.small_theta:
        # docs sampled this round get rows [0, cap) (which of a doc's tokens
        # names its row does not matter: all of them read the same row);
        # absent docs land in the scratch row cap
        inv = torch.full((cfg.docs_per_shard,), cfg.cap, dtype=torch.int32, device=dev)
        inv[d_sub.long()] = torch.arange(cfg.cap, dtype=torch.int32, device=dev)
        idx = inv[flat_d.long()].long()
        theta = torch.zeros((cfg.cap + 1, cfg.n_topics), dtype=cfg.theta_dtype, device=dev)
        theta.index_put_((idx, flat_z.long()), valid, accumulate=True)
        return theta, inv[d_sub.long()]
    theta = torch.zeros((cfg.docs_per_shard, cfg.n_topics), dtype=cfg.theta_dtype,
                        device=dev)
    theta.index_put_((flat_d.long(), flat_z.long()), valid, accumulate=True)
    return theta, d_sub


def build_epoch_body(cfg: RingConfig):
    """The one-device ring epoch.

    ``epoch(phi, psi, wl, dl, uid, z, alpha, beta, seed, *tables)`` runs one
    round: Θ (dense family) or the pairs (alias family) rebuilt from the
    stack, the sub-block sampled, z written back. ``tables`` is empty for
    ``sampler="dense"`` and (wq, wp, wa, ap, aa) for ``sampler="alias"``.
    Returns (phi, psi, wl, dl, uid, z), phi/psi/z updated in place. Raises
    for what is not ported: more than one round (a ring of several devices)
    and model sharding.
    """
    if cfg.sampler not in ("dense", "alias"):
        raise ValueError(f"sampler must be 'dense' or 'alias', got {cfg.sampler!r}")
    if cfg.n_rounds != 1 or cfg.model_shards != 1:
        raise NotImplementedError(
            f"n_rounds={cfg.n_rounds}, model_shards={cfg.model_shards}: only a ring "
            "of one device (n_rounds = model_shards = 1) is ported; the multi-GPU "
            "ring is ROADMAP queue 1, item 11")
    if cfg.theta_dtype not in (torch.int32, torch.int8):
        raise ValueError(f"theta_dtype must be torch.int32 or torch.int8, got {cfg.theta_dtype}")
    _packages(cfg)
    if cfg.sampler == "alias":
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

    def epoch(phi, psi, wl, dl, uid, z, alpha, beta, seed: int):
        theta, d_sub = _rebuild_theta(dl.reshape(-1), z.reshape(-1), wl.reshape(-1) >= 0,
                                      dl[0, 0], cfg)
        _, _, _, z_new = _sample_subblock(phi[0], psi, theta, wl[0, 0], d_sub, z[0, 0],
                                          uid[0, 0], alpha, beta, int(seed), cfg)
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


def device_counts(sc: ShardedCorpus, n_topics: int, device="cuda", phi=None, psi=None):
    """Accumulate one segment's z0 into (phi [M, rows, K], psi [K]) int32 on
    ``device`` — ``host_counts`` on the device, so a full-width Φ never passes
    through host memory. Pass the previous segment's output back in to fold
    several segments into one global count state (the streamed session's
    initial model). The stacks may be read-only mmaps: they are copied."""
    dev = resolve_device(device)
    wl = torch.from_numpy(np.array(sc.word_local, np.int32)).to(dev)
    z = torch.from_numpy(np.array(sc.z0, np.int32)).to(dev)
    return _count(wl, z, sc.rows_per_shard, n_topics, phi, psi)


def _count(wl, z, rows: int, n_topics: int, phi=None, psi=None):
    """Add the (word, topic) counts of the valid slots of [S, M, cap] device
    stacks into int32 (phi, psi), made zero when not given."""
    dev, M = wl.device, wl.shape[1]
    if phi is None:
        phi = torch.zeros((M, rows, n_topics), dtype=torch.int32, device=dev)
    if psi is None:
        psi = torch.zeros((n_topics,), dtype=torch.int32, device=dev)
    valid = wl >= 0
    m_of = torch.arange(M, device=dev)[None, :, None].expand_as(wl)
    zv = z[valid].long()
    one = torch.ones_like(zv, dtype=torch.int32)
    phi.index_put_((m_of[valid], wl[valid].long(), zv), one, accumulate=True)
    psi.index_put_((zv,), one, accumulate=True)
    return phi, psi


def device_arrays(sc: ShardedCorpus, n_topics: int, device="cuda"):
    """Host → device: the [S, M, cap] stacks and phi/psi counted from z0.

    The counts are the same as ``host_counts``'s, accumulated on the device
    (int32 ``index_put_``), so a full-width Φ never passes through host
    memory. Returns (phi [M, rows, K] int32, psi [K] int32, word_local,
    doc_local, uid int64, z0).
    """
    dev = resolve_device(device)
    # copies (np.array), so that an epoch updating z in place on the CPU
    # never writes through into the source's z0
    wl = torch.from_numpy(np.array(sc.word_local, np.int32)).to(dev)
    dl = torch.from_numpy(np.array(sc.doc_local, np.int32)).to(dev)
    uid = torch.from_numpy(np.asarray(sc.uid).astype(np.int64)).to(dev)
    z = torch.from_numpy(np.array(sc.z0, np.int32)).to(dev)
    phi, psi = _count(wl, z, sc.rows_per_shard, n_topics)
    return phi, psi, wl, dl, uid, z


def gather_phi(phi_sharded: torch.Tensor, sc: ShardedCorpus) -> torch.Tensor:
    """The global [V, K] phi reassembled from ring shards (eval, serving), on
    the device of ``phi_sharded``."""
    dev = phi_sharded.device
    shard = torch.from_numpy(np.asarray(sc.shard_of_word, np.int64)).to(dev)
    local = torch.from_numpy(np.asarray(sc.local_of_word, np.int64)).to(dev)
    return phi_sharded[shard, local]
