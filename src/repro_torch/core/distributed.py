"""Peacock layer 1: the diagonal-ring distributed Gibbs sampler (port of
``repro.core.distributed``), one process per rank.

Every rank of the flattened ("data", "model") ring is one Peacock data server
(it owns one document shard's token stack) and one sampling server (it owns
one vocabulary shard of Φ). The M×M block-diagonal schedule is a ring
rotation: in round r rank v samples the sub-block of data shard (v−r) mod M
whose words live in its vocab shard v, against its resident Φ_v, then
forwards the visiting stack one hop. Θ is never stored: each visiting stack
carries its z, and the doc-topic state of the visiting shard is rebuilt per
round. Ψ's deltas are summed once an epoch. With word-sharded model
parallelism (``model_shards = P > 1``) the ring rotates over "data" only and
each "model" rank holds rows/P of its coarse shard's Φ (see
``build_epoch_body``). A ring of one device (``layout=None``) is the M = 1
case, with every collective the identity; ``Trainer`` runs it on one device.

Both sampler families:

- ``sampler="dense"``: Θ rebuilt as a count plane (dense [docs, K], or
  ``small_theta``'s [cap+1, K] over the sampled docs, int32 or int8), each
  package drawn by the fused Gumbel-max scan ``gibbs_argmax`` over [L, K]
  planes with the token's own assignment removed (¬ivd);
- ``sampler="alias"``: Θ as sparse (topic, count) pairs and the alias-MH
  probe ``mh_resample`` against stale proposal tables.

¬ivd in the dense family has two forms. By default ψ goes to the kernel as an
[L, K] plane with 1 taken off at (t, z_t), like Φ and Θ. With
``column_exclusion`` ψ goes as its [K] row and its self-exclusion is folded
into Φ's z column, (φ+β)·(ψ_z+Vβ)/(ψ_z−1+Vβ) − β: the form of the JAX
package's kernel branch, taken here on every device. (The JAX package's plain
branch adds a log difference instead, which can differ in the last ulp.)

The global layout is the JAX package's (``specs``): phi [M, rows, K] int32,
psi [K] int32, stacks [S, M, cap] (word_local, doc_local, uid, z) and, for
the alias family, the tables appended after the seed (wq/wp/wa shaped like
phi, ap/aa [K]); pods add a leading [pods] dim. A rank holds the block JAX's
``shard_map`` hands the device of its coordinate (``rank_arrays``,
``repro_torch.dist.sharding.local_view``). uid is int64 holding uint32
values. An epoch updates its arguments in place. Θ is weighted by the
stack's valid mask; the ring has no sentinel rollback (padding tokens keep
their z and move no count).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import gibbs, sparse
from repro_torch.data.corpus import ShardedCorpus
from repro_torch.dist import collectives as coll, sharding as shd
from repro_torch.dist.sharding import RankLayout
from repro_torch.kernels.alias import ops as alias_ops
from repro_torch.kernels.gibbs import ops as gibbs_ops

_M32 = 0xFFFF_FFFF


@dataclasses.dataclass(frozen=True)
class RingConfig:
    n_topics: int
    vocab_size: int            # global V (for the V*beta smoothing term)
    rows_per_shard: int
    docs_per_shard: int
    cap: int                   # tokens per (data, vocab) sub-block
    package_len: int           # L — pipeline package size (§3.1.2)
    n_rounds: int = 1          # = ring size M
    model_shards: int = 1      # P — word-sharded model parallelism: P > 1
                               # rotates over "data" only and keeps Φ row
                               # slices resident on "model"; rows_per_shard
                               # and cap stay the totals (P·rpm, P·capb)
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


def specs(model_shards: int = 1, pod_axis: bool = False) -> dict:
    """The JAX package's layout of each epoch argument (``phi``, ``psi``, the
    ``stack`` arrays and the alias word ``tables``) for a ring with
    ``model_shards`` slices, with or without the pod axis."""
    if model_shards > 1:
        phi_s, stk_s = ((shd.pod_wshard_spec(), shd.pod_wshard_stack_spec()) if pod_axis
                        else (shd.wshard_spec(), shd.wshard_stack_spec()))
    else:
        phi_s = stk_s = shd.pod_ring_spec() if pod_axis else shd.ring_spec()
    return {"phi": phi_s, "psi": shd.pod_spec() if pod_axis else shd.replicated(),
            "stack": stk_s, "tables": phi_s}


def model_gather(planes: torch.Tensor, layout: RankLayout) -> torch.Tensor:
    """[n, M, capb] stacked bucket views → [n, M, P·capb] whole sub-blocks,
    bucket-major (model rank j's bucket at [j·capb, (j+1)·capb)): the P = 1
    layout. One ``all_gather`` over "model" carries every plane; JAX ships
    the same planes as (P − 1) ``ppermute`` hops each (ROADMAP §3)."""
    g = coll.all_gather(planes, layout, "model")              # [P, n, M, capb]
    return g.permute(1, 2, 0, 3).reshape(planes.shape[0], planes.shape[1], -1)


def build_epoch_body(cfg: RingConfig, layout: Optional[RankLayout] = None,
                     pod_axis: bool = False):
    """One rank's ring epoch: THE round loop, for one device (``layout=None``)
    and for every rank of a ring, word-sharded or not, in a pod or not.

    ``epoch(phi, psi, wl, dl, uid, z, alpha, beta, seed, *tables)`` takes
    this rank's views (phi [1, rows(/P), K], psi [K], stacks [1, M,
    cap(/P)]; with ``pod_axis`` one more leading singleton dim and psi [1,
    K]) and returns them updated in place. ``tables`` is empty for
    ``sampler="dense"`` and (wq, wp, wa, ap, aa) for ``sampler="alias"``
    (wq/wp/wa shaped like phi, ap/aa [K]).

    Each of the M rounds (M = the flattened ring, or the data ring when
    ``cfg.model_shards = P > 1``): post the one-hop shift of the immutable
    stack (wl, dl, uid) for the next round, rebuild Θ (or the pairs) from
    the whole visiting stack, sample this rank's sub-block (index ``me``)
    against its resident Φ, ship z after its update. With P > 1 every rank
    samples only its bucket against its slice of rows (words rebased by
    −j·rows/P); Θ needs the whole visiting stack's (doc, z), all-gathered
    over "model" in bucket-major order (``model_gather``), and Ψ's round
    deltas are summed over "model" every round, so every draw equals the
    P = 1 ring's. A ring of one rank (M = 1) ships nothing. At the end
    Ψ's deltas are summed over the rotation group. ``pod_axis`` offsets the
    seed by pod · 0x9E3779B9 (mod 2³²) so the pods' samplers decorrelate.
    """
    if cfg.sampler not in ("dense", "alias"):
        raise ValueError(f"sampler must be 'dense' or 'alias', got {cfg.sampler!r}")
    if cfg.theta_dtype not in (torch.int32, torch.int8):
        raise ValueError(f"theta_dtype must be torch.int32 or torch.int8, got {cfg.theta_dtype}")
    Pm = cfg.model_shards
    cfg_l = cfg
    if layout is None:
        if cfg.n_rounds != 1 or Pm != 1 or pod_axis:
            raise ValueError(
                f"n_rounds={cfg.n_rounds}, model_shards={Pm}, pod_axis={pod_axis}: a ring "
                "of several ranks needs a RankLayout (repro_torch.launch.mesh.init_ranks)")
        M, rot = 1, None
    elif Pm > 1:
        if shd.model_axis_size(layout) != Pm:
            raise ValueError(f"the mesh's model axis ({layout.model}) must equal "
                             f"model_shards ({Pm})")
        if cfg.rows_per_shard % Pm or cfg.cap % Pm:
            raise ValueError("rows/cap must be padded to model_shards (shard_corpus does this)")
        if cfg.package_len != cfg.cap:
            raise ValueError("word-sharded rounds sample one package (package_len must = cap)")
        M, rot = shd.data_ring_size(layout), "data"
        rpm = cfg.rows_per_shard // Pm
        cfg_l = dataclasses.replace(cfg, cap=cfg.cap // Pm, package_len=cfg.cap // Pm)
    else:
        M, rot = shd.ring_size(layout), "ring"
    if cfg.n_rounds != M:
        raise ValueError(f"n_rounds={cfg.n_rounds} must equal the ring size {M}")
    _packages(cfg_l)
    lead = 2 if pod_axis else 1
    alias = cfg.sampler == "alias"
    cap_p = cfg.doc_topic_cap or cfg.n_topics

    def epoch(phi, psi, wl, dl, uid, z, alpha, beta, seed, *tables):
        if len(tables) != (5 if alias else 0):
            raise TypeError(f"the {cfg.sampler} epoch takes {5 if alias else 0} tables, "
                            f"got {len(tables)}")
        seed = int(seed) & _M32
        if layout is None:
            me = 0
        else:
            me = layout.data_index if Pm > 1 else shd.flat_ring_index(layout)
            if pod_axis:
                seed = (seed + layout.pod_index * 0x9E37_79B9) & _M32
        sq = lambda a: a.view(a.shape[lead:])
        phi_l, psi_l = sq(phi), psi.view(psi.shape[lead - 1:])
        tabs = None
        if alias:
            wq, wp, wa, ap, aa = tables
            tabs = sparse.AliasTables(sq(wq), sq(wp), sq(wa), ap, aa)
        wl_c, dl_c, uid_c, z_c = (sq(a) for a in (wl, dl, uid, z))      # [M, cap]
        psi0 = psi_l.clone() if layout is not None else None
        for _ in range(M):
            psi_r0 = psi_l.clone() if Pm > 1 else None
            nxt = coll.Shift(layout, rot, [wl_c, dl_c, uid_c]) if M > 1 else None
            if Pm > 1:
                # Θ/pairs need the whole visiting stack's (doc, z): the valid
                # mask rides as doc = −1 (pads carry doc 0, so max(·, 0)
                # restores the P = 1 flat views exactly)
                flat_d, flat_z = model_gather(
                    torch.stack([torch.where(wl_c >= 0, dl_c, -1), z_c]), layout).reshape(2, -1)
                flat_valid = flat_d >= 0
                flat_d = torch.clamp(flat_d, min=0)
            else:
                flat_d, flat_z = dl_c.reshape(-1), z_c.reshape(-1)
                flat_valid = wl_c.reshape(-1) >= 0
            w_sub, d_sub, u_sub, z_sub = wl_c[me], dl_c[me], uid_c[me], z_c[me]
            if Pm > 1:
                w_sub = torch.where(w_sub >= 0, w_sub - layout.model_index * rpm, w_sub)
            if alias:
                pairs = sparse.pairs_from_assignments(flat_d, flat_z, flat_valid,
                                                      cfg.docs_per_shard, cap_p)
                z_new = _sample_subblock_mh(phi_l, psi_l, pairs, w_sub, d_sub, z_sub, u_sub,
                                            alpha, beta, seed, cfg_l, tabs)[3]
            else:
                theta, d_loc = _rebuild_theta(flat_d, flat_z, flat_valid, d_sub, cfg_l)
                z_new = _sample_subblock(phi_l, psi_l, theta, w_sub, d_loc, z_sub, u_sub,
                                         alpha, beta, seed, cfg_l)[3]
                del theta
            if Pm > 1:
                # each slice applied only its bucket's deltas: their sum over
                # "model" is the P = 1 ring's round-end Ψ
                d_psi = coll.all_reduce_(psi_l - psi_r0, layout, "model")
                torch.add(psi_r0, d_psi, out=psi_l)
            if M > 1:
                z_upd = z_c.clone()
                z_upd[me] = z_new
                wl_c, dl_c, uid_c = nxt.wait()
                (z_c,) = coll.shift(layout, rot, [z_upd])
            else:
                z_c[me] = z_new
        if layout is not None:
            # relaxed per-epoch Ψ synchronization over the rotation group
            # (with P > 1 the model ranks are already replicas)
            d_psi = coll.all_reduce_(psi_l - psi0, layout, rot)
            torch.add(psi0, d_psi, out=psi_l)
        if M > 1:
            # after M hops every stack is home again: only its z changed
            sq(z).copy_(z_c)
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


# ------------------------------------------------------------ rank state ---


def _shard_of_rank(rows_per_shard: int, n_model_shards: int, layout: RankLayout):
    """(vocab shard m, model slice j, rows per slice) this rank owns Φ rows of."""
    if n_model_shards > 1:
        return layout.data_index, layout.model_index, rows_per_shard // n_model_shards
    return shd.flat_ring_index(layout), 0, rows_per_shard


def rank_counts(stacks: Sequence, n_topics: int, rows_per_shard: int, n_model_shards: int,
                layout: RankLayout, device="cuda"):
    """This rank's Φ rows [rows/P, K] and Ψ [K] (int32, on ``device``)
    counted from global (word_local, z) [S, M, cap] stacks, one pair per pod:
    the tokens of the rank's vocab shard (and, with P > 1, of its bucket),
    word ids rebased to the rank's slice."""
    dev = resolve_device(device)
    P = n_model_shards
    m, j, rows = _shard_of_rank(rows_per_shard, P, layout)
    phi = torch.zeros((rows, n_topics), dtype=torch.int32, device=dev)
    psi = np.zeros((n_topics,), np.int64)
    for wl, z0 in stacks:
        wl, z0 = np.asarray(wl), np.asarray(z0)
        capb = wl.shape[-1] // P
        w, zz = wl[:, m, j * capb:(j + 1) * capb], z0[:, m, j * capb:(j + 1) * capb]
        ok = w >= 0
        w = torch.from_numpy((w[ok] - j * rows).astype(np.int64)).to(dev)
        zt = torch.from_numpy(zz[ok].astype(np.int64)).to(dev)
        phi.index_put_((w, zt), torch.ones_like(w, dtype=torch.int32), accumulate=True)
        psi += np.bincount(z0[wl >= 0], minlength=n_topics)
    return phi, torch.from_numpy(psi.astype(np.int32)).to(dev)


def rank_arrays(scs: Sequence[ShardedCorpus], n_topics: int, layout: RankLayout,
                device="cuda", pod_axis: bool = False):
    """This rank's views of the JAX package's global state: (phi [1, rows/P,
    K] int32, psi [K] int32, word_local, doc_local, uid int64, z0 [1, M,
    cap/P]); with ``pod_axis`` one more leading singleton dim and psi [1, K].

    ``scs`` holds one sharded corpus per pod (one for a single pod); the
    rank's stacks are its pod's, and Φ/Ψ are the counts of every pod's z0
    (``init_pod_state``: every pod starts from the global replica). Φ rows
    are counted on the device from this rank's column of the stacks, so a
    full-width Φ never passes through host memory.
    """
    dev = resolve_device(device)
    sc = scs[layout.pod_index if pod_axis else 0]
    P = int(getattr(sc, "n_model_shards", 1))
    phi, psi_t = rank_counts([(s.word_local, s.z0) for s in scs], n_topics, sc.rows_per_shard,
                             P, layout, dev)
    stk_spec = specs(P)["stack"]
    view = lambda a, dt: torch.from_numpy(
        np.array(shd.local_view(np.asarray(a), stk_spec, pod_layout(layout)), dt)).to(dev)
    stacks = [view(sc.word_local, np.int32), view(sc.doc_local, np.int32),
              view(sc.uid, np.int64), view(sc.z0, np.int32)]
    phi = phi[None]
    if pod_axis:
        phi, psi_t, stacks = phi[None], psi_t[None], [a[None] for a in stacks]
    return (phi, psi_t, *stacks)


def gather_views(x: torch.Tensor, layout: RankLayout, group: str = "world", dst: int = 0):
    """Every member's ``x`` (same shape everywhere) as host numpy arrays in
    group order on the group's ``dst``-th member; ``None`` on the others.
    A collective: every member of the group calls it."""
    import torch.distributed as dist

    g, ranks = layout.group(group)
    if len(ranks) == 1:
        return [x.detach().cpu().numpy()]
    t = x.detach().contiguous()
    if layout.backend != "nccl":
        t = t.cpu()
    root = layout.rank == ranks[dst]
    bufs = [torch.empty_like(t) for _ in ranks] if root else None
    dist.gather(t, bufs, dst=ranks[dst], group=g)
    return [b.cpu().numpy() for b in bufs] if root else None


def pod_layout(layout: RankLayout) -> RankLayout:
    """The one-pod mesh of this rank's pod (for cutting and assembling the
    views of one configuration)."""
    return dataclasses.replace(layout, pods=1, rank=layout.rank % (layout.data * layout.model),
                               groups=None)


def gather_phi_ranks(phi: torch.Tensor, sc: ShardedCorpus, layout: RankLayout,
                     pod_axis: bool = False):
    """The global [V, K] Φ of pod 0, assembled from its ranks' views, on
    rank 0 (on the device of ``phi``); ``None`` on the other ranks. A
    collective over the world."""
    views = gather_views(phi, layout)
    if views is None:
        return None
    P = int(getattr(sc, "n_model_shards", 1))
    spec = specs(P)["phi"]
    lead = 2 if pod_axis else 1
    pod0 = [v.reshape(v.shape[lead - 1:]) for v in views[:layout.data * layout.model]]
    full = shd.assemble(pod0, spec, pod_layout(layout))          # [M, rows, K]
    return gather_phi(torch.from_numpy(full).to(phi.device), sc)


def ring_word_log_likelihood(phi: torch.Tensor, psi: torch.Tensor, beta, sc: ShardedCorpus,
                             layout: RankLayout) -> float:
    """``lda.word_log_likelihood`` of this rank's pod, from the ranks' rows:
    each rank sums lnΓ(φ+β) − lnΓ(β) over its rows that hold a word, and the
    pod's ring sums the [K] parts. A collective over the pod's ring; the
    same value as the gathered Φ's up to the order of the f32 sums."""
    from repro_torch.core import lda

    K = phi.shape[-1]
    phi_l = phi.reshape(-1, K)
    m, j, rows = _shard_of_rank(sc.rows_per_shard, int(getattr(sc, "n_model_shards", 1)),
                                layout)
    owned = (np.asarray(sc.shard_of_word) == m)
    local = np.asarray(sc.local_of_word)[owned] - j * rows
    local = local[(local >= 0) & (local < rows)]
    idx = torch.from_numpy(np.sort(local).astype(np.int64)).to(phi.device)
    beta = torch.as_tensor(beta, dtype=torch.float32, device=phi.device)
    part = torch.zeros(K, dtype=torch.float32, device=phi.device)
    lg_beta = torch.lgamma(beta)
    for lo in range(0, idx.numel(), lda.LL_ROWS):
        r = torch.lgamma(phi_l[idx[lo:lo + lda.LL_ROWS]].to(torch.float32) + beta)
        part += (r - lg_beta).sum(dim=0)
    coll.all_reduce_(part, layout, "ring")
    vb = sc.vocab_size * beta
    per_topic = torch.lgamma(vb) - torch.lgamma(psi.reshape(-1).to(torch.float32) + vb) + part
    return float(per_topic.sum())
