"""Versioned RT-LDA serving snapshots — the artifact the publish pipeline
ships (port of ``repro.checkpoint.snapshots``; same layout, so a snapshot
published by either package loads in the other).

Layout (one directory per published model version):

    <root>/v_<n>/arrays.npz      — pvk / alpha / r_topic / r_value payload
    <root>/v_<n>/manifest.json   — version, source epoch, dedup stats

Writers (``repro_torch.training.ModelPublisher``) call :func:`save_snapshot`;
readers poll :func:`snapshot_versions` and :func:`load_snapshot`. ``io.save``
writes to a tmp dir and renames, so a version directory is either complete
(manifest + payload present) or invisible.

**Delta snapshots**: :func:`save_delta_snapshot` writes just the changed Φ
rows plus the small alpha/r_topic/r_value vectors, with a ``base_version``
pointer in the manifest; :func:`load_snapshot` reconstructs the full model
by walking the base chain. :func:`rotate_snapshots` keeps base versions
alive transitively.

**Fault seam**: every version a load reads first passes
``faults.hit("snapshot.load", key=str(version))``
(:mod:`repro_torch.reliability.faults`), as in the JAX loader.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import List, Optional

import numpy as np

from repro_torch.checkpoint import io
from repro_torch.reliability import faults

_SNAP_RE = re.compile(r"v_(\d+)")
# quarantined versions are renamed to "<dir>.corrupt[.N]" — a name
# _SNAP_RE.fullmatch rejects, so they become invisible to
# snapshot_versions/rotation while staying on disk for forensics
_QUARANTINE_SUFFIX = ".corrupt"
# dict payloads (not the RTLDAModel dataclass) so readers can build the
# ``like`` tree without knowing leaf shapes up front
_LIKE = {"pvk": 0, "alpha": 0, "r_topic": 0, "r_value": 0}
_DELTA_LIKE = {"row_idx": 0, "rows": 0,
               "alpha": 0, "r_topic": 0, "r_value": 0}


def snapshot_path(root: str, version: int) -> str:
    return os.path.join(root, f"v_{version:06d}")


def snapshot_versions(root: str) -> List[int]:
    """Sorted complete snapshot versions under ``root`` (incomplete/foreign
    directories are invisible, exactly like partial checkpoints)."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _SNAP_RE.fullmatch(name)
        if m and io.is_complete(os.path.join(root, name)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_version(root: str) -> Optional[int]:
    versions = snapshot_versions(root)
    return versions[-1] if versions else None


def save_snapshot(root: str, version: int, model, meta: dict | None = None
                  ) -> str:
    """Atomically publish ``model`` (an ``RTLDAModel``) as version ``version``.
    Returns the snapshot directory path."""
    meta = dict(meta or {})
    meta["version"] = int(version)
    tree = {"pvk": model.pvk, "alpha": model.alpha,
            "r_topic": model.r_topic, "r_value": model.r_value}
    path = snapshot_path(root, version)
    io.save(path, tree, meta)
    return path


def save_delta_snapshot(root: str, version: int, model, base_version: int,
                        base_pvk, meta: dict | None = None) -> str:
    """Atomically publish only the Φ rows that changed against ``base_pvk``
    (the payload of ``base_version``); the O(V+K) vectors ship in full. The
    manifest records ``meta["delta"] = {base_version, n_rows, n_rows_total}``.

    Raises ``ValueError`` on a Φ shape change (topic count moved under
    dedup/merge) — the caller must fall back to a full snapshot.
    """
    new = io.to_numpy(model.pvk)
    base = io.to_numpy(base_pvk)
    if new.shape != base.shape:
        raise ValueError(
            f"delta base shape {base.shape} != new shape {new.shape}; "
            "publish a full snapshot instead")
    row_idx = np.flatnonzero(np.any(new != base, axis=1)).astype(np.int32)
    meta = dict(meta or {})
    meta["version"] = int(version)
    meta["delta"] = {"base_version": int(base_version),
                     "n_rows": int(row_idx.size),
                     "n_rows_total": int(new.shape[0])}
    tree = {"row_idx": row_idx, "rows": new[row_idx],
            "alpha": model.alpha, "r_topic": model.r_topic,
            "r_value": model.r_value}
    path = snapshot_path(root, version)
    io.save(path, tree, meta)
    return path


def read_meta(root: str, version: int) -> dict:
    """Manifest ``meta`` of one complete snapshot (cheap: no payload read)."""
    with open(os.path.join(snapshot_path(root, version), io.MANIFEST)) as f:
        return json.load(f)["meta"]


def _load_tree(root: str, version: int, like):
    try:
        return io.load(snapshot_path(root, version), like)
    except io.IntegrityError as exc:
        # attribute the corruption to THIS version (unless a recursive base
        # load already attributed it deeper in the chain)
        if exc.version is None:
            exc.version = int(version)
        raise


def _load_arrays(root: str, version: int):
    """(pvk, alpha, r_topic, r_value) numpy arrays and meta of one version,
    walking the delta chain. Each version of the chain passes the
    ``snapshot.load`` fault seam before its meta is read, as in the JAX
    package."""
    if faults._PLANE is not None:
        faults.hit("snapshot.load", key=str(version))
    meta = read_meta(root, version)
    if "delta" not in meta:
        tree, meta = _load_tree(root, version, _LIKE)
        return (tree["pvk"], tree["alpha"], tree["r_topic"], tree["r_value"]), meta
    base_version = int(meta["delta"]["base_version"])
    if not io.is_complete(snapshot_path(root, base_version)):
        raise FileNotFoundError(
            f"delta snapshot v_{version:06d} needs base v_{base_version:06d} "
            f"which is missing under {root} (rotated without its delta?)")
    (pvk, _, _, _), _ = _load_arrays(root, base_version)
    tree, meta = _load_tree(root, version, _DELTA_LIKE)
    pvk = np.array(pvk)                    # writable copy of the base Φ
    pvk[tree["row_idx"]] = tree["rows"]
    return (pvk, tree["alpha"], tree["r_topic"], tree["r_value"]), meta


def load_snapshot(root: str, version: Optional[int] = None, device="cuda"):
    """Load one published model onto ``device``. Returns ``(RTLDAModel,
    meta)``; ``version`` defaults to the latest complete snapshot. Delta
    snapshots are resolved transparently by walking the base chain."""
    from repro_torch.convert import rtlda_model_from_numpy

    if version is None:
        version = latest_version(root)
        if version is None:
            raise FileNotFoundError(f"no complete snapshots under {root}")
    arrays, meta = _load_arrays(root, version)
    return rtlda_model_from_numpy(*arrays, device), meta


def quarantine_snapshot(root: str, version: int) -> Optional[str]:
    """Retire a corrupt snapshot: rename its directory to a name
    ``snapshot_versions`` can never match (``v_NNNNNN.corrupt``), keeping
    the bytes on disk. Idempotent and race-safe. Returns the quarantine
    path, or ``None`` if the version had already vanished."""
    src = snapshot_path(root, version)
    dst = src + _QUARANTINE_SUFFIX
    n = 0
    while os.path.exists(dst):      # re-corruption of a republished version
        n += 1
        dst = f"{src}{_QUARANTINE_SUFFIX}.{n}"
    try:
        os.rename(src, dst)
        return dst
    except OSError:
        return None                 # lost the race (or src already gone)


def rotate_snapshots(root: str, keep: int) -> List[int]:
    """Delete all but the newest ``keep`` versions — plus, transitively, any
    older version still referenced as a delta base by a kept one. Returns
    deleted versions."""
    versions = snapshot_versions(root)
    if keep <= 0:
        return []
    present = set(versions)
    keepset = set(versions[-keep:])
    frontier = list(keepset)
    while frontier:
        try:
            meta = read_meta(root, frontier.pop())
        except OSError:
            continue                 # raced a concurrent rotation; harmless
        delta = meta.get("delta")
        if delta is not None:
            base = int(delta["base_version"])
            if base in present and base not in keepset:
                keepset.add(base)
                frontier.append(base)
    drop = [v for v in versions if v not in keepset]
    for v in drop:
        shutil.rmtree(snapshot_path(root, v), ignore_errors=True)
    return drop
