"""Atomic checkpoint I/O — npz-based (port of ``repro.checkpoint.io``).

Guarantees: a checkpoint directory either contains a complete, fsynced payload
+ manifest, or is invisible to readers (write to a tmp dir then rename — rename
is atomic on POSIX). Corrupt/partial checkpoints from a crash are skipped by
``is_complete`` because their manifest is absent.

The layout is the JAX package's: ``arrays.npz`` holds one ``leaf_{i}`` per
leaf and ``manifest.json`` holds ``n_leaves``, ``meta`` and the SHA-256 of
the payload. Leaves are numbered in ``jax.tree.flatten``'s order (dict keys
sorted, tuples and lists in order, ``None`` holding no leaf), so a checkpoint
written by either package loads in the other. Tensor leaves are written
through ``.cpu().numpy()``; ``load`` returns numpy leaves.

Integrity: ``load`` verifies the payload's SHA-256 before deserializing and
raises :class:`IntegrityError` on a mismatch. Manifests without a ``sha256``
key load unverified.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"
PAYLOAD = "arrays.npz"


class IntegrityError(OSError):
    """Payload bytes do not match the manifest's SHA-256 — the artifact is
    corrupt (torn write / bit rot), not merely missing. Subclasses
    ``OSError`` so transient-IO handlers still catch it; callers that can
    quarantine catch it first and retire the artifact.

    ``version`` is stamped by ``snapshots.load_snapshot`` so a delta
    chain's corrupt link is attributed to the right snapshot version."""

    def __init__(self, message: str, *, path: str = ""):
        super().__init__(message)
        self.path = path
        self.version: int | None = None


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def verify(path: str) -> None:
    """Check every payload file under ``path`` against the manifest's
    recorded SHA-256. No-op for pre-integrity manifests. Raises
    :class:`IntegrityError` on the first mismatch."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    for name, want in manifest.get("sha256", {}).items():
        fpath = os.path.join(path, name)
        got = sha256_file(fpath)
        if got != want:
            raise IntegrityError(
                f"checkpoint payload {fpath} is corrupt: "
                f"sha256 {got[:12]}… != manifest {want[:12]}…",
                path=fpath)


def leaves(tree) -> Iterator[Any]:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from leaves(x)
    else:
        yield tree


def unflatten(like, new_leaves: List[Any]):
    """``like``'s structure with its leaves replaced, in order, by ``new_leaves``."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):       # a NamedTuple
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


def to_numpy(x) -> np.ndarray:
    """A host numpy view of one leaf (tensor, numpy array or Python scalar)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def host_copy(tree):
    """``tree`` with every leaf copied into host memory as a numpy array: a
    snapshot the caller may mutate afterwards without touching it."""
    return unflatten(tree, [np.array(to_numpy(x)) for x in leaves(tree)])


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {f"leaf_{i}": to_numpy(x) for i, x in enumerate(leaves(tree))}


def save(path: str, tree, meta: dict | None = None) -> None:
    """Atomically write a tree checkpoint to ``path`` (a directory)."""
    arrays = _flatten(tree)
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=parent)
    try:
        with open(os.path.join(tmp, PAYLOAD), "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        digests = {PAYLOAD: sha256_file(os.path.join(tmp, PAYLOAD))}
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump({"n_leaves": len(arrays), "meta": meta or {},
                       "sha256": digests}, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load(path: str, like) -> Tuple[Any, dict]:
    """Restore a tree saved by ``save`` (by either package); ``like`` gives
    the structure. Returns (tree of numpy arrays, meta)."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    verify(path)
    data = np.load(os.path.join(path, PAYLOAD))
    n = len(list(leaves(like)))
    if manifest["n_leaves"] != n:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected {n}")
    return unflatten(like, [data[f"leaf_{i}"] for i in range(n)]), manifest["meta"]


def is_complete(path: str) -> bool:
    return os.path.isfile(os.path.join(path, MANIFEST)) and os.path.isfile(
        os.path.join(path, PAYLOAD))
