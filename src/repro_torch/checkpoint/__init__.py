"""Checkpoint I/O, the checkpoint manager and versioned serving snapshots
(port of ``repro.checkpoint``; the on-disk layout is the JAX package's, so
checkpoints and snapshots cross between the two packages)."""
