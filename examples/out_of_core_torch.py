"""Out-of-core training on the PyTorch port: save a segmented corpus, stream
it from disk.

    PYTHONPATH=src python examples/out_of_core_torch.py               # on the card
    PYTHONPATH=src python examples/out_of_core_torch.py --device cpu

Twin of ``examples/out_of_core.py``. The paper's Fig. 3/4 loop — LoadShard
/ sample / SaveShard — as a user workflow: build a corpus once,
``save_segments`` it into a DiskSource directory, then train with only one
segment's tokens resident at a time while a background thread prefetches
the next segment. The streamed model is bit for bit the resident one; corpus
scale becomes a config knob (``n_segments``) instead of a memory limit.
"""
import argparse
import json
import shutil
import tempfile

import numpy as np

BASE = dict(n_docs=1500, vocab_size=500, n_topics=16, true_topics=12,
            doc_len_mean=10, n_epochs=6, alpha_opt_from=3)


def main(device="cuda"):
    import torch

    from repro_torch import kernels, resolve_device
    from repro_torch.data import open_segments, save_segments
    from repro_torch.training import Metrics, Trainer, TrainerConfig

    dev = resolve_device(device)
    kernels.reset_launch_counts()
    base = dict(BASE, device=dev.type)

    # --- 1. resident reference: 4 in-memory segments --------------------
    mem = Trainer(TrainerConfig(n_segments=4, **base), callbacks=[Metrics()])
    mem.fit()

    # --- 2. persist the segmentation as a DiskSource directory ----------
    corpus_dir = tempfile.mkdtemp(prefix="peacock_segments_")
    try:
        save_segments(mem.source, corpus_dir)
        src = open_segments(corpus_dir)
        print(f"[save] {corpus_dir}: {src.describe()}")

        # --- 3. stream it back, out of core, prefetch overlapped --------
        disk = Trainer(TrainerConfig(corpus_dir=corpus_dir, prefetch=True, **base),
                       callbacks=[Metrics()])
        disk.fit()
    finally:
        shutil.rmtree(corpus_dir, ignore_errors=True)

    # --- 4. the streamed model is bit for bit the resident model ----------
    same_phi = bool(torch.equal(mem.state[0], disk.state[0]))
    same_z = bool((mem._z == disk._z).all())
    print(f"[check] streamed == resident: phi {same_phi}, z {same_z}")
    assert same_phi and same_z, "the streamed model differs from the resident one"
    seg_s = disk.metrics["segment_s"]
    print(f"[stream] {len(seg_s)} segment swaps, "
          f"{np.mean(seg_s) * 1e3:.1f} ms/segment (prefetch overlapped) on {dev}")
    launches = kernels.launch_counts()
    print(f"[launches] {json.dumps(launches)}")
    return dict(phi=mem.state[0].cpu().numpy(), psi=mem.state[1].cpu().numpy(),
                z=np.asarray(mem._z).copy(), alpha=mem.alpha.cpu().numpy(),
                disk_phi=disk.state[0].cpu().numpy(), launches=launches)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
