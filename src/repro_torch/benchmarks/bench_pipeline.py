"""Table 1: the communication pipeline's L×T trade-off (twin of
``benchmarks/bench_pipeline.py``).

    python -m repro_torch.benchmarks.bench_pipeline [--device cpu]

Two parts:
  1. the calibrated analytical model against the paper's own numbers (the
     model is fit on 3 of the 8 rows and predicts the rest);
  2. a measured package-length sweep of the dense ring of one device
     (``core/distributed.py``): wall-clock seconds an epoch against
     ``package_len`` (the within-round pipeline knob), the qualitative check
     that the optimum is interior, like the paper's curve.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core import pipeline


def table1_model():
    rows = []
    model = pipeline.PipelineModel()
    for lkb, (ours, paper) in pipeline.validate_against_paper(model).items():
        rows.append((lkb, round(ours, 1), paper))
    return rows


def package_len_for(cap: int, most: int) -> int:
    """The largest divisor of ``cap`` not above ``most``."""
    return max(L for L in range(1, min(cap, most) + 1) if cap % L == 0)


def measured_package_sweep(corpus=None, n_topics=16, most=None, epochs=3, device="cuda"):
    """Ring-epoch wall seconds against package length on one device.

    By default JAX's sweep: a 600-doc corpus at K = 16, packages of 8, 64,
    512 and the whole sub-block (those that divide it). ``corpus`` and
    ``n_topics`` set another cell; ``most`` then gives the packages as the
    largest divisors of the sub-block's cap not above each value (the cap
    itself is always swept last). Each length runs one warm-up epoch and
    then ``epochs`` timed ones from fresh counts. Returns [(package_len,
    [epoch seconds])] and the number of tokens an epoch samples.
    """
    from repro_torch.core import distributed as dist
    from repro_torch.data import corpus as corpus_mod, synthetic

    dev = resolve_device(device)
    if corpus is None:
        corpus, _ = synthetic.lda_corpus(seed=0, n_docs=600, n_topics=12, vocab_size=400,
                                         doc_len_mean=12)
    K = n_topics
    sc = corpus_mod.shard_corpus(corpus, 1, 1, K, seed=1, cap_multiple=512)
    cap = sc.word_local.shape[2]
    if most is None:
        lengths = [L for L in (8, 64, 512, cap) if cap % L == 0]
    else:
        lengths = sorted({package_len_for(cap, m) for m in most} | {cap})
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    alpha = torch.full((K,), 3.0, dtype=torch.float32, device=dev)
    beta = torch.tensor(0.01, dtype=torch.float32, device=dev)
    out = []
    for pkg in lengths:
        cfg = dist.RingConfig(n_topics=K, vocab_size=corpus.vocab_size,
                              rows_per_shard=sc.rows_per_shard,
                              docs_per_shard=sc.docs_per_shard, cap=cap, package_len=pkg,
                              n_rounds=1)
        epoch = dist.build_epoch_body(cfg)
        args = dist.device_arrays(sc, K, device=dev)
        epoch(*args, alpha, beta, 1)                        # warm-up
        sync()
        args = None                                         # free Φ before the next copy
        args = dist.device_arrays(sc, K, device=dev)
        secs = []
        for i in range(epochs):
            t0 = time.perf_counter()
            args = epoch(*args, alpha, beta, i)
            sync()
            secs.append(time.perf_counter() - t0)
        args = None
        out.append((pkg, secs))
    return out, corpus.n_tokens


def run(device="cuda"):
    lines = []
    t0 = time.perf_counter()
    rows = table1_model()
    err = max(abs(a - b) for _, a, b in rows)
    lines.append(("pipeline.table1_model_maxerr_min", (time.perf_counter() - t0) * 1e6, err))
    for lkb, ours, paper in rows:
        lines.append((f"pipeline.table1.L{lkb}KB_model_vs_paper_min", 0.0, f"{ours}|{paper}"))
    t0 = time.perf_counter()
    sweep, _ = measured_package_sweep(device=device)
    dt = (time.perf_counter() - t0) * 1e6
    for pkg, secs in sweep:
        lines.append((f"pipeline.ring_epoch.pkg{pkg}", sum(secs) / len(secs) * 1e6, "wall"))
    lines.append(("pipeline.optimal_L_kb", dt, pipeline.optimal_package()))
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description="Table 1 on the PyTorch/CUDA port")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for name, us, derived in run(device=args.device):
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()
