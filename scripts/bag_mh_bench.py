"""Time the CUDA embedding_bag and mh_resample kernels beside other builds.

Needs a CUDA card and nvcc. Run from the root of the checkout:

    python3 scripts/bag_mh_bench.py [--variant NAME=PATH.cu ...]
        [--cases lookup,lookup_1gib,multi_hot,p99,p99_host,cell,cell_cap30]

The committed kernels (``src/repro_torch/csrc/{embedding_bag,mh_resample}.cu``)
always run. Each ``--variant`` is another source with the committed C entry
point of one of the two kernels (the script reads which from the source),
built with the committed flags (``kernel_bench.py`` says how to wrap an
earlier kernel whose entry point differs). Every build must give the
committed kernel's output bit for bit; the script exits nonzero otherwise.

Cases:
- ``lookup``: dlrm-mlperf's bulk gather, 262,144 × 26 bags of one row
  (seeded uniform ids per field, ``chip_smoke.recsys_inputs``) from the full
  187,767,552 × 128 bf16 table (44.77 GiB, N(0, 1/128) from seed 0);
- ``lookup_1gib``: the same ids folded into the table's first GiB
  (id mod 4,194,304 rows), which separates the page walks of a 44.77 GiB
  table from the kernel's own design;
- ``multi_hot``: 262,144 weighted bags of 26 rows (uniform weights);
- ``p99``: the serve_p99 gather, 512 × 26 bags of one, events around the
  host call;
- ``p99_host``: the host's side of that gather, in microseconds a call of
  the committed wrapper (``embedding_bag_cuda``: checks, allocation, path
  choice, launch), of each build's ctypes launch alone (its arguments made
  beforehand) and of the wrapper's path choice alone (``bag_geometry`` and
  the alignment test), each the median of 9 loops of 500 calls (fewer than
  the card's launch queue holds, so the host never waits on the card), each
  loop timed before the synchronize that follows it, in turns;
- ``cell``: one alias-MH package shaped like the alias cell of
  ``chip_smoke.py``: the cell's 747,200 tokens (its corpus tiled 40 times),
  each on a uniform topic, at K = 100,000, V = 32,768, pair cap 14, n_mh 4,
  sorted by word, the tables built from those counts;
- ``cell_cap30``: the same package with a pair cap of 30 (the 32-slot
  register kernel).

After the MH cases a yardstick line times one ``torch.take`` of as many
int32 entries as the last case's distinct sectors, at uniform positions of
its φ: the card's rate for scattered 4-byte reads.

Each case is timed with CUDA events in the order a, b, …, b, a; a pass is the
median of 20 launches after one warm-up. The line
gives the bound beside it: the bytes the case must move (each input read
once, each output written once: for embedding_bag each distinct table row
the case gathers, for the MH probe each distinct 32-byte sector of its table
entries, with the count that charges each gather its own sector beside it)
over 3.35 TB/s.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import sys
import time

import numpy as np
import torch

import kernel_bench as kb

P, I = ctypes.c_void_p, ctypes.c_int
BAG_CASES = ("lookup", "lookup_1gib", "multi_hot", "p99", "p99_host")
MH_CASES = ("cell", "cell_cap30")
FOLD_ROWS = (1 << 30) // 256            # rows of 128 bf16 in one GiB


def bag_launcher(so):
    """fn(table, ids, weights) → out, through the library ``so``."""
    from repro_torch.kernels.embedding_bag.kernel import bag_geometry
    fn = ctypes.CDLL(so).embedding_bag_launch
    fn.argtypes = [P, P, P, ctypes.c_longlong] + [I] * 7 + [P, P]
    fn.restype = I

    def run(table, ids, weights):
        (V, D), (B, F) = table.shape, ids.shape
        out = torch.empty((B, D), dtype=table.dtype, device="cuda")
        t_ptr, o_ptr = table.data_ptr(), out.data_ptr()
        err = fn(t_ptr, ids.data_ptr(), None if weights is None else weights.data_ptr(), B,
                 F, D, 0, 1 if table.dtype == torch.bfloat16 else 0,
                 *bag_geometry(D, table.element_size(), B, F, (t_ptr | o_ptr) % 16 == 0),
                 o_ptr, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"embedding_bag launch failed: CUDA error {err}")
        return out
    run.launch = fn
    return run


def mh_launcher(so):
    """fn(args, seed2, beta, asum, V, n_mh) → z_new, through the library ``so``;
    ``args`` are the tensors phi … uid of ``mh_resample_cuda``."""
    from repro_torch.kernels.alias.kernel import mh_slot_bound
    fn = ctypes.CDLL(so).mh_resample_launch
    fn.argtypes = [P] * 14 + [ctypes.c_uint32, P, P, ctypes.c_float] + [I] * 5 + [P, P]
    fn.restype = I

    def run(args, seed2, beta, asum, V, n_mh):
        K, cap, T = args[0].shape[1], args[2].shape[1], args[10].shape[0]
        out = torch.empty(T, dtype=torch.int32, device="cuda")
        err = fn(*(a.data_ptr() for a in args), seed2, beta.data_ptr(), asum.data_ptr(),
                 float(V), n_mh, T, K, cap, mh_slot_bound(cap), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mh_resample launch failed: CUDA error {err}")
        return out
    return run


def bag_cases(wanted):
    """(name, table, ids, weights, bytes) of each wanted embedding_bag case."""
    from chip_smoke import recsys_inputs
    from repro_torch.configs import recsys_archs as ra
    from repro_torch.models.recsys import _flat_ids
    cfg = ra.DLRM
    rows, D = cfg.embedding.padded_rows, cfg.embedding.dim
    table = torch.empty((rows, D), dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    for lo in range(0, rows, 1 << 22):
        n = min(1 << 22, rows - lo)
        table[lo:lo + n] = torch.randn((n, D), generator=g, device="cuda") / D ** 0.5
    g = torch.Generator(device="cuda").manual_seed(0)
    _, sparse = recsys_inputs("dlrm-mlperf", cfg, 262_144, g)
    flat = _flat_ids(cfg.embedding, sparse)
    B, F = flat.shape
    one = flat.reshape(-1, 1)
    w = torch.rand((B, F), generator=g, device="cuda")
    rows_read = lambda i: int(torch.unique(i).numel()) * D * 2     # distinct rows, once
    folded, p99 = (one % FOLD_ROWS).contiguous(), one[:512 * F].contiguous()
    cases = {"lookup": (one, None, rows_read(one) + B * F * (D * 2 + 4)),
             "lookup_1gib": (folded, None, rows_read(folded) + B * F * (D * 2 + 4)),
             "multi_hot": (flat, w, rows_read(flat) + B * D * 2 + 2 * B * F * 4),
             "p99": (p99, None, rows_read(p99) + 512 * F * (D * 2 + 4)),
             "p99_host": (p99, None, 0)}
    for name in BAG_CASES:
        if name in wanted:
            yield name, table, *cases[name]


def mh_cases(wanted):
    """(name, args, seed2, beta, asum, V, n_mh, bytes) of each wanted MH case."""
    import chip_smoke as cs
    from repro_torch.core import sparse
    from repro_torch.kernels.alias import ops
    K, V = cs.FULL["n_topics"], cs.FULL["vocab"]
    corpus = cs.tile_corpus(cs.full_corpus(), cs.ALIAS["tiles"])
    w = torch.from_numpy(corpus.word_ids).cuda().to(torch.int32)
    d = torch.from_numpy(corpus.doc_ids).cuda().to(torch.int32)
    T, D = w.shape[0], corpus.n_docs
    g = torch.Generator(device="cuda").manual_seed(7)
    z = torch.randint(0, K, (T,), generator=g, device="cuda", dtype=torch.int32)
    phi = torch.zeros((V, K), dtype=torch.int32, device="cuda")
    phi.index_put_((w.long(), z.long()), torch.ones_like(z), accumulate=True)
    psi = torch.bincount(z.long(), minlength=K).to(torch.int32)
    alpha = torch.full((K,), 50.0 / K, device="cuda")
    beta = torch.tensor(0.01, device="cuda")
    tabs = sparse.make_tables(phi, psi, alpha, beta, V)
    uid = torch.arange(T, dtype=torch.int64, device="cuda") * 7 + 3
    order = torch.sort(w, stable=True).indices
    srt = [x[order].contiguous() for x in (w, d, z, uid)]
    seed2, asum, n_mh = ops.mh_seed(7), alpha.sum(), cs.ALIAS["n_mh"]
    valid = torch.ones(T, dtype=torch.bool, device="cuda")
    cap14 = sparse.suggest_cap(corpus.doc_lengths(), K)
    for name, cap in (("cell", cap14), ("cell_cap30", 30)):
        if name not in wanted:
            continue
        tp, ct = sparse.pairs_from_assignments(d, z, valid, D, cap)
        args = (phi, psi, tp, ct, tabs.wq, tabs.wp, tabs.wa, alpha, tabs.ap, tabs.aa, *srt)
        per_gather, distinct = cs.mh_bytes(args, seed2, beta, asum, V, n_mh, D, cap)
        yield (f"{name} (T={T}, cap {cap}; {per_gather / 3.35e9:.4f} ms charging each gather "
               f"its own sector)", args, seed2, beta, asum, V, n_mh, distinct)


def compare(label, fns, call, nbytes):
    """Run every build once (bitwise against the committed one), then time
    them a, b, …, b, a; print one line; return whether all were equal."""
    ref = call(fns["committed"])
    same = {n: torch.equal(call(f), ref) for n, f in fns.items() if n != "committed"}
    ms = kb.in_turns(fns, lambda fn: kb.event_ms(lambda: call(fn), 20))
    bound = nbytes / 3.35e12 * 1e3
    print(f"{label}: {kb.fmt_turns(ms, lambda n, ts: f' (share {bound / min(ts):.3f})')}; "
          f"bound {bound:.4f} ms (bytes); equal to the committed kernel: {same}", flush=True)
    return all(same.values())


def host_cost(table, ids, builds, calls=500):
    """The ``p99_host`` case: host microseconds a call of the committed
    wrapper, of each build's launch alone and of the path choice alone."""
    from repro_torch.kernels.embedding_bag import kernel
    (_, D), (B, F) = table.shape, ids.shape
    out = kernel.embedding_bag_cuda(table, ids)
    t_ptr, o_ptr, i_ptr = table.data_ptr(), out.data_ptr(), ids.data_ptr()
    args = (t_ptr, i_ptr, None, B, F, D, 0, 1,
            *kernel.bag_geometry(D, table.element_size(), B, F, (t_ptr | o_ptr) % 16 == 0),
            o_ptr, torch.cuda.current_stream().cuda_stream)

    def loop_us(fn):
        times = []
        for _ in range(9):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        return float(np.median(times))

    fns = {"wrapper": lambda: kernel.embedding_bag_cuda(table, ids)}
    fns.update({f"launch alone, {name}": functools.partial(run.launch, *args)
                for name, run in builds.items()})
    fns["path choice alone"] = lambda: kernel.bag_geometry(
        D, table.element_size(), B, F, (t_ptr | o_ptr) % 16 == 0)
    us = kb.in_turns(fns, loop_us)
    print(f"embedding_bag p99_host ({B} × {F}): host µs a call: " + "; ".join(
        f"{n} {' / '.join(f'{t:.3f}' for t in ts)}" for n, ts in us.items()), flush=True)


def random_sectors(table, n):
    """A yardstick: one PyTorch gather (``torch.take``) of ``n`` int32 entries
    at uniform positions of ``table``, each in a 32-byte sector of its own,
    timed like the kernels: the card's rate for scattered 4-byte reads."""
    g = torch.Generator(device="cuda").manual_seed(11)
    idx = torch.randint(0, table.numel(), (n,), generator=g, device="cuda")
    ms = kb.event_ms(lambda: torch.take(table, idx), 20)
    print(f"torch.take of {n} int32 at uniform positions of a {table.numel() * 4 / 2**30:.2f} "
          f"GiB table: {ms:.4f} ms, {n * 32 / ms / 1e9:.3f} TB/s of 32-byte sectors",
          flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=PATH of another source with the committed entry point")
    parser.add_argument("--cases", default=",".join(BAG_CASES + MH_CASES))
    args = parser.parse_args()
    if not kb.need_card("bag_mh_bench"):
        return 1
    from repro_torch import kernels
    jobs = kb.start_builds(args.variant, "bag_mh_bench")
    kernels.build(["embedding_bag", "mh_resample"])
    make = {"embedding_bag": bag_launcher, "mh_resample": mh_launcher}
    fns = {k: {"committed": make[k](str(kernels.library_path(k)))} for k in make}
    for name, src, so, proc in jobs:
        kb.finish_build(name, proc)
        with open(src) as f:
            kernel = "embedding_bag" if "embedding_bag_launch" in f.read() else "mh_resample"
        fns[kernel][name] = make[kernel](so)

    wanted = set(args.cases.split(","))
    ok = True
    if wanted & set(BAG_CASES):
        for name, table, ids, w, nbytes in bag_cases(wanted):
            if name == "p99_host":
                host_cost(table, ids, fns["embedding_bag"])
                continue
            ok &= compare(f"embedding_bag {name} ({ids.shape[0]} × {ids.shape[1]}, D=128 bf16)",
                          fns["embedding_bag"], lambda f: f(table, ids, w), nbytes)
        del table
        torch.cuda.empty_cache()
    if wanted & set(MH_CASES):
        for name, a, seed2, beta, asum, V, n_mh, nbytes in mh_cases(wanted):
            ok &= compare(f"mh_resample {name}", fns["mh_resample"],
                          lambda f: f(a, seed2, beta, asum, V, n_mh), nbytes)
        random_sectors(a[0], nbytes // 32)
    print("all builds equal bit for bit" if ok else "a build DIFFERS", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
