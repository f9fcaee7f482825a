"""Time the CUDA alias-table build on several row kinds, beside other builds.

Needs a CUDA card and nvcc. Run from the root of the checkout:

    python3 scripts/alias_build_bench.py [--variant NAME=PATH.cu ...]

The committed kernel (``src/repro_torch/csrc/alias_build.cu``) always runs;
each ``--variant`` is another source with the same C entry point
(``alias_build_launch``), for instance an edited copy, built with the same
flags. Every build must give the committed kernel's tables bit for bit, and
the committed kernel the plain sweep's (``build_alias_ref`` on
``ops._prepare``) on the first rows of each small case; the script exits
nonzero otherwise.

Cases, at K = 100,000:
- ``chunk``: 2,048 synthetic word rows (``chip_smoke.word_weights``, seed 5);
- ``alpha``: the α row, 50/K in every slot;
- ``cell2048``: rows shaped like the alias cell's wq = (φ+β)/(ψ+Vβ), with
  ψ ~ Poisson(747,200 / K) and φ from a Zipf vocabulary of 32,768 words over
  747,200 tokens, every 16th word;
- ``empty2048``: 2,048 rows of words with no token, β/(ψ+Vβ) (three
  quarters of the alias cell's rows are such words: wn is near 1 in every
  slot, and about half the slots are large);
- ``table``: the synthetic 32,768-row word table of ``chip_smoke.py``;
- ``cell_table``: every word of the Zipf vocabulary, 32,768 rows;
- ``empty_table``: 32,768 rows of words with no token;
- ``cell_init_table``: the alias cell's first table: the words of
  ``chip_smoke.py``'s corpus tiled 40 times (three quarters of the 32,768
  words have no token), each token on a uniform topic, as the cell starts.

Each case is timed with CUDA events in the order a, b, …, b, a; the line
gives the fastest of 3 runs for each pass.
"""
from __future__ import annotations

import argparse
import ctypes
import sys

import torch

import kernel_bench as kb

K, V, TOKENS = 100_000, 32_768, 747_200


def launcher(so):
    fn = ctypes.CDLL(so).alias_build_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def run(fn, w, scale, out):
    R, k = w.shape
    nw = -(-k // 1024)
    bitmaps = torch.empty((R, 2, nw), dtype=torch.int32, device=w.device)
    err = fn(w.data_ptr(), scale.data_ptr(), R, k, nw, out[0].data_ptr(), out[1].data_ptr(),
             bitmaps.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"alias_build launch failed: CUDA error {err}")
    return out


def cell_rows(words, seed):
    """(φ+β)/(ψ+Vβ), β = 0.01, for the given Zipf ranks (1-based; a rank of
    0 gives a word with no token)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    psi = torch.poisson(torch.full((K,), TOKENS / K, device="cuda"), generator=g)
    n = torch.where(words > 0, (TOKENS / (10.97 * words.double())).round().clamp(min=1), 0)
    row = torch.repeat_interleave(torch.arange(len(words), device="cuda"), n.long())
    topic = torch.randint(0, K, (len(row),), generator=g, device="cuda")
    phi = torch.zeros((len(words), K), device="cuda")
    phi.index_put_((row, topic), torch.ones(len(row), device="cuda"), accumulate=True)
    return (phi + 0.01) / (psi + V * 0.01)


def cases():
    from chip_smoke import word_weights
    yield "chunk", lambda: word_weights(2048, K, seed=5)
    yield "alpha", lambda: torch.full((1, K), 50.0 / K, device="cuda")
    yield "cell2048", lambda: cell_rows(torch.arange(1, V + 1, 16, device="cuda"), 3)
    yield "empty2048", lambda: cell_rows(torch.zeros(2048, device="cuda", dtype=torch.long), 4)

    def table():
        t = torch.empty((V, K), device="cuda")
        for lo in range(0, V, 2048):
            t[lo:lo + 2048] = word_weights(2048, K, seed=5 + lo)
        return t
    yield "table", table
    yield "cell_table", lambda: cell_rows(torch.arange(1, V + 1, device="cuda"), 6)
    yield "empty_table", lambda: cell_rows(torch.zeros(V, device="cuda", dtype=torch.long), 4)

    def cell_init_table():
        from chip_smoke import ALIAS, FULL
        from repro_torch.data import synthetic
        corpus, _ = synthetic.lda_corpus(seed=0, n_docs=FULL["n_docs"],
                                         n_topics=FULL["gen_topics"], vocab_size=V,
                                         query_like=True)
        w = torch.from_numpy(corpus.word_ids).long().cuda().repeat(ALIAS["tiles"])
        g = torch.Generator(device="cuda").manual_seed(7)
        z = torch.randint(0, K, (len(w),), generator=g, device="cuda")
        phi = torch.zeros((V, K), device="cuda")
        phi.index_put_((w, z), torch.ones(len(w), device="cuda"), accumulate=True)
        psi = torch.bincount(z, minlength=K).float()
        return phi.add_(0.01).div_(psi + V * 0.01)
    yield "cell_init_table", cell_init_table


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=PATH of another alias_build source")
    parser.add_argument("--cases", default="chunk,alpha,cell2048,empty2048,table,cell_table,"
                        "empty_table,cell_init_table",
                        help="comma-separated cases to run")
    args = parser.parse_args()
    if not kb.need_card("alias_build_bench"):
        return 1
    from repro_torch import kernels
    from repro_torch.kernels.alias import ops
    from repro_torch.kernels.alias.ref import build_alias_ref

    jobs = kb.start_builds(args.variant, "alias_build_bench")
    kernels.build(["alias_build"])
    fns = {"committed": launcher(str(kernels.library_path("alias_build")))}
    for name, _, so, proc in jobs:
        kb.finish_build(name, proc)
        fns[name] = launcher(so)
    names = list(fns)

    ok = True
    for case, make in cases():
        if case not in args.cases.split(","):
            continue
        w = make()
        scale = ops._scale(w)
        out = (torch.empty_like(w), torch.empty(w.shape, dtype=torch.int32, device="cuda"))
        run(fns["committed"], w, scale, out)
        rows = torch.linspace(0, w.shape[0] - 1, min(w.shape[0], 257),
                              device="cuda").round().long()
        ref = (out[0][rows].view(torch.int32).clone(), out[1][rows].clone())
        same = {}
        for name in names[1:]:
            run(fns[name], w, scale, out)
            same[name] = (torch.equal(out[0][rows].view(torch.int32), ref[0])
                          and torch.equal(out[1][rows], ref[1]))
        ok &= all(same.values())
        if w.shape[0] <= 2048:
            head = slice(0, min(w.shape[0], 64))
            run(fns["committed"], w, scale, out)
            pp, ap = build_alias_ref(*ops._prepare(w[head], scale[head]))
            plain = (torch.equal(out[0][head].view(torch.int32), pp.view(torch.int32))
                     and torch.equal(out[1][head], ap))
            ok &= plain
            same["plain sweep, first rows"] = plain
        ms = kb.in_turns(fns, lambda fn: kb.event_ms(lambda: run(fn, w, scale, out), 3, min))
        print(f"{case} R={w.shape[0]} K={K}: {kb.fmt_turns(ms)}; equal to the committed "
              f"kernel: {same}", flush=True)
        del w, scale, out
        torch.cuda.empty_cache()
    print("all builds equal bit for bit" if ok else "a build DIFFERS", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
