"""Time the CUDA embedding_bag_bwd kernel at each recsys train path's gather.

Needs a CUDA card and nvcc. Run from the root of the checkout:

    python3 scripts/bag_bwd_bench.py [--variant NAME=PATH.cu ...]
        [--old NAME=PATH.cu ...] [--long-run 128,512,...] [--tile-items 32,...]
        [--one-stream] [--profile]
        [--cases dlrm,xdeepfm,xdeepfm_linear,din_item,din_ctx,autoint,one_run]

Each case is the flat ids one train step of an arch hands to the row
gradient (bags of one, −1 padding kept), drawn on the card by the arch's own
input maker from a fixed seed, with a random gradient row of the table's
dtype and width for each id; no table is made:
- ``dlrm``: dlrm-mlperf, B = 65,536 × 26 fields, D = 128 bf16;
- ``xdeepfm`` / ``xdeepfm_linear``: xdeepfm at B = 32,768 (the batch the
  card fits) × 39 fields, its table (D = 10 bf16) and ``linear_w`` (D = 1 f32);
- ``din_item`` / ``din_ctx``: din at B = 65,536, target and history (101
  ids a sample, ~half of them −1) into ``item_table``, and ``ctx_table``,
  D = 18 bf16;
- ``autoint``: autoint at B = 65,536 × 39, D = 16 bf16;
- ``one_run``: 22,024 ids all equal, D = 128 bf16: the longest run of
  ``dlrm`` alone, the floor of the long-run kernel.

The committed kernel always runs through the committed wrapper
(``embedding_bag_bwd_runs_cuda``: the plan and both kernels, the runs grouped
beforehand). Each ``--variant`` is another source with the committed C entry
points, built with the committed flags and run through the same wrapper
(``kernel_bench.py`` says how to wrap an earlier kernel whose entry point
differs); each ``--old`` is a source with the one-warp-a-run design's entry
point (``embedding_bag_bwd_launch`` of ``git show
1a531b8:src/repro_torch/csrc/embedding_bag_bwd.cu``), called as that design's
wrapper called it. ``--long-run`` and ``--tile-items`` also time the committed
build at other thresholds of a long run and sizes of a short-run tile;
``--one-stream`` also times it with the long-run kernel on the current
stream, after the short-run kernel; ``--profile`` breaks a call of each down
by kernel. The committed wrapper must make no host sync (checked under
``torch.cuda.set_sync_debug_mode("error")``), its plan's kernels must equal
their plain versions, and every build must give the plain version's bits
(``embedding_bag_bwd_runs_ref``); the script exits nonzero otherwise. Timed
in turns (a, b, …, b, a), each pass the median of 20 calls by CUDA events
after one warm-up, beside the plan's kernels alone, ``index_add_`` into a
zeroed [U, D] f32 (atomics; a yardstick) and the bytes bound: each item's
gradient row and position read once, the run offsets once, each distinct
row's f32 sum written once, over 3.35 TB/s.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
import time

import torch

import kernel_bench as kb

CASES = ("dlrm", "xdeepfm", "xdeepfm_linear", "din_item", "din_ctx", "autoint", "one_run")
HBM_BYTES_PER_S = 3.35e12


def case_ids(name):
    """(flat ids [N, 1] int32, D, grad dtype) of one train path's gather."""
    from repro_torch.configs import recsys_archs as ra
    from repro_torch.models.recsys import _flat_ids
    g = torch.Generator(device="cuda").manual_seed(23)
    if name == "one_run":                       # dlrm's longest run alone
        return torch.zeros((22_024, 1), dtype=torch.int32, device="cuda"), 128, torch.bfloat16
    if name == "dlrm":
        ids = _flat_ids(ra.DLRM.embedding, ra._dlrm_inputs(65_536, g, "cuda")[1])
        return ids.reshape(-1, 1), ra.DLRM.embedding.dim, torch.bfloat16
    if name in ("xdeepfm", "xdeepfm_linear", "autoint"):
        cfg = ra.AUTOINT if name == "autoint" else ra.XDEEPFM
        B = 65_536 if name == "autoint" else 32_768
        ids = _flat_ids(cfg.embedding, ra._field_ids(ra.CRITEO39_SIZES, B, g, "cuda"))
        if name == "xdeepfm_linear":
            return ids.reshape(-1, 1), 1, torch.float32
        return ids.reshape(-1, 1), cfg.embedding.dim, torch.bfloat16
    target, hist, ctx = ra._din_inputs(65_536, g, "cuda")
    if name == "din_item":
        ids = torch.cat([target[:, None], hist], dim=1)
    else:
        off = torch.arange(ra.DIN.n_context, device="cuda", dtype=torch.int32)
        ids = ctx + off[None, :] * ra.DIN.context_vocab
    return ids.reshape(-1, 1).contiguous(), ra.DIN.embed_dim, torch.bfloat16


def load(so):
    """The entry points of library ``so``, typed as the committed wrapper
    types them."""
    from repro_torch.kernels.embedding_bag import kernel
    return kernel.typed_entry_points(ctypes.CDLL(so))


def runner(fns, long_run=None, tile_items=None, one_stream=False):
    """A call of the committed wrapper through the entry points ``fns``, at
    the thresholds ``long_run`` and ``tile_items`` (the committed ones if
    None), the long-run kernel on a stream of its own unless ``one_stream``
    (then on the current stream, after the short-run kernel)."""
    from repro_torch.kernels.embedding_bag import kernel
    knobs = dict(LONG_RUN=long_run, TILE_ITEMS=tile_items)
    side = kernel._long_stream

    def run(grad, order, starts):
        saved = {k: getattr(kernel, k) for k in knobs}
        kernel._bwd_fn = fns
        for k, v in knobs.items():
            if v is not None:
                setattr(kernel, k, v)
        if one_stream:
            kernel._long_stream = lambda dev: torch.cuda.current_stream(dev)
        try:
            return kernel.embedding_bag_bwd_runs_cuda(grad, order, starts, 1)
        finally:
            for k, v in saved.items():
                setattr(kernel, k, v)
            kernel._long_stream = side
    return run


def old_runner(so):
    """A call of an earlier kernel with the one-warp-a-run design's entry
    point (``embedding_bag_bwd_launch``: one warp a run, the widest loads up
    to 16 bytes), as that design's wrapper made it."""
    from repro_torch.kernels.embedding_bag import kernel
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = ctypes.CDLL(so).embedding_bag_bwd_launch
    fn.argtypes = [p] * 4 + [ctypes.c_longlong] + [i] * 6 + [p, p]
    fn.restype = i

    def run(grad, order, starts):
        (B, D), U = grad.shape, starts.numel() - 1
        out = torch.empty((U, D), dtype=torch.float32, device=grad.device)
        vec = kernel.bwd_copy(D, grad.element_size(), grad.data_ptr()) // grad.element_size()
        err = fn(grad.data_ptr(), order.data_ptr(), starts.data_ptr(), None, U, 1, D, 0,
                 kernel._DTYPES[grad.dtype], vec, max(1, -(-U // 8)), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier embedding_bag_bwd launch failed: CUDA error {err}")
        return out
    return run


def no_sync(run):
    """Raise if the committed wrapper makes the host wait for the card (a
    sync in its plan or launches), on a small case."""
    from repro_torch.kernels.embedding_bag.ref import row_runs
    g = torch.Generator(device="cuda").manual_seed(25)
    ids = torch.randint(0, 50, (20_000, 1), generator=g, device="cuda", dtype=torch.int32)
    grad = torch.randn((20_000, 128), generator=g, device="cuda").to(torch.bfloat16)
    order, _, starts = row_runs(ids)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(grad, order, starts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("the wrapper's plan and launches made no host sync (sync debug mode 'error')",
          flush=True)


def profile(label, fn, calls=5):
    """Device time by kernel of ``calls`` calls of ``fn`` (torch.profiler),
    a call's share, and the host's µs a call (its loop, before the
    synchronize)."""
    from torch.profiler import ProfilerActivity, profile as prof
    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    rows = sorted((e for e in p.key_averages() if e.device_time_total > 0),
                  key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in rows) / calls / 1e3
    print(f"[profile] {label}: host {host_us:.1f} us a call; device {busy:.4f} ms a call: "
          + "; ".join(f"{e.key[:60]} {e.device_time_total / calls / 1e3:.4f} ms x"
                      f"{e.count // calls}" for e in rows[:8]), flush=True)


def bench(name, fns, with_profile=False):
    """Check and time every build on case ``name``; True if all give the
    plain version's bits."""
    from repro_torch.kernels.embedding_bag import kernel
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_bwd_runs_ref, row_runs
    one, D, dtype = case_ids(name)
    g = torch.Generator(device="cuda").manual_seed(24)
    grad = torch.randn((one.shape[0], D), generator=g, device="cuda").to(dtype)
    order, rows, starts = row_runs(one)
    U = rows.numel()
    counts = starts[1:] - starts[:-1]
    items = int(starts[-1] - starts[0])
    plain = embedding_bag_bwd_runs_ref(grad, order, starts, 1)
    ok, bits = True, []
    for label, fn in fns.items():
        same = torch.equal(fn(grad, order, starts).view(torch.int32), plain.view(torch.int32))
        again = torch.equal(fn(grad, order, starts).view(torch.int32), plain.view(torch.int32))
        ok &= same and again
        bits.append(f"{label} {'equal' if same and again else 'DIFFERS'}")
    del plain
    ms = kb.in_turns({k: (lambda f=f: f(grad, order, starts)) for k, f in fns.items()},
                     lambda f: kb.event_ms(f, 20))
    N = one.shape[0]
    kernel._bwd_fn = None                      # the committed library again
    tiles, by_len = kernel.bwd_plan_cuda(starts, N)
    plan_same = (torch.equal(tiles, kernel.bwd_tiles(starts, N, kernel.TILE_ITEMS))
                 and torch.equal(by_len, kernel.long_runs(starts, N, kernel.LONG_RUN)))
    ok &= plan_same
    bits.append(f"plan {'equal' if plan_same else 'DIFFERS'} (tiles, long runs)")
    plan_ms = kb.event_ms(lambda: kernel.bwd_plan_cuda(starts, N), 20)
    inverse = torch.empty(one.shape[0], dtype=torch.int64, device="cuda")
    inverse[order[:starts[0]]] = U                      # padding: a row of its own
    inverse[order[starts[0]:]] = torch.repeat_interleave(torch.arange(U, device="cuda"), counts)
    acc = torch.zeros((U + 1, D), dtype=torch.float32, device="cuda")
    gradf = grad.float()
    library_ms = kb.event_ms(lambda: acc.index_add_(0, inverse, gradf), 20)
    moved = items * (D * grad.element_size() + 8) + (U + 1) * 8 + U * D * 4
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    with_sort = kb.event_ms(lambda: fns["committed"](grad, *row_runs(one)[::2]), 20)
    print(f"embedding_bag_bwd {name} ({one.shape[0]} ids, {items} in runs, {U} distinct rows, "
          f"D={D} {dtype}, the longest run {int(counts.max())}, "
          f"{int((counts > kernel.LONG_RUN).sum())} runs longer than {kernel.LONG_RUN}): "
          + kb.fmt_turns(ms, lambda n, ts: f" (share {bound_ms / min(ts):.3f})")
          + f"; the plan's kernels alone {plan_ms:.4f} ms; with its stable sort {with_sort:.4f} ms; "
          f"index_add_ {library_ms:.4f} ms; bound {bound_ms:.4f} ms (bytes, "
          f"{moved / 1e9:.4f} GB); bits: {', '.join(bits)}", flush=True)
    if with_profile:
        for label in fns:
            profile(f"{name} {label}", lambda f=fns[label]: f(grad, order, starts))
    return ok


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=PATH of another source with the committed entry point")
    parser.add_argument("--old", action="append", default=[],
                        help="NAME=PATH of an earlier source with the one-warp-a-run "
                             "design's entry point")
    parser.add_argument("--long-run", default="",
                        help="other thresholds of a long run to time the committed build at")
    parser.add_argument("--tile-items", default="",
                        help="other tile sizes of the short-run kernel to time it at")
    parser.add_argument("--one-stream", action="store_true")
    parser.add_argument("--profile", action="store_true",
                        help="also break a committed call down by kernel (torch.profiler)")
    parser.add_argument("--cases", default=",".join(CASES))
    args = parser.parse_args()
    if not kb.need_card("bag_bwd_bench"):
        return 1
    from repro_torch import kernels
    jobs = kb.start_builds(args.variant + args.old, "bag_bwd_bench")
    for line in kernels.build(["embedding_bag_bwd"]).get("embedding_bag_bwd", "").splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    committed = load(str(kernels.library_path("embedding_bag_bwd")))
    fns = {"committed": runner(committed)}
    for n in filter(None, args.long_run.split(",")):
        fns[f"long_run={n}"] = runner(committed, long_run=int(n))
    for n in filter(None, args.tile_items.split(",")):
        fns[f"tile_items={n}"] = runner(committed, tile_items=int(n))
    if args.one_stream:
        fns["one stream"] = runner(committed, one_stream=True)
    olds = {spec.split("=", 1)[0] for spec in args.old}
    for name, src, so, proc in jobs:
        kb.finish_build(name, proc)
        fns[name] = old_runner(so) if name in olds else runner(load(so))
    no_sync(fns["committed"])
    ok = True
    for name in args.cases.split(","):
        ok &= bench(name, fns, args.profile)
        torch.cuda.empty_cache()
    print("all builds equal the plain version bit for bit" if ok else "a build DIFFERS",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
