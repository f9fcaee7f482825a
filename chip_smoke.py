#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a) and ``nvcc``. It builds every kernel of
the port from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all started
together), holds each against its plain PyTorch version on the card, then
drives the port's three LDA paths at the full width of peacock-lda —
K = 100,000 topics, V = 32,768 words (cut from 210,000 so that Φ and P̂ fit
one 80 GB card whole):

Right after the kernel phases, the launch gate ([preflight],
``repro_torch.analysis``): every kernel instantiation as built for this card
(registers, static and dynamic shared bytes, spills, blocks an SM,
binaryVersion) held to sm_90's limits with the launch plans of this run's
largest shapes; then, in a process of the smoke's own beside the dry run at
the lowest CPU priority (the gates run on the host), ``launch.train
--preflight``, ``launch.serve --preflight`` and ``launch.dryrun --verify``
(exit 0) and the train gate on a session of 430 GB a rank (exit 1), each
launcher's ``main`` called there.

The K = 100,000 ``alias_build`` check's plain sweep (its tables and inputs
kept on the host after the kernel phases) runs on a thread beside the two
``launch.train`` phases of SMALL's geometry, which leave the card nearly
idle (each starts its independent worlds together).

- the dense path: a 4,096-query segment shard through train (3 Gibbs
  epochs) → α re-estimation → RT-LDA export → 4 served batches of 1,024;
- the alias-MH path: that shard tiled 40× (163,840 docs, ~747,000 tokens)
  laid out as a ring of one device, 6 epochs with the stale alias tables
  rebuilt at epochs 0 and 3, α re-estimation from the sparse pairs, the α
  table refreshed, RT-LDA export and 2 served batches of 1,024;
- the training loop: the dense path's shard through the port's ``Trainer``
  (the dense ring of one device in 2 packages, 3 epochs, α re-estimated,
  the word LL logged), both forms of the dense ring timed and profiled, an
  RT-LDA model from ``gather_phi`` serving a batch, and the dense and alias
  samplers' LL curves from one z0; ``gibbs_argmax`` (each ring form) and
  ``mh_resample`` are held against their plain versions on a package of
  this path at its own shape;
- the streamed path (Fig. 3/4's LoadShard/SaveShard): the alias path's
  163,840 docs written by ``save_segments`` as 10 segments on disk and
  trained from the memory-mapped directory by the ``Trainer`` (dense: 3
  epochs in packages of 9,379 with α re-estimated, then one epoch each with
  prefetch on and off, which must agree bit for bit; alias: 6 epochs), each
  epoch's tokens/s, segment seconds, LoadShard/SaveShard host times and peak
  memory, a profiled epoch of each sampler, ``gibbs_argmax`` and
  ``mh_resample`` held against their plain versions on a segment's first
  package, and both samplers' LL curves from one z0.

Then the paper's application layer on the same corpus
(``repro_torch.benchmarks.bench_quality`` and ``bench_pipeline``; [quality]
and [table1] lines): one dense model a K at K = 1,024, 10,000 and 100,000
(``gibbs_epoch`` in blocks of 8,192, 25 epochs, z0 from a seeded CPU
generator), fold-in P(k|d) of all 4,096 docs (15 sweeps; every θ row must sum
to its doc's length), Fig. 7's retrieval MAP against ``relevance_judgments``
and Fig. 8's pCTR AUC from the L1 log-linear model (8,000 impressions of
``click_log``, 400 steps; the baseline and the true-topic oracle beside each
K), Fig. 1's topic PMI at K = 1,024; the K = 100,000 fit run twice (bit for
bit) and its first 3 steps on the CPU port and in float64 (the card's
weights no further from float64 than twice the CPU port's: both sum 6,400
rows of features up to ~3,800 in f32, in other orders);
``gibbs_argmax`` held on the first training and fold-in launches at K =
100,000. The sampler guardrail at full width: the first 3,276 docs tiled 10×
(~149,000 tokens), dense and alias 25 sweeps from one z0 at K = 10,000 and
100,000, held-out LL on the last 820 docs (recorded, not gated;
``mh_resample`` held on the alias chain's first block), and
``sampler_guardrail``'s own gate at K = 24 (it must pass). Table 1: the
analytic model against the paper, and epochs of the dense ring of one device
on FULL's shard at K = 100,000 in four package lengths. Last, ``run()``'s
clean corpus at K = 8: Fig. 7 and 8 on the card equal the CPU port's within
1e-4.

Small phases at quickstart scale run the O(K²V) de-duplication, hold the
card's whole dense loop and alias loop against the same loops on the CPU,
and drive ``repro_torch.launch.train`` in both samplers: a run that
publishes, a run killed after epoch 4 and resumed (bit for bit), and the same
run on the CPU (the dense run's every package held against the plain
version on the CPU: a differing draw must be a near-tie); then the same in 3
streamed segments, killed at a segment boundary and resumed, from a
``--corpus-dir``, and with the first segment read failing under a
``FaultPlane`` (retried), all bit for bit with the uninterrupted run.

Then Peacock's hierarchical architecture, one process per rank of a (pods,
data, model) mesh over torch.distributed (gloo; the ranks share the card
through ``ranks_per_device``, so their times are the process model's
overhead, not scaling), in one world of 4 ranks: FULL's shard on a 4×1 ring
at K = 100,000, V = 32,768 ([ring]: 3 dense epochs in each ring form and 3
alias epochs after one table build, the invariants and a rising word LL,
``gibbs_argmax`` and ``mh_resample`` held on rank 0, the rotation and the Ψ
all_reduce timed with their bytes); the shard word-sharded 2×2 against the
2×1 ring, bit for bit in both samplers ([word-sharded]); SMALL's corpus on a
2×2 ring, card against CPU ([ring card vs cpu]); 2 pods × a 2×1 ring at V =
4,096 for 6 epochs ([pods]: the exact and the compressed merge at the
first boundary, within the quantization bound; at the second pod 1 is dead,
``restart_pod`` brings it back from its own checkpoint and the elastic merge
drops its delta). Then ``launch.train`` starting its own ranks
([launch.train multi-rank]): ``--pods 2 --data-shards 2`` killed between
boundaries and resumed, equal and publishing the same model, and a
``--sharded-model`` checkpoint resumed at P = 1.

Then the streamed ring of several ranks, in a second world of 4 ranks on the
card ([stream-ranks]): the streamed cell's 163,840 docs saved as 10 segments
for a 4×1 ring and trained from the mmap'd directory by each rank's
``Trainer`` (each rank streams only its block of every segment): dense 3
epochs in packages of 2,412 with α re-estimated, a profiled epoch on rank 0,
one epoch each with prefetch on and off (bit for bit), the alias sampler 3
epochs after one table build a rank, count invariants over the global z
store, ``gibbs_argmax`` and ``mh_resample`` held on rank 0, the rotation and
Ψ all_reduce of a segment timed; the corpus as 20 segments word-sharded 2×2
(P = 2) against 2×1, bit for bit; SMALL's corpus in 3 segments on a 2×2 ring,
card against CPU; and ``lookup_sharded`` over dlrm-mlperf's 187,767,552 ×
128 bf16 table row-sharded 4 ways (11.2 GiB a rank), the serve_p99 batch and
one of 16,384, each rank's rows equal to its local gather, every id hit
once; the recsys and GNN steps across ranks ([recsys-ranks], [gnn-ranks]);
and the LM steps across ranks ([lm-ranks]): qwen3-0.6b at full width at
(1, 2, 2), 2 train_4k steps in bf16 (FSDP over "data", tensor parallelism
over "model") and one in f32, prefill_32k's last chunk and 4 decode_32k
steps in bf16 on the sequence-sharded cache and a prefill and 2 decodes in
f32, qwen2-moe and phi3.5-moe decode at (1, 1, 4), the f32 steps against
rank 0's one-rank steps; and peacock-lda's serve_rt ([lda-serve-ranks]) at
(1, 1, 4) and (1, 2, 2), K = 100,000, B = 1,024 queries: P̂ and the R cache
row-sharded over the ring, each rank's pkd columns bit for bit against rank
0's one-rank step. The 4 ranks share the card: their collectives go
through workspaces on the card (``dist.collectives``), held against the
host path on the card ([coll-card]). Then ``launch.train`` starts its own 4
ranks streamed in 3 segments ([launch.train streamed ranks]): from a
``--corpus-dir``, killed at a segment boundary and resumed with rank 1's
first segment read failing, equal to the uninterrupted run from memory.

Then the recsys serving path at full width: dlrm-mlperf (the 187,767,552 ×
128 bf16 embedding table of the MLPerf Criteo-1TB config, nothing cut) with
the ``embedding_bag`` kernel checked at the bulk batch's gather, 200 timed
serve_p99 batches of 512 (p50/p99), 3 serve_bulk batches of 262,144
(samples/s), xdeepfm, din and autoint one serve_p99 batch each, and
retrieval_scores over 10⁶ candidates. Then recsys training, the
``train_batch`` cell of each arch through ``cell.fn`` at full width: the
row-gradient kernel ``embedding_bag_bwd`` bit for bit against its plain
version at 100 random shapes and at dlrm-mlperf's train gather (65,536 × 26
bags of one into the same 187,767,552 × 128 bf16 table, not drawn again),
timed beside its bound and ``index_add_``; dlrm-mlperf 10 steps and xdeepfm,
din, autoint 5 steps each on one fixed batch (a batch that does not fit the
card is halved, and the cut printed): step ms, samples/s, peak GiB, a
falling loss, two steps from one state bit for bit, untouched rows
unchanged, a profiled step. Then the GNN workload ([gnn], graphsage-reddit):
``gather_segment_sum`` (message passing on the row-gradient kernel, forward
and gradient) bit for bit against its plain version at one ogb_products edge
chunk (1,048,576 edges, d = 100), at cora's width (d = 1,433) and at
minibatch_lg's level-2 block (d = 602), the bag's dense gradient at its
level-1 block; then the four train cells through ``cell.fn`` at full size:
full_graph_sm on a ``random_graph`` of cora's size (20 AdamW steps, the
loss must fall), minibatch_lg fed by the ``NeighborSampler`` on a
``random_graph`` of reddit's 232,965 nodes (average degree cut to 20, 1,024
seeds, fanouts 15/10), ogb_products (59 edge chunks a layer) and molecule on
drawn inputs, 3 steps each, step 1 twice from one state bit for bit, then
one more step with every launch of the row-gradient kernel held against its
plain version bit for bit; step ms, peak GiB, launches. Then the LM/MoE
workload ([lm]): qwen3-0.6b's train_4k at full width on one microbatch of
2 × 4,096 (remat on) and qwen2-moe-a2.7b's at 2 of its 24 layers, 3 AdamW
steps each, step 1 twice bit for bit, one more step held as the GNN's (the
embedding gradient, the MoE dispatch with its overflow run, the combine and
their transposes), the launches with the most rows and the longest run
timed at their own inputs; serving at full depth in bf16, qwen3-0.6b and
qwen2-moe-a2.7b (28.6 GB): a 4,096-token chunked-prefill step at B = 4
into a 32,768-position cache and 16 decode steps (tokens/s, peak GiB),
``prefill`` and one more decode step held; the chunk's logits against
``prefill``'s and the decode logits against ``forward``'s (qwen3 in bf16;
the MoE, whose bf16 routers flip near-ties, in f32 at capacity factor E/k,
where nothing drops, and a decode routing that differs from ``forward``'s
must be a near-tie). Then the dry run ([dryrun]): ``python -m
repro_torch.launch.dryrun --all --both-meshes --json`` in a subprocess (the
parent has freed its table by then): every cell of every arch at the 16×16
and 2×16×16 meshes, each cell's one-rank step on this card (ms, live bytes,
counted flops and bytes, roofline share; an LM train step on one
microbatch); dlrm-mlperf's four cells, every serve_p99, din's and
autoint's train_batch, graphsage-reddit's four cells and smollm-135m's and
qwen3-0.6b's train_4k must be ok, any other cell ok or out of memory;
the cells whose one-rank arguments pass 80 GB (peacock-lda's three, the
MoE archs' train_4k, every decode_32k, all prefill_32k but smollm-135m's)
recorded, not run; long_500k skipped with JAX's reason; dlrm's step within
0.5–2× of the train phase's; the shard table's P = 1 row not fitting 80 GB
and its P = 2 row fitting. Then the six example twins ([examples],
``examples/*_torch.py``, in parallel on the card): each must exit 0 after
its own assertions and launch its path's kernels. A small loop holds the
four small recsys configs on the card against the CPU.

Then RT-LDA serving at K = 100,000, V = 32,768: ``launch.serve``'s own model
(quick_train's first ``gibbs_argmax`` launch held against the plain
version) served by a ``TopicEngine`` on a fake clock, every response equal to
``make_serving_fn`` on the same batch and seed, before and after a swap; the
capacity of an engine and of a fleet of 2 (4,096 queries at once); a served
batch's time at rows 1 and 256; ``launch.serve.main`` in open loop with a
mid-run swap, below and above that capacity; publish → watch → swap against
a CPU fleet; and one chaos scenario.

Prints a ``kernels`` JSON line, the card's name and power limit, and as its
last line ``{"ok": true, "device": {...}}``. Exits nonzero on any failure,
and when there is no CUDA card.
"""
import contextlib
import gc
import json
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and f32 outside
# the tensor cores. A card below its 700 W limit runs slower than these.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations of gibbs_argmax per (token, topic) element, each logf counted as
# one: 3 adds for the log arguments, 5 logf, 2 to combine the three terms,
# 6 for the uniform and Gumbel transform, τ·g and its add, 1 compare (18
# float), and 12 integer ops of the murmur3 hash.
GIBBS_OPS_PER_ELEMENT = 30

# Operations of one Walker-sweep step (compares, selects, the two float
# subtractions, cursor increments), per (row, slot).
SWEEP_OPS_PER_SLOT = 20

FULL = dict(n_topics=100_000, vocab=32_768, n_docs=4096, gen_topics=1024,
            block=8192, epochs=3, batches=4, batch=1024, bucket=8)
SMALL = dict(n_topics=16, vocab=400, n_docs=1500, gen_topics=12, epochs=25)
# the alias-MH cell: FULL's shard tiled into fresh docs, one package per epoch
ALIAS = dict(tiles=40, epochs=6, agg_every=3, n_mh=4, batches=2, batch=1024, bucket=8)
ALIAS_SMALL = dict(epochs=6, agg_every=3, n_mh=4)
# the recsys serving cells: batch shapes of repro/configs/base.py RECSYS_SHAPES
RECSYS = dict(seed=0, p99_batch=512, p99_warmup=20, p99_batches=200, bulk_batch=262_144,
              bulk_batches=3, n_candidates=1_000_000)


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def timed_ms(fn, reps, warmup=2):
    """Median device time of ``fn()`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------- kernel phase
def gibbs_inputs(T, K, psi_row, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=g, device="cuda",
                                              dtype=torch.float32)
    phi, theta = rnd(0, 50, (T, K)), rnd(0, 10, (T, K))
    psi = rnd(1, 500, (K,) if psi_row else (T, K))
    alpha = torch.rand(K, generator=g, device="cuda") * 0.99 + 0.01
    uid = torch.arange(T, dtype=torch.int64, device="cuda") + 31
    return phi, psi, theta, alpha, torch.tensor(0.01, device="cuda"), uid


def near_ties(zk, args, seed, V, tau, rows=2048):
    """Hold the kernel's draws ``zk`` against the plain version on ``args``
    (phi, psi, theta, alpha, beta, uid; on the card, or on the CPU for a
    card-vs-CPU check), a block of rows at a time. The plain draw is the row
    argmax of ``gibbs_scores``, which is ``gibbs_argmax_ref``. Returns (draws
    that differ, of them not a near-tie (score gap above 4 ulp), largest gap);
    raises on a draw out of [0, K)."""
    from repro_torch.kernels.gibbs.ref import gibbs_scores
    phi, psi, theta, alpha, beta, uid = args
    T, K = phi.shape
    zk = zk.to(phi.device).long()
    if not bool(((zk >= 0) & (zk < K)).all()):
        raise AssertionError(f"gibbs_argmax drew a topic out of [0, {K}) at T={T}")
    inf = torch.tensor(float("inf"), device=phi.device)
    mism = bad = 0
    max_gap = 0.0
    for lo in range(0, T, rows):
        r = slice(lo, lo + rows)
        scores = gibbs_scores(phi[r], psi if psi.dim() == 1 else psi[r], theta[r], alpha,
                              beta, uid[r], seed, V, tau)
        zp = torch.argmax(scores, dim=1)
        sk = scores.gather(1, zk[r, None])[:, 0]
        sp = scores.gather(1, zp[:, None])[:, 0]
        del scores
        gap = (sp - sk).abs()
        top = torch.maximum(sp.abs(), sk.abs())
        differ = zk[r] != zp
        mism += int(differ.sum())
        bad += int((differ & ~(gap <= 4 * (torch.nextafter(top, inf) - top))).sum())
        max_gap = max(max_gap, float(gap.max()))
    return mism, bad, max_gap


def kernel_phase():
    from repro_torch.kernels.gibbs import ops
    from repro_torch.kernels.gibbs.kernel import gibbs_argmax_cuda
    from repro_torch.kernels.gibbs.ref import gibbs_argmax_ref

    seed, V = 42, FULL["vocab"]
    max_err, total_bad = 0.0, 0
    for (T, K) in [(8192, FULL["n_topics"]), (257, 513), (31, 1000)]:
        for psi_row in (False, True):
            args = gibbs_inputs(T, K, psi_row, seed=T + K)
            for tau in (1.0, 0.0):
                zk = ops.gibbs_argmax(*args, seed, V, tau)
                mism, bad, gap = near_ties(zk, args, seed, V, tau)
                max_err = max(max_err, gap)
                total_bad += bad
                log(f"[kernel] T={T} K={K} psi={'row' if psi_row else 'plane'} tau={tau}: "
                    f"{mism} mismatches, {bad} not near-ties (>4 ulp)")
            del args
    if total_bad:
        raise AssertionError(f"{total_bad} kernel/plain mismatches beyond a near-tie")

    T, K = 8192, FULL["n_topics"]
    args = gibbs_inputs(T, K, False, seed=1)
    kernel_ms = timed_ms(lambda: gibbs_argmax_cuda(*args, seed, V, 1.0), reps=25)
    plain_ms = timed_ms(lambda: gibbs_argmax_ref(*args, seed, V, 1.0), reps=5, warmup=1)
    bytes_moved = 3 * T * K * 4 + K * 4 + 4 + T * 8 + T * 4
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = GIBBS_OPS_PER_ELEMENT * T * K / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"[kernel] gibbs_argmax T={T} K={K} psi=plane tau=1: kernel_ms={kernel_ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} (bytes {bytes_ms:.4f}, "
        f"ops {ops_ms:.4f}) share_of_bound={bound_ms / kernel_ms:.4f}")
    del args
    torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


# ------------------------------------------------------------ full-width phase
def device_breakdown(label, fn, top=8):
    """Device time by kernel over one run of ``fn`` (torch.profiler), and the
    device's busy share of that window; returns the rows (ms, launches,
    kernel name), all of them. Auxiliary: a profiler that cannot trace the
    card is reported, ``fn`` runs untraced and no rows come back; a failure
    of ``fn`` itself is fatal."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        with profile(activities=activities):     # the tracer's start-up stays out
            torch.ones(1, device="cuda").add_(1)   # of the measured window
            torch.cuda.synchronize()
    except Exception as exc:    # noqa: BLE001 — the breakdown is optional
        log(f"[profile] {label}: not available ({exc!r})")
        fn()
        torch.cuda.synchronize()
        return []
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  reverse=True)
    # gloo's host-side waits come back booked as device time: not kernels
    gloo = [r for r in rows if r[2].startswith("gloo:")]
    rows = [r for r in rows if not r[2].startswith("gloo:")]
    busy = sum(r[0] for r in rows)
    log(f"[profile] {label}: window {wall_ms:.3f} ms (profiled), device busy {busy:.3f} ms "
        f"= {busy / wall_ms:.3f} of it, idle {1 - busy / wall_ms:.3f}"
        + (f"; gloo host-side waits (not device time) {sum(r[0] for r in gloo):.3f} ms in "
           f"{sum(r[1] for r in gloo)} calls" if gloo else ""))
    for ms, n, name in rows[:top]:
        log(f"[profile]   {ms:10.3f} ms {n:5d}x {100 * ms / busy:5.1f}%  {name[:80]}")
    return rows


def query_batch(corpus, lo, n, bucket):
    from repro_torch.core.rtlda import select_bucket
    starts = np.concatenate([[0], np.cumsum(corpus.doc_lengths())])
    q = np.full((n, bucket), -1, np.int32)
    cut = 0
    for i in range(n):
        d = (lo + i) % corpus.n_docs
        toks = corpus.word_ids[starts[d]:starts[d + 1]]
        b, truncated = select_bucket(len(toks), (bucket,))
        cut += truncated
        q[i, :min(len(toks), b)] = toks[:b]
    return q, cut


def full_corpus(with_truth=False):
    """The full-width cell's corpus: one 4,096-query segment shard (and the
    generator's ground truth, with ``with_truth``)."""
    from repro_torch.data import synthetic
    t0 = time.perf_counter()
    corpus, truth = synthetic.lda_corpus(seed=0, n_docs=FULL["n_docs"],
                                         n_topics=FULL["gen_topics"], vocab_size=FULL["vocab"],
                                         query_like=True)
    log(f"[full] corpus: {corpus.n_docs} docs, {corpus.n_tokens} tokens "
        f"({time.perf_counter() - t0:.1f} s on the host)")
    return (corpus, truth) if with_truth else corpus


def full_width_phase(corpus):
    from repro_torch.core import dedup, gibbs, lda, rtlda
    from repro_torch.core.features import make_serving_fn
    from repro_torch.data import corpus as corpus_mod
    from repro_torch.kernels.gibbs import ops

    K, V, D = FULL["n_topics"], FULL["vocab"], FULL["n_docs"]
    wi, di = corpus_mod.pad_corpus(corpus.word_ids, corpus.doc_ids, FULL["block"])
    log(f"[full] padded to {len(wi)} tokens")
    dev = torch.device("cuda")
    wi_t, di_t = torch.from_numpy(wi).to(dev), torch.from_numpy(di).to(dev)
    valid = wi_t >= 0
    torch.cuda.reset_peak_memory_stats()

    state = lda.init_state(wi_t[valid], K, V, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
    z = torch.zeros(len(wi), dtype=torch.int32, device=dev)
    z[valid] = state.z
    state = lda.LDAState(state.phi, state.psi, z, state.alpha, state.beta)
    torch.cuda.synchronize()

    # ---- the main path: counts from 0, train → export → serve ----
    ops.launches = 0
    n_blocks = len(wi) // FULL["block"]
    rates = []
    for e in range(FULL["epochs"]):
        t0 = time.perf_counter()
        state = gibbs.gibbs_epoch(state, wi_t, di_t, D, V, seed=e * 31 + 7,
                                  block_size=FULL["block"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append(corpus.n_tokens / dt)
        log(f"[full] epoch {e}: {dt:.4f} s, {rates[-1]:.1f} tokens/s "
            f"({n_blocks} blocks of {FULL['block']})")
    lda.check_invariants(lda.LDAState(state.phi, state.psi, state.z[valid], state.alpha,
                                      state.beta), wi_t[valid])

    t0 = time.perf_counter()
    omega = dedup.topic_count_histogram(di_t, state.z, valid, D, K)
    lengths = torch.from_numpy(corpus.doc_lengths()).to(dev)
    alpha = dedup.optimize_alpha(state.alpha, omega, dedup.doc_length_histogram(lengths),
                                 n_iters=5)
    if not bool(torch.isfinite(alpha).all() & (alpha > 0).all()):
        raise AssertionError("optimize_alpha gave a non-finite or non-positive α")
    model = rtlda.build_model(state.phi, state.beta, alpha, device=dev)
    del omega
    torch.cuda.synchronize()
    log(f"[full] α + build_model: {time.perf_counter() - t0:.4f} s; "
        f"α sum {float(alpha.sum()):.4f} (was 50.0)")

    serve = make_serving_fn(n_iters=5, n_trials=2, top_n=30, device=dev)
    times, n_cut = [], 0
    for b in range(FULL["batches"]):
        q, cut = query_batch(corpus, b * FULL["batch"], FULL["batch"], FULL["bucket"])
        n_cut += cut
        t0 = time.perf_counter()
        pkd, ids, w = serve(model, q, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if pkd.shape != (FULL["batch"], K) or not bool(torch.isfinite(pkd).all()):
            raise AssertionError("pkd has the wrong shape or non-finite values")
        if float((pkd.sum(dim=1) - 1).abs().max()) > 1e-5:
            raise AssertionError("a pkd row does not sum to 1 within 1e-5")
        if not bool(((ids >= 0) & (ids < V)).all()) or ids.shape != (FULL["batch"], 30):
            raise AssertionError("feature ids out of [0, V)")
    launches = ops.launches
    # ---- end of the main path ----

    expected = FULL["epochs"] * n_blocks
    if launches != expected:
        raise AssertionError(f"gibbs_argmax launched {launches} times, expected {expected}")
    qps = [FULL["batch"] / t for t in times]
    log(f"[full] serve: {FULL['batches']} batches of {FULL['batch']} x bucket "
        f"{FULL['bucket']} ({n_cut} queries cut to the bucket); batch s "
        f"{[round(t, 4) for t in times]}; queries/s per batch {[round(x, 1) for x in qps]}; "
        f"queries/s after the first {sum(FULL['batch'] for _ in times[1:]) / sum(times[1:]):.1f}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[full] launches gibbs_argmax={launches} (expected {expected}); "
        f"max_memory_allocated={peak:.2f} GiB")

    # where the time goes: one more epoch and one more batch, under the profiler
    device_breakdown("epoch", lambda: gibbs.gibbs_epoch(
        state, wi_t, di_t, D, V, seed=99, block_size=FULL["block"]))
    q, _ = query_batch(corpus, 0, FULL["batch"], FULL["bucket"])
    device_breakdown("serve batch", lambda: serve(model, q, 7))
    del model, state
    torch.cuda.empty_cache()
    return launches, dict(tokens_per_s=rates, peak_gib=peak)


# ----------------------------------------------------------------- small phase
def small_phase():
    """Quickstart scale: the O(K²V) de-duplication, and the card's whole loop
    held against the same loop on the CPU (plain version)."""
    from repro_torch.core import dedup, gibbs, lda, rtlda
    from repro_torch.core.features import make_serving_fn
    from repro_torch.data import corpus as corpus_mod, synthetic

    K, V = SMALL["n_topics"], SMALL["vocab"]
    corpus, _ = synthetic.lda_corpus(seed=0, n_docs=SMALL["n_docs"],
                                     n_topics=SMALL["gen_topics"], vocab_size=V,
                                     doc_len_mean=9)
    wi, di = corpus_mod.pad_corpus(corpus.word_ids, corpus.doc_ids, 512)
    valid = wi >= 0
    z0 = np.zeros(len(wi), np.int32)
    z0[valid] = np.random.default_rng(0).integers(0, K, int(valid.sum()))
    states, models = {}, {}
    for name in ("cuda", "cpu"):
        st = lda.init_state(wi[valid], K, V, z0=z0[valid], device=name)
        st = lda.LDAState(st.phi, st.psi, torch.from_numpy(z0).to(name), st.alpha, st.beta)
        w_t, d_t = torch.from_numpy(wi).to(name), torch.from_numpy(di).to(name)
        for e in range(SMALL["epochs"]):
            st = gibbs.gibbs_epoch(st, w_t, d_t, corpus.n_docs, V, seed=e * 31 + 7,
                                   block_size=512)
        states[name] = st
        models[name] = rtlda.build_model(st.phi, st.beta, st.alpha, device=name)
    q, _ = query_batch(corpus, 0, 256, 8)
    pkd = {n: make_serving_fn(device=n)(models[n], q, 3)[0].cpu() for n in models}
    for f in ("z", "phi", "psi"):
        a, b = getattr(states["cuda"], f).cpu(), getattr(states["cpu"], f)
        if not torch.equal(a, b):
            raise AssertionError(f"small loop: card and CPU {f} differ at "
                                 f"{int((a != b).sum())} entries")
    err = float((pkd["cuda"] - pkd["cpu"]).abs().max())
    if err > 1e-5:
        raise AssertionError(f"small loop: served pkd differs by {err}")
    st = states["cuda"]
    frac = dedup.duplicate_fraction(st.phi, st.beta, 0.5)
    _, n_clusters = dedup.cluster_topics(st.phi, st.beta, l1_threshold=0.3)
    log(f"[small] K={K} V={V}, {SMALL['epochs']} epochs: card == CPU for z, Φ, Ψ; "
        f"served pkd max |card − CPU| = {err:.3g}; duplicate fraction {frac:.3f}; "
        f"{K} topics → {n_clusters} after L1 merge")


# ------------------------------------------------------------ alias kernels
def events_ms(fn):
    """Device time of one run of ``fn()`` by CUDA events (for the slow plain
    versions, which run once)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def bound(bytes_moved, ops):
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def word_weights(R, K, seed):
    """Rows shaped like the cell's word proposal weights (φ+β)/(ψ+Vβ): sparse
    counts over a spread of topic totals."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    counts = torch.randint(1, 50, (R, K), generator=g, device="cuda", dtype=torch.int32)
    counts *= torch.rand((R, K), generator=g, device="cuda") < 0.002
    psi = torch.randint(1, 500, (K,), generator=g, device="cuda").to(torch.float32)
    return (counts.to(torch.float32) + 0.01) / (psi + FULL["vocab"] * 0.01)


def build_bytes(R, K):
    """Bytes the alias build must move: the weights [R, K] and the scale [R]
    read once, prob and alias [R, K] written once."""
    return 12 * R * K + 4 * R


def check_build(weights, scale, label):
    """alias_build kernel against the plain sweep on the same (weights, scale);
    returns the plain version's device ms and the largest |kernel − plain|."""
    from repro_torch.kernels.alias.kernel import alias_build_cuda
    pk, ak = alias_build_cuda(weights, scale)
    return check_tables(pk, ak, weights, scale, label)


def check_tables(pk, ak, weights, scale, label):
    """Kernel-built tables (pk, ak) against the plain sweep over the same rows
    (``ops._prepare`` then ``build_alias_ref``), bit for bit; returns the plain
    version's device ms and the largest |kernel − plain|."""
    from repro_torch.kernels.alias import ops
    from repro_torch.kernels.alias.ref import build_alias_ref
    plain_ms, (pp, ap) = events_ms(lambda: build_alias_ref(*ops._prepare(weights, scale)))
    torch.cuda.synchronize()
    bad = int((pk.view(torch.int32) != pp.view(torch.int32)).sum()) + int((ak != ap).sum())
    err = max(float((pk - pp).abs().max()), float((ak - ap).abs().max()))
    log(f"[alias-kernel] alias_build {label}: {bad} entries differ from the plain sweep "
        f"(plain {plain_ms:.1f} ms)")
    if bad:
        raise AssertionError(f"alias_build differs from its plain version at {label}")
    return plain_ms, err


def mh_case(T, K, V, D, n_mh):
    """Consistent counts, pairs (round-robin docs, ⌈T/D⌉ tokens each), α and
    kernel-built tables on the card: the tensor arguments of
    ``ops.mh_resample`` (phi … uid), and the pair cap."""
    from repro_torch.core import sparse
    g = torch.Generator(device="cuda").manual_seed(T + K + n_mh)
    w = torch.randint(0, V, (T,), generator=g, device="cuda", dtype=torch.int32)
    d = (torch.arange(T, device="cuda") % D).to(torch.int32)
    z = torch.randint(0, K, (T,), generator=g, device="cuda", dtype=torch.int32)
    phi = torch.zeros((V, K), dtype=torch.int32, device="cuda")
    phi.index_put_((w.long(), z.long()), torch.ones_like(z), accumulate=True)
    psi = torch.bincount(z.long(), minlength=K).to(torch.int32)
    cap = min(K, -(-T // D))
    tp, ct = sparse.pairs_from_assignments(d, z, torch.ones(T, dtype=torch.bool,
                                                            device="cuda"), D, cap)
    alpha = torch.full((K,), 50.0 / K, device="cuda")
    tabs = sparse.make_tables(phi, psi, alpha, 0.01, V)
    uid = torch.arange(T, dtype=torch.int64, device="cuda") * 7 + 3
    return (phi, psi, tp, ct, *tabs[:3], alpha, *tabs[3:], w, d, z, uid), cap


def check_mh(args, seed, n_mh, V, label):
    """mh_resample kernel (through the by-word dispatch) against the plain
    version on the card; returns the plain version's device ms and the
    largest |kernel − plain| (in topic ids)."""
    from repro_torch.kernels.alias import ops
    from repro_torch.kernels.alias.ref import mh_resample_ref
    zk = ops.mh_resample(*args, seed, 0.01, V, n_mh)
    beta = torch.tensor(0.01, device="cuda")
    plain_ms, zp = events_ms(lambda: mh_resample_ref(
        *args, ops.mh_seed(seed), beta, args[7].sum(dtype=torch.float32), V, n_mh))
    torch.cuda.synchronize()
    bad = int((zk != zp).sum())
    log(f"[alias-kernel] mh_resample {label}: {bad} of {zk.shape[0]} draws differ "
        f"from the plain version")
    if bad:
        raise AssertionError(f"mh_resample differs from its plain version at {label}")
    return plain_ms, float((zk - zp).abs().max())


def alias_kernel_phase():
    """Both alias kernels against their plain versions, bit for bit, at small
    shapes and at full K. ``alias_build`` is timed on one synthetic 2,048-row
    chunk, the α row and a synthetic 32,768 × 100,000 word table in one
    launch; its time on the cell's own table, and the full-cell timings of
    ``mh_resample``, come from ``alias_phase``."""
    from repro_torch.kernels.alias import ops
    from repro_torch.kernels.alias.kernel import alias_build_cuda, mh_slot_bound
    from repro_torch.kernels.alias.ref import edge_rows

    K, V = FULL["n_topics"], FULL["vocab"]
    rng = np.random.default_rng(11)
    errs = []
    for R, k in [(1, 8), (5, 37), (16, 128), (3, 513), (64, 4096)]:
        w = torch.from_numpy(rng.gamma(0.3, 1.0, (R, k)).astype(np.float32) + 1e-3).cuda()
        errs.append(check_build(w, ops._scale(w), f"R={R} K={k}")[1])
    for k in (1, 31, 32, 33, 63, 64, 65, 4097):
        w = torch.from_numpy(np.concatenate(
            [edge_rows(k), rng.gamma(0.3, 1.0, (37, k)).astype(np.float32)])).cuda()
        errs.append(check_build(w, ops._scale(w), f"edge rows + 37 gamma rows K={k}")[1])

    # a synthetic word table in one launch; its first 2,048 rows are the
    # chunk timed alone below (seed 5)
    R = 2048
    table = torch.empty((V, K), device="cuda")
    for lo in range(0, V, R):
        table[lo:lo + R] = word_weights(R, K, seed=5 + lo)
    scale = ops._scale(table)
    out = (torch.empty_like(table), torch.empty((V, K), dtype=torch.int32, device="cuda"))
    alias_build_cuda(table, scale, out=out)
    torch.cuda.synchronize()
    ms = timed_ms(lambda: alias_build_cuda(table, scale, out=out), reps=3, warmup=0)
    bound_ms, bound_by = bound(build_bytes(V, K), SWEEP_OPS_PER_SLOT * V * K)
    log(f"[alias-kernel] alias_build R={V} K={K} (a synthetic word table, one launch): "
        f"kernel_ms={ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
        f"share_of_bound={bound_ms / ms:.5f}")

    # a 2,048-row chunk and the α row, each alone
    chunk = table[:R]
    alpha = torch.full((1, K), 50.0 / K, device="cuda")
    c_scale = ops._scale(chunk)
    c_out = (torch.empty_like(chunk), torch.empty((R, K), dtype=torch.int32, device="cuda"))
    c_ms = timed_ms(lambda: alias_build_cuda(chunk, c_scale, out=c_out), reps=5, warmup=1)
    c_bound, _ = bound(build_bytes(R, K), SWEEP_OPS_PER_SLOT * R * K)
    log(f"[alias-kernel] alias_build R={R} K={K} (a synthetic table chunk): kernel_ms={c_ms:.4f} "
        f"bound_ms={c_bound:.4f} share_of_bound={c_bound / c_ms:.5f}")
    a_ms = timed_ms(lambda: alias_build_cuda(alpha, ops._scale(alpha)), reps=5, warmup=1)
    log(f"[alias-kernel] alias_build R=1 K={K} (the α table, with _scale): {a_ms:.4f} ms")

    # one plain sweep holds both: the chunk plus the α row (R = 2,049), and a
    # 2,049-row sample of the whole table (the first, the last, strided rows).
    # Its K = 100,000 steps of small launches take about a minute of host
    # time whatever the rows, so the tables and their inputs wait on the host
    # for ``full_k_sweep``, which runs beside a phase that leaves the card idle
    ca = torch.cat([chunk, alpha])
    ca_scale = ops._scale(ca)
    pk, ak = alias_build_cuda(ca, ca_scale)
    rows = torch.linspace(0, V - 1, R + 1, device="cuda").round().long()
    sweep = dict(pk=torch.cat([pk, out[0][rows]]).cpu(), ak=torch.cat([ak, out[1][rows]]).cpu(),
                 weights=torch.cat([ca, table[rows]]).cpu(),
                 scale=torch.cat([ca_scale, scale[rows]]).cpu(),
                 label=f"R={R}+1 K={K} (a table chunk and the α row) and {R + 1} rows of the "
                       f"whole table")
    del table, out, chunk, c_out, ca, pk, ak
    torch.cuda.empty_cache()
    # ms and its bound at the main path's shape come from alias_phase (the
    # cell's own wq); plain_ms covers the 4,098 rows of the one plain sweep
    # (``full_k_sweep`` adds it and its error)
    build = dict(plain_shape=[2 * R + 2, K], max_abs_err=max(errs))

    mh_errs = []
    # pair caps 5, 16, 8 and 20 take the 16- and 32-slot register kernels,
    # cap 64 the generic one; the last case: 262,144 tokens over R = 2,048
    # words at full K, 16 tokens to a doc, so (nearly) every pair row is full
    for T, k, V, D, n_mh in [(37, 16, 20, 8, 1), (300, 16, 20, 8, 5), (64, 130, 20, 8, 4),
                             (4000, 512, 20, 200, 4), (256, 130, 20, 4, 4),
                             (128 * R, K, R, 8 * R, 5)]:
        args, cap = mh_case(T, k, V, D, n_mh)
        slots = mh_slot_bound(cap)
        path = f"{slots}-slot register kernel" if slots else "generic kernel"
        for seed in (0, 0xFFFF_FFFF):
            mh_errs.append(check_mh(args, seed, n_mh, V,
                                    f"T={T} K={k} cap={cap} ({path}) n_mh={n_mh} "
                                    f"seed={seed}")[1])
        del args
    torch.cuda.empty_cache()
    return build, max(mh_errs), sweep


def full_k_sweep(sweep):
    """``alias_kernel_phase``'s K = 100,000 tables against the plain sweep,
    on a stream of its own; returns ``check_tables``' (plain ms, error)."""
    with torch.cuda.stream(torch.cuda.Stream()):
        args = [sweep[k].cuda() for k in ("pk", "ak", "weights", "scale")]
        out = check_tables(*args, sweep["label"])
    del args
    torch.cuda.empty_cache()
    return out


class Beside(threading.Thread):
    """``fn(*args)`` on a thread beside the phase that the caller runs;
    ``result()`` joins it and returns its value or raises its error."""

    def __init__(self, fn, *args):
        super().__init__(daemon=True)
        self.fn, self.args, self.value, self.error = fn, args, None, None
        self.start()

    def run(self):
        try:
            self.value = self.fn(*self.args)
        except BaseException as exc:  # noqa: BLE001 (re-raised by result)
            self.error = exc

    def result(self):
        self.join()
        if self.error is not None:
            raise self.error
        return self.value


# --------------------------------------------------------------- alias phase
def tile_corpus(corpus, n):
    """``n`` copies of ``corpus``, each copy new docs (and so new token uids)."""
    from repro_torch.data.corpus import Corpus
    offs = np.repeat(np.arange(n, dtype=np.int32) * corpus.n_docs, corpus.n_tokens)
    return Corpus(np.tile(corpus.word_ids, n), np.tile(corpus.doc_ids, n) + offs,
                  corpus.n_docs * n, corpus.vocab_size)


def mh_bytes(args, seed2, beta, asum, V, n_mh, n_docs, cap_p):
    """Bytes the MH probe must move for the tokens of ``args`` (the tensors
    phi … uid of ``ops.mh_resample``), each input byte read once and the
    output written once, counted two ways → (per gather, distinct sectors).
    Both charge per token w, d, z, out (4 B) and uid (8 B), and once each the
    pair table (n_docs · cap_p topics and counts) and the [K] vectors ψ, α,
    ap, aa. The gathers into the [rows, K] tables are φ_ws for p(z0) and φ_wt
    for each step's p(t), and per word step wp_jk, wq_s and wq_t, plus wa_jk
    where the coin rejects wp_jk: the entries this run's chain reads, from
    the plain version's trace. "Per gather" charges each its own 32-byte
    sector; "distinct" charges each 32-byte sector once, however many tokens
    read it (tokens sorted by word that share (w, k) share φ_wk's sector)."""
    from repro_torch.kernels.alias.ref import mh_resample_ref
    phi, w, z = args[0], args[10], args[12]
    T, K = w.shape[0], phi.shape[1]
    trace = []
    mh_resample_ref(*args, seed2, beta, asum, V, n_mh, trace=trace)
    row = w.long() * K
    read = {"phi": [row + z.long()], "wq": [], "wp": [], "wa": []}
    for s, t, jk, rejects in trace:
        read["phi"].append(row + t)
        if rejects is not None:                        # a word step
            read["wq"] += [row + s, row + t]
            read["wp"].append(row + jk)
            read["wa"].append((row + jk)[rejects])
    per_gather = sum(int(x.numel()) for v in read.values() for x in v)
    distinct = sum(int(torch.unique(torch.cat(v) // 8).numel()) for v in read.values() if v)
    fixed = T * 24 + n_docs * cap_p * 8 + 4 * K * 4
    return fixed + 32 * per_gather, fixed + 32 * distinct


def mh_ops(T, cap, n_mh):
    """Scalar operations of the MH probe for T tokens: per step 4 uniforms of
    ~14 integer ops, up to 3 pair-row lookups or the walk (2 per slot), and
    ~30 for the proposal, the posterior and the ratio."""
    return T * (2 * cap + n_mh * (4 * 14 + 3 * 2 * cap + 30))


def alias_phase(base):
    from repro_torch.core import dedup, distributed as dist, lda, rtlda, sparse
    from repro_torch.core.features import make_serving_fn
    from repro_torch.data import corpus as corpus_mod
    from repro_torch.kernels.alias import ops
    from repro_torch.kernels.alias.kernel import alias_build_cuda, mh_resample_cuda

    K, V = FULL["n_topics"], FULL["vocab"]
    corpus = tile_corpus(base, ALIAS["tiles"])
    t0 = time.perf_counter()
    sc = corpus_mod.shard_corpus(corpus, 1, 1, K, seed=0)
    cap = sc.word_local.shape[2]
    cap_p = sparse.suggest_cap(corpus.doc_lengths(), K)
    D = sc.docs_per_shard
    log(f"[alias] corpus: {corpus.n_docs} docs, {corpus.n_tokens} tokens; ring of one "
        f"device: rows {sc.rows_per_shard}, cap {cap}, pair cap {cap_p} "
        f"(shard_corpus {time.perf_counter() - t0:.1f} s on the host)")
    cfg = dist.RingConfig(n_topics=K, vocab_size=V, rows_per_shard=sc.rows_per_shard,
                          docs_per_shard=D, cap=cap, package_len=cap, n_rounds=1,
                          sampler="alias", n_mh=ALIAS["n_mh"], doc_topic_cap=cap_p)
    epoch = dist.build_epoch_body(cfg)
    torch.cuda.reset_peak_memory_stats()
    state = dist.device_arrays(sc, K, device="cuda")
    phi, psi, wl, dl, uid, z = state
    alpha = torch.full((K,), 50.0 / K, device="cuda")
    beta = torch.tensor(0.01, device="cuda")
    ll0 = float(lda.word_log_likelihood(phi[0], psi, beta))
    lengths = torch.from_numpy(corpus.doc_lengths()).cuda()
    torch.cuda.synchronize()

    # ---- the main path: counts from 0, train → α → export → serve ----
    ops.build_launches = ops.mh_launches = 0
    tables, build_s, epoch_s = None, [], []
    for e in range(ALIAS["epochs"]):
        if e % ALIAS["agg_every"] == 0:           # the aggregation-boundary rebuild
            tables = None
            t0 = time.perf_counter()
            tables = sparse.make_tables(phi, psi, alpha, beta, V)
            torch.cuda.synchronize()
            build_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        epoch(*state, alpha, beta, e * 977 + 3, *tables)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
    valid = wl.reshape(-1) >= 0
    tp, ct = sparse.pairs_from_assignments(dl.reshape(-1), z.reshape(-1), valid, D, cap_p)
    omega = sparse.pairs_topic_histogram(tp, ct, K)
    alpha2 = dedup.optimize_alpha(alpha, omega, dedup.doc_length_histogram(lengths),
                                  n_iters=5)
    if not bool(torch.isfinite(alpha2).all() & (alpha2 > 0).all()):
        raise AssertionError("optimize_alpha gave a non-finite or non-positive α")
    ap, aa = sparse.make_alpha_table(alpha2)             # α moved: refresh its table
    torch.cuda.synchronize()
    del tables, ap, aa
    ll1 = float(lda.word_log_likelihood(phi[0], psi, beta))
    phi_full = dist.gather_phi(phi, sc)
    model = rtlda.build_model(phi_full, beta, alpha2, device="cuda")
    del phi_full
    serve = make_serving_fn(n_iters=5, n_trials=2, top_n=30, device="cuda")
    times = []
    for b in range(ALIAS["batches"]):
        q, _ = query_batch(corpus, b * ALIAS["batch"], ALIAS["batch"], ALIAS["bucket"])
        t0 = time.perf_counter()
        pkd, ids, _ = serve(model, q, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if pkd.shape != (ALIAS["batch"], K) or not bool(torch.isfinite(pkd).all()):
            raise AssertionError("alias pkd has the wrong shape or non-finite values")
        if float((pkd.sum(dim=1) - 1).abs().max()) > 1e-5:
            raise AssertionError("an alias pkd row does not sum to 1 within 1e-5")
        if not bool(((ids >= 0) & (ids < V)).all()):
            raise AssertionError("alias feature ids out of [0, V)")
    launches = dict(alias_build=ops.build_launches, mh_resample=ops.mh_launches)
    # ---- end of the main path ----

    n_builds = -(-ALIAS["epochs"] // ALIAS["agg_every"])
    expected = dict(alias_build=n_builds * (phi.shape[0] + 1) + 1,
                    mh_resample=ALIAS["epochs"] * (cap // cfg.package_len))
    peak = torch.cuda.max_memory_allocated() / 2**30
    train_s = sum(epoch_s) + sum(build_s)
    log(f"[alias] table build s {[round(t, 4) for t in build_s]}; tokens/s per epoch "
        f"{[round(corpus.n_tokens / t, 1) for t in epoch_s]}; serve batch s "
        f"{[round(t, 4) for t in times]}")
    log(f"[alias] training window: {ALIAS['epochs']} epochs x {corpus.n_tokens} tokens in "
        f"{train_s:.4f} s, table builds included ({sum(build_s):.4f} s of it): "
        f"{ALIAS['epochs'] * corpus.n_tokens / train_s:.1f} tokens/s")
    log(f"[alias] word LL {ll0:.6e} -> {ll1:.6e}; α sum {float(alpha2.sum()):.4f} (was 50.0); "
        f"launches {launches} (expected {expected}); max_memory_allocated={peak:.2f} GiB")
    if launches != expected:
        raise AssertionError(f"alias launches {launches}, expected {expected}")
    if not ll1 > ll0:
        raise AssertionError(f"alias training did not raise the word LL: {ll0} -> {ll1}")
    counts, _ = lda.build_counts(wl[wl >= 0], z[wl >= 0], K, sc.rows_per_shard)
    if not torch.equal(counts, phi[0]):
        raise AssertionError("Φ disagrees with the travelling z")
    del counts
    if int(psi.sum()) != corpus.n_tokens or not torch.equal(phi.sum(dim=(0, 1)), psi):
        raise AssertionError("Σψ is not the token count, or Φ's column sums are not Ψ")
    del model
    torch.cuda.empty_cache()

    # where the time goes: one more table build and one more epoch, profiled
    holder = []
    device_breakdown("alias table build", lambda: holder.append(
        sparse.make_tables(phi, psi, alpha2, beta, V)))
    tables = holder.pop()
    device_breakdown("alias epoch", lambda: epoch(*state, alpha2, beta, 99, *tables))

    # alias_build at the main path's shape, on the cell's own wq: the shard's
    # tables rebuilt in place, which must give the same bits again
    wq0, out0 = tables[0][0], (tables[1][0], tables[2][0])
    rows = torch.linspace(0, wq0.shape[0] - 1, 2049, device="cuda").round().long()
    kept = (out0[0][rows].clone(), out0[1][rows].clone())
    scale0 = ops._scale(wq0)
    build_ms = timed_ms(lambda: alias_build_cuda(wq0, scale0, out=out0), reps=3, warmup=0)
    if not (torch.equal(out0[0][rows].view(torch.int32), kept[0].view(torch.int32))
            and torch.equal(out0[1][rows], kept[1])):
        raise AssertionError("alias_build rebuilt the cell's tables with other bits")
    build_bound, build_by = bound(build_bytes(*wq0.shape), SWEEP_OPS_PER_SLOT * wq0.numel())
    log(f"[alias-kernel] alias_build R={wq0.shape[0]} K={K} (the cell's own wq, one launch): "
        f"kernel_ms={build_ms:.4f} bound_ms={build_bound:.4f} ({build_by}) "
        f"share_of_bound={build_bound / build_ms:.5f}; 2,049 rebuilt rows equal the "
        f"main path's")
    del kept

    # the MH kernel at the cell's shape: this epoch's one package
    pairs = sparse.pairs_from_assignments(dl.reshape(-1), z.reshape(-1), valid, D, cap_p)
    w0, d0, z0 = (torch.where(wl[0, 0] >= 0, x[0, 0], 0) for x in (wl, dl, z))
    args = (phi[0], psi, *pairs, *(t[0] for t in tables[:3]), alpha2, *tables[3:], w0, d0,
            z0, uid[0, 0])
    plain_ms, err = check_mh(args, 7, ALIAS["n_mh"], V,
                             f"full cell T={cap} cap={cap_p} n_mh=4")
    order = torch.sort(w0, stable=True).indices
    srt = [x[order].contiguous() for x in (w0, d0, z0, uid[0, 0])]
    asum = alpha2.sum(dtype=torch.float32)
    ms = timed_ms(lambda: mh_resample_cuda(*args[:10], *srt, ops.mh_seed(7), beta, asum,
                                           V, ALIAS["n_mh"]), reps=10)
    per_gather, distinct = mh_bytes(args, ops.mh_seed(7), beta, asum, V, ALIAS["n_mh"], D,
                                    cap_p)
    n_ops = mh_ops(cap, cap_p, ALIAS["n_mh"])
    gather_ms, _ = bound(per_gather, n_ops)
    bound_ms, bound_by = bound(distinct, n_ops)
    log(f"[alias-kernel] mh_resample T={cap} cap={cap_p} n_mh=4 (words sorted): "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}, "
        f"each distinct 32-byte sector once: {distinct} B) share_of_bound={bound_ms / ms:.5f}; "
        f"charging each gather its own sector: {per_gather} B, {gather_ms:.4f} ms, share "
        f"{gather_ms / ms:.5f}")
    del args, tables, state, phi, psi, wl, dl, uid, z, pairs
    torch.cuda.empty_cache()
    mh = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
              bound_ms_per_gather=gather_ms, max_abs_err=err)
    return launches, mh, dict(ms=build_ms, bound_ms=build_bound, bound_by=build_by,
                              shape=list(wq0.shape))


def alias_small_phase():
    """Quickstart scale: the card's alias loop against the same loop on the
    CPU. The tables are built once, on the CPU, and carried to the card, so
    both sample against the same proposals (α is 50/16 per topic, so its sum
    is exact on either device)."""
    from repro_torch.core import distributed as dist, sparse
    from repro_torch.data import corpus as corpus_mod, synthetic

    K, V = SMALL["n_topics"], SMALL["vocab"]
    corpus, _ = synthetic.lda_corpus(seed=0, n_docs=SMALL["n_docs"],
                                     n_topics=SMALL["gen_topics"], vocab_size=V,
                                     doc_len_mean=9)
    sc = corpus_mod.shard_corpus(corpus, 1, 1, K, seed=1)
    cap = sc.word_local.shape[2]
    cap_p = sparse.suggest_cap(corpus.doc_lengths(), K)
    cfg = dist.RingConfig(n_topics=K, vocab_size=V, rows_per_shard=sc.rows_per_shard,
                          docs_per_shard=sc.docs_per_shard, cap=cap, package_len=cap // 2,
                          n_rounds=1, sampler="alias", n_mh=ALIAS_SMALL["n_mh"],
                          doc_topic_cap=cap_p)
    epoch = dist.build_epoch_body(cfg)
    states = {dev: dist.device_arrays(sc, K, device=dev) for dev in ("cuda", "cpu")}
    alpha = {dev: torch.full((K,), 50.0 / K, device=dev) for dev in states}
    beta = {dev: torch.tensor(0.01, device=dev) for dev in states}
    for e in range(ALIAS_SMALL["epochs"]):
        if e % ALIAS_SMALL["agg_every"] == 0:
            cpu = states["cpu"]
            tabs = sparse.make_tables(cpu[0], cpu[1], alpha["cpu"], beta["cpu"], V)
        for dev, st in states.items():
            epoch(*st, alpha[dev], beta[dev], e * 977 + 3, *(t.to(dev) for t in tabs))
    for i, name in ((0, "phi"), (1, "psi"), (5, "z")):
        a, b = states["cuda"][i].cpu(), states["cpu"][i]
        if not torch.equal(a, b):
            raise AssertionError(f"small alias loop: card and CPU {name} differ at "
                                 f"{int((a != b).sum())} entries")
    pairs = {}
    for dev, (_, _, wl, dl, _, z) in states.items():
        pairs[dev] = sparse.pairs_from_assignments(dl.reshape(-1), z.reshape(-1),
                                                   wl.reshape(-1) >= 0, sc.docs_per_shard,
                                                   cap_p)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(pairs["cuda"], pairs["cpu"])):
        raise AssertionError("small alias loop: card and CPU pairs differ")
    log(f"[alias-small] K={K} V={V}, {ALIAS_SMALL['epochs']} epochs in packages of "
        f"{cfg.package_len}: card == CPU for z, Φ, Ψ and the pairs")


# ------------------------------------------------------------- trainer phase
# the port's Trainer at full width on FULL's corpus: the dense ring in packages
# of at most 10,000 tokens, α re-estimated from the second epoch (index 1) on;
# then the default and the optimized ring form (int8 Θ, column exclusion,
# small Θ) two epochs each; then the dense and the alias sampler from one z0
# with α held, for their LL curves
TRAINER = dict(epochs=3, alpha_from=1, max_package=10_000, form_epochs=2, ll_epochs=8)
# the small launch.train loop: SMALL's geometry, killed after epoch 4 of 6
TRAINER_SMALL = dict(epochs=6, kill_at=4, ckpt_every=2)


def package_len_for(cap, most):
    """The largest divisor of ``cap`` not above ``most``."""
    return max(L for L in range(1, min(cap, most) + 1) if cap % L == 0)


def check_ring_state(state, rows, n_tokens, K, label):
    """Φ equals the counts of the stack's z, and Ψ is Φ's column sums and
    sums to the token count."""
    from repro_torch.core import lda
    phi, psi, wl, _, _, z = state
    valid = wl >= 0
    counts, _ = lda.build_counts(wl[valid], z[valid], K, rows)
    same = torch.equal(counts, phi[0])
    del counts
    if not same:
        raise AssertionError(f"{label}: Φ is not the counts of the stack's z")
    if int(psi.sum()) != n_tokens or not torch.equal(phi.sum(dim=(0, 1)), psi):
        raise AssertionError(f"{label}: Σψ is not the token count, or Φ's column sums "
                             f"are not Ψ")


@contextlib.contextmanager
def held(module, name, check, first_only=False):
    """Within the block, calls that the port makes to ``module.name`` (a
    kernel's wrapper) launch as before and then go to ``check(result, args)``:
    every call, or only the first. Yields the list of the checks' returns."""
    launch, seen = getattr(module, name), []

    def call(*args, **kw):
        out = launch(*args, **kw)
        if not (first_only and seen):
            seen.append(check(out, args))
        return out
    setattr(module, name, call)
    try:
        yield seen
    finally:
        setattr(module, name, launch)


def gibbs_check(to, label):
    """A ``held`` check of ``gibbs_argmax``: the plain version on the call's
    inputs moved to ``to``; fails on a draw that differs beyond a near-tie."""
    def check(zk, args):
        seed, V, tau = args[6:9]
        mism, bad, gap = near_ties(zk, [a.to(to) for a in args[:6]], seed, V, tau)
        if bad:
            raise AssertionError(f"{label}: gibbs_argmax at T={args[0].shape[0]} "
                                 f"K={args[0].shape[1]} differs from its plain version on "
                                 f"{bad} tokens beyond a near-tie")
        return dict(T=args[0].shape[0], psi="row" if args[1].dim() == 1 else "plane",
                    mismatches=mism, max_gap=gap)
    return check


def mh_check(label):
    """A ``held`` check of ``mh_resample``: the plain version on the call's
    inputs, bit for bit."""
    from repro_torch.kernels.alias import ops as alias_ops
    from repro_torch.kernels.alias.ref import mh_resample_ref

    def check(zk, args):
        seed, beta, V, n_mh = args[14:18]
        beta = torch.as_tensor(beta, dtype=torch.float32, device=zk.device).reshape(())
        zp = mh_resample_ref(*args[:14], alias_ops.mh_seed(seed), beta,
                             args[7].sum(dtype=torch.float32), V, n_mh)
        bad = int((zk != zp).sum())
        if bad:
            raise AssertionError(f"{label}: mh_resample differs from its plain version on "
                                 f"{bad} of {zk.shape[0]} draws")
        return dict(T=zk.shape[0], differ=bad)
    return check


def trainer_phase(corpus, gibbs_epoch_stats):
    """FULL's corpus through the port's Trainer at K = 100,000, V = 32,768."""
    import dataclasses
    from repro_torch.core import distributed as dist, rtlda
    from repro_torch.core.features import make_serving_fn
    from repro_torch.data import corpus as corpus_mod
    from repro_torch.kernels.alias import ops as alias_ops
    from repro_torch.kernels.gibbs import ops
    from repro_torch.training import (AlphaOptimizer, Metrics, Trainer, TrainerCallback,
                                      TrainerConfig)

    K, V, T = FULL["n_topics"], FULL["vocab"], corpus.n_tokens
    cap, _ = corpus_mod.shard_corpus(corpus, 1, 1, K, seed=1, probe_only=True)
    L = package_len_for(cap, TRAINER["max_package"])
    n_pkg = cap // L
    log(f"[trainer] FULL corpus: {corpus.n_docs} docs, {T} tokens; ring of one device, cap "
        f"{cap}: package_len {L} ({n_pkg} packages an epoch)")
    say = lambda msg: log(f"[trainer] {msg}")
    cfg = TrainerConfig(n_docs=corpus.n_docs, vocab_size=V, n_topics=K, sampler="dense",
                        n_epochs=TRAINER["epochs"], alpha_opt_from=TRAINER["alpha_from"],
                        package_len=L, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, callbacks=[AlphaOptimizer(), Metrics(printer=say)], corpus=corpus)
    tr.log = say
    tr.setup()
    ll0 = tr.log_likelihood()
    torch.cuda.synchronize()
    log(f"[trainer] setup (shard_corpus, device state) {time.perf_counter() - t0:.2f} s; "
        f"word LL at z0 {ll0:.6e}")

    # ---- the main path: counts from 0, Trainer.fit ----
    ops.launches = 0
    tr.fit()
    torch.cuda.synchronize()
    launches = ops.launches
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated() / 2**30
    expected = TRAINER["epochs"] * n_pkg
    if launches != expected:
        raise AssertionError(f"Trainer: gibbs_argmax launched {launches} times, expected "
                             f"{expected}")
    lls = tr.metrics["ll"]
    if not lls[-1] > ll0:
        raise AssertionError(f"Trainer did not raise the word LL: {ll0} -> {lls[-1]}")
    check_ring_state(tr.state, tr.sc0.rows_per_shard, T, K, "Trainer")
    if not bool(torch.isfinite(tr.alpha).all() & (tr.alpha > 0).all()) \
            or abs(float(tr.alpha.sum()) - 50.0) < 1e-3:
        raise AssertionError("AlphaOptimizer left α non-finite, non-positive or unmoved")
    rates = [T / t for t in tr.metrics["epoch_s"]]
    log(f"[trainer] dense ring, {TRAINER['epochs']} epochs: tokens/s per epoch "
        f"{[round(r, 1) for r in rates]}; word LL {[f'{x:.6e}' for x in lls]}; "
        f"α sum {float(tr.alpha.sum()):.4f} (was 50.0); launches gibbs_argmax={launches} "
        f"(expected {expected}); max_memory_allocated={peak:.2f} GiB over the session "
        f"(setup, epochs, LL, α)")
    log(f"[trainer] beside the gibbs_epoch path (blocks of {FULL['block']}, no ring): "
        f"tokens/s per epoch {[round(r, 1) for r in gibbs_epoch_stats['tokens_per_s']]}, "
        f"max_memory_allocated={gibbs_epoch_stats['peak_gib']:.2f} GiB")

    # ---- the two ring forms, each from its own peak reset ----
    opt_cfg = dataclasses.replace(tr.ring_cfg, theta_dtype=torch.int8,
                                  column_exclusion=True, small_theta=True)
    epochs = {"default": dist.build_epoch_body(tr.ring_cfg),
              "optimized": dist.build_epoch_body(opt_cfg)}
    forms = {}
    n = TRAINER["form_epochs"]
    for name, ring_cfg in (("default", tr.ring_cfg), ("optimized", opt_cfg)):
        epoch = epochs[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.launches = 0
        secs = []
        for e in range(n):
            t0 = time.perf_counter()
            epoch(*tr.state, tr.alpha, tr.beta, 1000 + len(forms) * 10 + e)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        if ops.launches != n * n_pkg:
            raise AssertionError(f"{name} ring: {ops.launches} launches, expected {n * n_pkg}")
        forms[name] = dict(tokens_per_s=[T / t for t in secs],
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        check_ring_state(tr.state, tr.sc0.rows_per_shard, T, K, f"{name} ring")
        log(f"[trainer] {name} ring form ({ring_form(ring_cfg)}), {n} epochs: tokens/s "
            f"{[round(r, 1) for r in forms[name]['tokens_per_s']]}; max_memory_allocated={forms[name]['peak_gib']:.2f} GiB from the epoch's start "
            f"(Φ {tr.state[0].numel() * 4 / 2**30:.2f} GiB resident)")
    # ---- gibbs_argmax on the first package of a ring epoch, each form, held
    # against its plain version on the card (launches here are not counted) ----
    for i, (name, epoch) in enumerate(epochs.items()):
        with held(ops, "gibbs_argmax", gibbs_check("cuda", f"{name} ring"),
                  first_only=True) as seen:
            epoch(*tr.state, tr.alpha, tr.beta, 2000 + i)
        torch.cuda.synchronize()
        log(f"[trainer] {name} ring form, first package of an epoch: gibbs_argmax against "
            f"its plain version on the card: {seen[0]}; differing draws are near-ties "
            f"(≤ 4 ulp)")
    for name, epoch in epochs.items():
        device_breakdown(f"trainer ring epoch, {name} form",
                         lambda: epoch(*tr.state, tr.alpha, tr.beta, 99))

    # ---- export and serve, as the other phases do ----
    phi_full = tr.gather_phi()
    model = rtlda.build_model(phi_full, tr.beta, tr.alpha, device="cuda")
    del phi_full
    q, _ = query_batch(corpus, 0, FULL["batch"], FULL["bucket"])
    pkd, ids, _ = make_serving_fn(n_iters=5, n_trials=2, top_n=30, device="cuda")(model, q, 5)
    torch.cuda.synchronize()
    if pkd.shape != (FULL["batch"], K) or not bool(torch.isfinite(pkd).all()) \
            or float((pkd.sum(dim=1) - 1).abs().max()) > 1e-5 \
            or not bool(((ids >= 0) & (ids < V)).all()):
        raise AssertionError("trainer model: served pkd or ids out of shape or range")
    log(f"[trainer] build_model(gather_phi) and one served batch of {FULL['batch']}: pkd "
        f"rows sum to 1 within 1e-5, ids in [0, V)")
    del model, pkd, ids, tr
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the dense and the alias sampler from one z0, α held: LL per epoch
    # and the share of tokens whose topic changed in each epoch ----
    class Moved(TrainerCallback):
        def on_train_start(self, trainer):
            self.z, self.shares = trainer.state[5].clone(), []

        def on_epoch_end(self, trainer, epoch):
            z, valid = trainer.state[5], trainer.state[2] >= 0
            self.shares.append(float((z != self.z)[valid].sum()) / float(valid.sum()))
            self.z = z.clone()

    curves, moved, ll_launches = {}, {}, {}
    for sampler in ("dense", "alias"):
        c = cfg.replace(sampler=sampler, n_epochs=TRAINER["ll_epochs"], alpha_opt_from=99)
        mv = Moved()
        t = Trainer(c, callbacks=[Metrics(printer=lambda m: None), mv], corpus=corpus)
        t.log = lambda m: None
        t.setup()
        ll_z0 = t.log_likelihood()
        ops.launches = alias_ops.build_launches = alias_ops.mh_launches = 0
        t.fit()
        torch.cuda.synchronize()
        n = dict(gibbs_argmax=ops.launches, alias_build=alias_ops.build_launches,
                 mh_resample=alias_ops.mh_launches)
        want = "gibbs_argmax" if sampler == "dense" else "mh_resample"
        if n[want] != TRAINER["ll_epochs"] * n_pkg or (sampler == "alias"
                                                      and n["alias_build"] == 0):
            raise AssertionError(f"{sampler} Trainer: launches {n}")
        check_ring_state(t.state, t.sc0.rows_per_shard, T, K, f"{sampler} Trainer")
        curves[sampler], moved[sampler], ll_launches[sampler] = [ll_z0] + t.metrics["ll"], \
            mv.shares, n
        log(f"[trainer-ll] {sampler}: {TRAINER['ll_epochs']} epochs from the shared z0, α held "
            f"at 50/K; launches {n}; epoch s {[round(x, 4) for x in t.metrics['epoch_s']]}; "
            f"share of tokens that changed topic per epoch {[round(x, 6) for x in mv.shares]}")
        if sampler == "alias":
            # mh_resample on the first package of one more epoch, held against
            # its plain version on the card bit for bit (not counted)
            with held(alias_ops, "mh_resample", mh_check("alias Trainer"),
                      first_only=True) as seen:
                t._epoch_fn(*t.state, t.alpha, t.beta, 3000, *t._epoch_tables())
            torch.cuda.synchronize()
            log(f"[trainer-ll] alias Trainer, first package of an epoch: mh_resample against "
                f"its plain version on the card: {seen[0]}")
        del t
        gc.collect()
        torch.cuda.empty_cache()
    if curves["dense"][0] != curves["alias"][0]:
        raise AssertionError("the two samplers did not start from one z0")
    log("[trainer-ll] word LL after each epoch (epoch 0 = z0): " + "; ".join(
        f"{e}: dense {d:.6e} alias {a:.6e}"
        for e, (d, a) in enumerate(zip(curves["dense"], curves["alias"]))))
    return launches, ll_launches


def ring_form(cfg):
    return (f"Θ {str(cfg.theta_dtype).replace('torch.', '')}, "
            f"{'column exclusion' if cfg.column_exclusion else 'ψ plane'}, "
            f"{'small Θ' if cfg.small_theta else 'dense Θ'}")


# ------------------------------------------------------------- quality phase
# the paper's application layer (bench_quality's and bench_pipeline's
# functions) at full width on FULL's corpus: one dense model a K (gibbs_epoch
# in blocks of 8,192, 25 epochs, α held, z0 from a seeded CPU generator)
# serves Fig. 7's MAP and Fig. 8's AUC; Fig. 1's PMI at K = 1,024 only (a host
# argsort of Φ); the guardrail on FULL's train docs tiled 10× at K = 10⁴ and
# 10⁵; Table 1's package sweep on FULL's shard at K = 10⁵
QUALITY = dict(ks=(1024, 10_000, 100_000), epochs=25, block=8192, n_impr=8000, steps=400,
               pmi_k=1024, cpu_steps=3, guard_tiles=10, guard_ks=(10_000, 100_000),
               guard_sweeps=25, clean_ks=(8,), clean_timeout_s=600,
               sweep_most=(2_500, 5_000, 10_000),
               sweep_epochs=2)


def all_counts(zero=False):
    """Every kernel's launch count (each set to 0 first, with ``zero``)."""
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    if zero:
        zero_counts()
        bag_ops.launches = 0
    return dict(read_counts(), embedding_bag=bag_ops.launches)


def fold_check(label):
    """A ``held`` check of ``gibbs.fold_in``: every row of θ sums to its
    doc's length."""
    def check(out, args):
        want = torch.bincount(args[5].long(), minlength=args[7])
        if not torch.equal(out[1].sum(dim=1, dtype=torch.int64), want):
            raise AssertionError(f"{label}: a fold-in θ row does not sum to its doc's length")
        return out[1].shape[0]
    return check


def timed_check(check, spent):
    """``check`` that adds its own seconds to ``spent`` [0] (so a timed run
    can leave them out)."""
    def run(out, args):
        t0 = time.perf_counter()
        res = check(out, args)
        spent[0] += time.perf_counter() - t0
        return res
    return run


def unit(x, label):
    if not (np.isfinite(x) and 0.0 <= x <= 1.0):
        raise AssertionError(f"{label} = {x} is not a finite number in [0, 1]")
    return x


def ctr_f64_steps(clog, dense, n):
    """``n`` steps of the port's ``train_step`` in float64 on the CPU from the
    zero init, on ``_fit_ctr``'s train rows: the reference that the card's
    and the CPU port's f32 steps are held against."""
    from repro_torch.benchmarks import bench_quality as bq
    from repro_torch.optim import l1_loglinear
    n_tr = len(clog["label"]) * 4 // 5
    f64 = dict(dtype=torch.float64)
    sp = torch.from_numpy(clog["ad_feat"][clog["ad_idx"]][:n_tr].astype(np.int64))
    lb = torch.from_numpy(clog["label"][:n_tr].astype(np.float64))
    st = l1_loglinear.CTRState(torch.zeros(clog["n_ad_features"], **f64),
                               torch.zeros(dense.shape[1], **f64), torch.zeros((), **f64))
    dx = dense[:n_tr].double()
    for _ in range(n):
        st, _ = l1_loglinear.train_step(st, sp, dx, lb, bq.CTR_LR, bq.CTR_L1)
    return st


def quality_full(corpus, truth):
    """Fig. 1, 7 and 8 at K = 1,024, 10⁴ and 10⁵ on FULL's corpus."""
    from repro_torch.benchmarks import bench_quality as bq
    from repro_torch.core import gibbs, lda
    from repro_torch.data import synthetic
    from repro_torch.kernels.gibbs import ops

    dev = torch.device("cuda")
    q, u, lab = synthetic.relevance_judgments(3, corpus, truth)
    clog = bq.ctr_log(corpus, truth, QUALITY["n_impr"])
    n_tr, steps = QUALITY["n_impr"] * 4 // 5, QUALITY["steps"]

    def fit(dense, label, n=steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        auc, st = bq._fit_ctr(clog, dense, n)
        torch.cuda.synchronize()
        return unit(auc, f"{label} AUC"), st, time.perf_counter() - t0

    base, _, base_s = fit(torch.zeros((QUALITY["n_impr"], 1), device=dev), "baseline")
    oracle, _, oracle_s = fit(bq.oracle_features(clog, truth, dev), "oracle")
    log(f"[quality] Fig. 8 on {QUALITY['n_impr']} impressions ({n_tr} train, "
        f"{clog['label'][:n_tr].mean():.4f} clicked), {steps} steps, lr {bq.CTR_LR}, l1 "
        f"{bq.CTR_L1}: "
        f"baseline AUC {base:.6f} (fit {base_s:.3f} s); oracle (true P(k|d) × "
        f"{truth.doc_topic.shape[1]}) AUC {oracle:.6f} (fit {oracle_s:.3f} s)")
    rows = dict(baseline=base, oracle=oracle)
    for K in QUALITY["ks"]:
        big = K == max(QUALITY["ks"])
        free_card()
        spent = [0.0]
        with contextlib.ExitStack() as stack:
            if big:
                stack.enter_context(held(ops, "gibbs_argmax", timed_check(
                    gibbs_check("cuda", f"quality K={K} training"), spent), first_only=True))
            t0 = time.perf_counter()
            state, *_ = bq._train_model(K, corpus, iters=QUALITY["epochs"],
                                        block_size=QUALITY["block"], device=dev)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0 - spent[0]
        if K == QUALITY["pmi_k"]:
            t0 = time.perf_counter()
            pmi = lda.topic_pmi(state.phi, corpus.word_ids, corpus.doc_ids, corpus.n_docs,
                                top_n=5)
            log(f"[quality] Fig. 1 K={K}: mean topic PMI (top 5) {pmi.mean():.6f} over {K} "
                f"topics ({time.perf_counter() - t0:.2f} s on the host)")
            rows["pmi"] = float(pmi.mean())
        spent = [0.0]
        with contextlib.ExitStack() as stack:
            seen = stack.enter_context(held(gibbs, "fold_in", timed_check(
                fold_check(f"quality K={K}"), spent)))
            if big:
                stack.enter_context(held(ops, "gibbs_argmax", timed_check(
                    gibbs_check("cuda", f"quality K={K} fold-in"), spent), first_only=True))
            t0 = time.perf_counter()
            pkd = bq._infer_pkd(state, corpus)
            torch.cuda.synchronize()
            fold_s = time.perf_counter() - t0 - spent[0]
        if seen != [corpus.n_docs]:
            raise AssertionError(f"quality K={K}: fold-in θ not checked ({seen})")
        m = unit(bq.mean_average_precision(pkd, q, u, lab), f"K={K} MAP")
        dense = bq.topic_features(pkd, clog)
        del state, pkd
        auc, st, fit_s = fit(dense, f"K={K}")
        extra = ""
        if big:
            _, st2, _ = fit(dense, f"K={K} again")
            if not all(torch.equal(a, b) for a, b in zip(st, st2)):
                raise AssertionError(f"quality K={K}: two CTR fits from one state differ")
            n = QUALITY["cpu_steps"]
            _, st_card, _ = fit(dense, f"K={K}, {n} steps", n)
            _, st_cpu = bq._fit_ctr(clog, dense.cpu(), n)
            st_f64 = ctr_f64_steps(clog, dense.cpu(), n)
            errs = []
            for name, a, b, r in zip(st_card._fields, st_card, st_cpu, st_f64):
                e_card, e_cpu, d = (float((x.double() - y.double()).abs().max())
                                    for x, y in ((a.cpu(), r), (b, r), (a.cpu(), b)))
                if e_card > 2 * e_cpu + 1e-7:
                    raise AssertionError(f"quality K={K}: {n} CTR steps, {name}: the card is "
                                         f"{e_card:.3g} from float64, the CPU port {e_cpu:.3g}")
                errs.append(f"{name} {d:.3g} ({e_card:.3g} | {e_cpu:.3g})")
            extra = (f"; two fits bit for bit; {n} steps card vs CPU port max |Δ| (card | CPU "
                     f"from float64): " + ", ".join(errs))
        del dense, st
        bound = 2 * n_tr * K * 4 / HBM_BYTES_PER_S * 1e3
        peak = peak_gib()
        log(f"[quality] K={K}: MAP {m:.6f}, AUC {auc:.6f}; train {QUALITY['epochs']} epochs "
            f"{train_s:.3f} s, fold-in 15 sweeps {fold_s:.3f} s, CTR fit {fit_s:.3f} s = "
            f"{fit_s / steps * 1e3:.4f} ms a step (bytes bound {bound:.4f} ms), peak "
            f"{peak:.2f} GiB{extra}")
        rows[K] = dict(map=m, auc=auc, train_s=train_s, fold_s=fold_s, step_ms=fit_s / steps * 1e3,
                       bound_ms=bound, peak_gib=peak)
    return rows


def quality_guardrail(corpus):
    """The guardrail at full width: FULL's first 3,276 docs tiled 10×, dense
    and alias 25 sweeps from one z0, held-out LL on the last 820 docs (not
    gated: the measurement ROADMAP item 8 lacks). Returns the tiled corpus's
    token count."""
    from repro_torch.benchmarks import bench_quality as bq
    from repro_torch.kernels.alias import ops as alias_ops

    dev = torch.device("cuda")
    corpus_tr, corpus_te = bq.heldout_split(corpus)
    tiled = tile_corpus(corpus_tr, QUALITY["guard_tiles"])
    sweeps, block = QUALITY["guard_sweeps"], QUALITY["block"]
    log(f"[quality] guardrail corpus: {corpus_tr.n_docs} train docs tiled "
        f"{QUALITY['guard_tiles']}× = {tiled.n_docs} docs, {tiled.n_tokens} tokens; "
        f"{corpus_te.n_docs} held-out docs, {corpus_te.n_tokens} tokens")
    for K in QUALITY["guard_ks"]:
        free_card()
        t0 = time.perf_counter()
        dense, *_ = bq._train_model(K, tiled, iters=sweeps, alpha_opt_from=99,
                                    block_size=block, device=dev)
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0
        ll_d = bq._heldout_ll(dense, corpus_te)
        peak_d = peak_gib()
        del dense
        free_card()
        with contextlib.ExitStack() as stack:
            if K == max(QUALITY["guard_ks"]):
                stack.enter_context(held(alias_ops, "mh_resample",
                                         mh_check(f"guardrail alias K={K}"), first_only=True))
            t0 = time.perf_counter()
            alias = bq._train_model_alias(K, tiled, iters=sweeps, block_size=block, device=dev)
            torch.cuda.synchronize()
            alias_s = time.perf_counter() - t0
        ll_a = bq._heldout_ll(alias, corpus_te)
        peak_a = peak_gib()
        del alias
        gap = ll_a - ll_d
        log(f"[quality] guardrail K={K} ({tiled.n_tokens / K:.2f} tokens a topic), {sweeps} "
            f"sweeps in blocks of {block} from one z0: held-out LL dense {ll_d:.6f}, alias "
            f"{ll_a:.6f}, gap {gap:+.6f} ({gap / abs(ll_d):+.4%} of |dense|; not gated); dense "
            f"{dense_s:.2f} s, peak {peak_d:.2f} GiB; alias {alias_s:.2f} s (tables rebuilt "
            f"every 3 sweeps), peak {peak_a:.2f} GiB")
    free_card()
    return tiled.n_tokens


def quality_guardrail_k24():
    """JAX's own gate on the card: K = 24, tol 2%, quick mode. Its
    AssertionError fails the run."""
    from repro_torch.benchmarks import bench_quality as bq
    t0 = time.perf_counter()
    rows = dict(bq.sampler_guardrail(K=24, tol=0.02, quick=True, device="cuda"))
    log(f"[quality] guardrail K=24 (bench_quality's gate, quick, tol 2%): passed; held-out LL "
        f"dense {rows['heldout_ll_dense']:.6f}, alias {rows['heldout_ll_alias']:.6f}, gap "
        f"{rows['heldout_ll_gap']:+.6f} ({time.perf_counter() - t0:.2f} s)")
    return rows


def pipeline_sweep(corpus):
    """Table 1: the analytic model against the paper, and the package sweep
    of the dense ring of one device on FULL's shard at K = 10⁵."""
    from repro_torch.benchmarks import bench_pipeline as bp
    rows = bp.table1_model()
    err = max(abs(a - b) for _, a, b in rows)
    log(f"[table1] model vs paper (min): "
        + ", ".join(f"L={lkb} KB {a}|{b}" for lkb, a, b in rows)
        + f"; largest error {err:.4f} min")
    free_card()
    t0 = time.perf_counter()
    sweep, n_tok = bp.measured_package_sweep(corpus, n_topics=FULL["n_topics"],
                                             most=QUALITY["sweep_most"],
                                             epochs=QUALITY["sweep_epochs"], device="cuda")
    cap = sweep[-1][0]
    if len(sweep) < 4:
        raise AssertionError(f"package sweep took {len(sweep)} lengths, expected ≥ 4")
    for pkg, secs in sweep:
        log(f"[table1] package_len {pkg} ({cap // pkg} packages an epoch, cap {cap}): epoch s "
            f"{[round(s, 4) for s in secs]}, tokens/s {[round(n_tok / s, 1) for s in secs]}")
    best = min(sweep, key=lambda r: min(r[1]))[0]
    log(f"[table1] fastest package_len {best}; sweep {time.perf_counter() - t0:.2f} s "
        f"(with shard_corpus and a warm-up epoch a length), peak {peak_gib():.2f} GiB")
    return sweep


def clean_rows(K, device):
    """``run()``'s clean corpus through Fig. 7 and Fig. 8 at ``K`` on
    ``device``: [(row name, value)]."""
    from repro_torch.benchmarks import bench_quality as bq
    from repro_torch.data import synthetic
    corpus, truth = synthetic.lda_corpus(seed=0, n_docs=3000, n_topics=bq.TRUE_K,
                                         vocab_size=bq.VOCAB, doc_len_mean=10)
    return ([(f"fig7_map.K{k}", float(v)) for k, v in
             bq.fig7_map(corpus, truth, ks=(K,), device=device)]
            + [(f"fig8_auc.{n}", float(v)) for n, v in
               bq.fig8_auc(corpus, truth, ks=(K,), device=device)])


def quality_clean_check():
    """``run()``'s clean corpus (3,000 docs, 48 true topics, V = 800):
    Fig. 7 and Fig. 8 at each K of ``QUALITY["clean_ks"]`` (K = 8: the check
    on its path once, at the width ``run()`` starts from) on the card equal
    the CPU port's within 1e-4 from one z0 (the CPU rows drawn meanwhile in
    a process of their own). Every card draw is held against its plain
    version; a K row whose training drew on a near-tie may part, and is
    reported."""
    from repro_torch.kernels.gibbs import ops
    t0 = time.perf_counter()
    for K in QUALITY["clean_ks"]:
        # the CPU rows in a process of their own while the card's are drawn
        proc = subprocess.Popen([sys.executable, "-c", f"import json, chip_smoke; "
                                 f"print(json.dumps(chip_smoke.clean_rows({K}, 'cpu')))"],
                                cwd=ROOT, env=dict(src_env(), CUDA_VISIBLE_DEVICES=""),
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            with held(ops, "gibbs_argmax", gibbs_check("cuda", f"clean K={K}")) as seen:
                card = clean_rows(K, "cuda")
            out, err = proc.communicate(timeout=QUALITY["clean_timeout_s"])
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode:
            raise AssertionError(f"clean K={K}: the CPU rows' process exited {proc.returncode}:"
                                 f"\n{err[-3000:]}")
        cpu = [tuple(r) for r in json.loads(out.splitlines()[-1])]
        ties = sum(c["mismatches"] for c in seen)
        for (name, a), (name_c, b) in zip(card, cpu):
            unit(a, name)
            if name != name_c:
                raise AssertionError(f"clean K={K}: rows {name} and {name_c}")
            if abs(a - b) > 1e-4 and not (ties and name.endswith(f"K{K}")):
                raise AssertionError(f"clean K={K}: {name} card {a} vs CPU {b}")
        log(f"[quality] clean corpus K={K}, card vs CPU from one z0: "
            + ", ".join(f"{n} {a:.6f}|{b:.6f}" for (n, a), (_, b) in zip(card, cpu))
            + f"; {len(seen)} draws held, {ties} near-tie differences")
    log(f"[quality] clean-corpus check {time.perf_counter() - t0:.2f} s")


def quality_phase(corpus, truth):
    """The application layer's paths, each counted from 0."""
    paths, block = {}, QUALITY["block"]
    free_card()
    all_counts(zero=True)
    # ---- the main path: Fig. 1, 7, 8 at full width ----
    quality_full(corpus, truth)
    paths["quality_full"] = all_counts()
    # ---- end of the main path ----
    # per K: the epochs' blocks and 15 fold-in sweeps
    want = len(QUALITY["ks"]) * (QUALITY["epochs"] * -(-corpus.n_tokens // block) + 15)
    if paths["quality_full"]["gibbs_argmax"] != want:
        raise AssertionError(f"quality_full: launches {paths['quality_full']}, gibbs_argmax "
                             f"expected {want}")
    all_counts(zero=True)
    n_tiled = quality_guardrail(corpus)
    paths["quality_guardrail"] = all_counts()
    # per K: dense and alias blocks, two held-out fold-ins of 15 sweeps, and
    # a word + α table build every 3 sweeps
    n_k, sweeps, blocks = len(QUALITY["guard_ks"]), QUALITY["guard_sweeps"], -(-n_tiled // block)
    want = dict(gibbs_argmax=n_k * (sweeps * blocks + 30), mh_resample=n_k * sweeps * blocks,
                alias_build=n_k * 2 * -(-sweeps // 3), embedding_bag=0)
    if paths["quality_guardrail"] != want:
        raise AssertionError(f"quality_guardrail: launches {paths['quality_guardrail']}, "
                             f"expected {want}")
    all_counts(zero=True)
    quality_guardrail_k24()
    paths["quality_guardrail_k24"] = all_counts()
    if not all(paths["quality_guardrail_k24"][k] > 0
               for k in ("gibbs_argmax", "alias_build", "mh_resample")):
        raise AssertionError(f"quality_guardrail_k24: a kernel of the path never launched: "
                             f"{paths['quality_guardrail_k24']}")
    all_counts(zero=True)
    pipeline_sweep(corpus)
    paths["pipeline_sweep"] = all_counts()
    if paths["pipeline_sweep"]["gibbs_argmax"] == 0:
        raise AssertionError("pipeline_sweep: gibbs_argmax never launched")
    quality_clean_check()
    log(f"[quality] launches by path: {paths}")
    free_card()
    return paths


def trainer_small_phase():
    """SMALL's geometry through ``repro_torch.launch.train.main``, dense and
    alias: an uninterrupted run that publishes, a run killed after epoch 4
    (exit 17) and resumed, which must land on it bit for bit and publish the
    same model, and the same run on the CPU (the alias run must equal it bit
    for bit; the dense run's differing tokens are printed)."""
    import contextlib
    import io
    import shutil
    from repro_torch.checkpoint import snapshots
    from repro_torch.kernels.alias import ops as alias_ops
    from repro_torch.kernels.gibbs import ops as gibbs_ops
    from repro_torch.launch import train

    S = TRAINER_SMALL
    root = os.path.join(ROOT, "build", "chip_smoke_trainer")
    shutil.rmtree(root, ignore_errors=True)

    def run(sampler, device, ck, extra=()):
        argv = ["--device", device, "--sampler", sampler, "--docs", str(SMALL["n_docs"]),
                "--vocab", str(SMALL["vocab"]), "--topics", str(SMALL["n_topics"]),
                "--true-topics", str(SMALL["gen_topics"]), "--epochs", str(S["epochs"]),
                "--alpha-opt-from", "99", "--ckpt-every", str(S["ckpt_every"]),
                "--bench-out", "", "--ckpt-dir", os.path.join(root, ck), *extra]
        with contextlib.redirect_stdout(io.StringIO()):     # the runs' epoch lines
            try:
                return train.main(argv), 0
            except SystemExit as exc:
                return None, exc.code

    def counted(sampler, *a, **kw):
        gibbs_ops.launches = alias_ops.build_launches = alias_ops.mh_launches = 0
        out = run(sampler, "cuda", *a, **kw)
        torch.cuda.synchronize()
        return out, dict(gibbs_argmax=gibbs_ops.launches, alias_build=alias_ops.build_launches,
                         mh_resample=alias_ops.mh_launches)

    launches = {}
    for sampler in ("dense", "alias"):
        pub = {k: os.path.join(root, f"{sampler}-{k}-snap") for k in ("gold", "resumed")}
        n = launches[sampler] = {}
        (gold, _), n["uninterrupted"] = counted(sampler, f"{sampler}-gold",
                                                ["--publish-dir", pub["gold"]])
        (_, code), n["killed"] = counted(sampler, f"{sampler}-killed",
                                         ["--kill-at", str(S["kill_at"])])
        (res, _), n["resumed"] = counted(sampler, f"{sampler}-killed",
                                         ["--resume", "--publish-dir", pub["resumed"]])
        kernel = "gibbs_argmax" if sampler == "dense" else "mh_resample"
        want = dict(uninterrupted=S["epochs"], killed=S["kill_at"],
                    resumed=S["epochs"] - S["kill_at"])
        if code != 17 or any(n[r][kernel] != want[r] for r in want):
            raise AssertionError(f"small {sampler} loop: kill exit {code}, launches {n} "
                                 f"(want {want} {kernel} launches)")
        for i, (a, b) in enumerate(zip(gold.state, res.state)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"small {sampler} loop: the resumed run's state leaf "
                                     f"{i} differs from the uninterrupted run's")
        if not torch.equal(gold.alpha, res.alpha):
            raise AssertionError(f"small {sampler} loop: resumed α differs")
        models = {k: snapshots.load_snapshot(p, device="cuda") for k, p in pub.items()}
        for k, (m, meta) in models.items():
            if meta["epoch"] != S["epochs"] or not bool(torch.isfinite(m.pvk).all()):
                raise AssertionError(f"small {sampler} loop: {k} snapshot {meta}")
        if not (torch.equal(models["gold"][0].pvk, models["resumed"][0].pvk)
                and torch.equal(models["gold"][0].r_topic, models["resumed"][0].r_topic)):
            raise AssertionError(f"small {sampler} loop: the resumed run published another "
                                 f"model")
        cpu, _ = run(sampler, "cpu", f"{sampler}-cpu")
        diff = {name: int((a.cpu() != b).sum()) for name, a, b in
                zip(("phi", "psi", "z"), (gold.state[0], gold.state[1], gold.state[5]),
                    (cpu.state[0], cpu.state[1], cpu.state[5]))}
        if sampler == "alias" and any(diff.values()):
            raise AssertionError(f"small alias loop: card and CPU differ {diff}")
        held_note = ""
        if sampler == "dense":
            # the same run again with every package's gibbs_argmax held against
            # the plain version on the CPU, on the package's own inputs: a draw
            # that differs beyond a near-tie fails, and a card/CPU difference
            # with no differing draw is unexplained (not counted)
            with held(gibbs_ops, "gibbs_argmax", gibbs_check("cpu", "small dense loop")) \
                    as seen:
                again, _ = run(sampler, "cuda", f"{sampler}-held")
            if not all(torch.equal(a, b) for a, b in zip(gold.state, again.state)):
                raise AssertionError("small dense loop: the held run left the card's path")
            ties = sum(x["mismatches"] for x in seen)
            if any(diff.values()) and not ties:
                raise AssertionError(f"small dense loop: card and CPU differ {diff} with "
                                     f"no differing draw")
            held_note = (f"; every package ({len(seen)}) held against the plain version on "
                         f"the CPU: {ties} draws differ, all near-ties (≤ 4 ulp)")
        log(f"[trainer-small] {sampler}: K={SMALL['n_topics']} V={SMALL['vocab']} "
            f"{SMALL['n_docs']} docs, {S['epochs']} epochs through launch.train.main; killed "
            f"after epoch {S['kill_at']} (exit 17) and resumed: state and α equal the "
            f"uninterrupted run's bit for bit, both published v_{models['gold'][1]['version']:06d} "
            f"models load and are equal; card vs CPU entries that differ {diff}{held_note}; "
            f"launches {n}")
    shutil.rmtree(root, ignore_errors=True)
    return launches


# ------------------------------------------------------------- stream phase
# the streamed cell: the alias cell's corpus (FULL's shard tiled 40×: 163,840
# docs, 747,200 tokens) written by save_segments as 10 segments on disk and
# trained from the mmap'd directory by the Trainer at K = 100,000: Θ is
# rebuilt per segment (6.6 GB at 16,384 docs), so the dense ring fits one
# card. Dense: packages of at most 10,000 tokens, 3 epochs with α re-estimated
# from the second (index 1); then one epoch each with prefetch on and off from
# one start. Alias: 6 epochs, tables rebuilt every 3, α held. Then both
# samplers 4 epochs from one z0 with α held (LL curves; 8 until the streamed
# ring's phases joined the script)
STREAM = dict(tiles=40, segments=10, max_package=10_000, epochs=3, alpha_from=1,
              alias_epochs=6, agg_every=3, n_mh=4, ll_epochs=4)
# the small streamed launch.train loop: SMALL's geometry in 3 segments, a
# checkpoint at every segment boundary, killed after segment 1 of epoch 2
STREAM_SMALL = dict(segments=3, epochs=4, kill_at=2, kill_at_segment=1)


def check_stream_state(tr, label):
    """Φ and Ψ of a streamed session equal the counts of its global z store
    over the source's segments, and Ψ sums to the token count."""
    import dataclasses
    from repro_torch.core import distributed as dist
    phi = psi = None
    for g in range(tr.source.n_segments):
        sc = tr.source.segment(g)
        sc = dataclasses.replace(sc, z0=tr._z[np.asarray(sc.uid)])
        phi, psi = dist.device_counts(sc, tr.config.n_topics, tr.device, phi, psi)
    same = torch.equal(phi, tr.state[0]) and torch.equal(psi, tr.state[1])
    del phi, psi
    if not same or int(tr.state[1].sum()) != tr.source.n_tokens:
        raise AssertionError(f"{label}: Φ/Ψ are not the counts of the global z store")


def stream_stats(tr, n_seg, label, first=0):
    """Per-epoch lines of a streamed Trainer from epoch ``first`` on: tokens/s
    from the sampler's time (``epoch_s``) and from the stream's time (the
    consumer's LoadShard wait + sampler + SaveShard a segment), segment
    seconds, and the stream's host times."""
    T, m = tr.source.n_tokens, tr.metrics
    rows = []
    for e, ep_s in enumerate(m["epoch_s"][first:], start=first):
        sl = slice(e * n_seg, (e + 1) * n_seg)
        seg_s, wait, load, save = (np.array(m[k][sl]) for k in
                                   ("segment_s", "load_wait_s", "load_shard_s", "save_shard_s"))
        stream_s = float(seg_s.sum() + wait.sum() + save.sum())
        rows.append(dict(tokens_per_s=T / ep_s, stream_tokens_per_s=T / stream_s,
                         segment_s_mean=float(seg_s.mean()), segment_s_min=float(seg_s.min()),
                         segment_s_max=float(seg_s.max()), load_shard_s=float(load.mean()),
                         load_wait_s=float(wait.mean()), load_wait_first_s=float(wait[0]),
                         load_wait_rest_s=float(wait[1:].mean()) if n_seg > 1 else 0.0,
                         save_shard_s=float(save.mean())))
        r = rows[-1]
        if e < len(m["peak_gib"]):
            r["peak_gib"] = m["peak_gib"][e]
        log(f"[stream] {label} epoch {e}: {r['tokens_per_s']:.1f} tokens/s (epoch_s "
            f"{ep_s:.4f}), {r['stream_tokens_per_s']:.1f} tokens/s over the stream's time "
            f"({stream_s:.4f} s); segment_s mean {r['segment_s_mean']:.4f} (min "
            f"{r['segment_s_min']:.4f}, max {r['segment_s_max']:.4f}); host LoadShard "
            f"{r['load_shard_s'] * 1e3:.2f} ms a segment, the consumer's wait for it "
            f"{r['load_wait_s'] * 1e3:.2f} ms (first segment {r['load_wait_first_s'] * 1e3:.2f}, "
            f"the rest {r['load_wait_rest_s'] * 1e3:.2f}), SaveShard "
            f"{r['save_shard_s'] * 1e3:.2f} ms"
            + (f"; max_memory_allocated {r['peak_gib']:.2f} GiB in the epoch (its segments, "
               f"Ω folds and epoch-end callbacks)" if "peak_gib" in r else ""))
    return rows


def epoch_peak():
    """A ``Trainer`` callback (put it last): this process's peak device
    memory in each epoch (its segments, Ω folds and the callbacks before
    it) into ``metrics["peak_gib"]``, then a reset for the next epoch."""
    from repro_torch.training import TrainerCallback

    class EpochPeak(TrainerCallback):
        def on_epoch_end(self, trainer, epoch):
            trainer.metrics["peak_gib"].append(torch.cuda.max_memory_allocated() / 2**30)
            torch.cuda.reset_peak_memory_stats()

    return EpochPeak()


def stream_phase(base):
    """The streamed cell through the port's Trainer from a save_segments
    directory (DiskSource, mmap'd), at K = 100,000, V = 32,768."""
    import shutil
    from repro_torch.core import distributed as dist
    from repro_torch.data import sources
    from repro_torch.data.stream import SegmentStream
    from repro_torch.kernels.alias import ops as alias_ops
    from repro_torch.kernels.gibbs import ops
    from repro_torch.training import (AlphaOptimizer, Metrics, Trainer, TrainerCallback,
                                      TrainerConfig)

    K, V, S = FULL["n_topics"], FULL["vocab"], STREAM
    root = os.path.join(ROOT, "build", "chip_smoke_stream")
    shutil.rmtree(root, ignore_errors=True)
    corpus = tile_corpus(base, S["tiles"])
    t0 = time.perf_counter()
    sources.save_segments(sources.InMemorySource(corpus, S["segments"], 1, 1, K, seed=1), root)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    disk = sources.open_segments(root)
    T, n_seg, cap = disk.n_tokens, disk.n_segments, disk.cap
    L = package_len_for(cap, S["max_package"])
    n_pkg = cap // L
    log(f"[stream] corpus: FULL's shard tiled {S['tiles']}×: {disk.n_docs} docs, {T} tokens "
        f"(the paper's 10⁹ queries cut to 1.6·10⁵); save_segments wrote {n_seg} segments, "
        f"{nbytes} bytes on disk in {save_s:.2f} s (segment_corpus and the writes, on the "
        f"host); cap {cap}, {disk.docs_per_shard} docs a segment, package_len {L} "
        f"({n_pkg} packages a segment)")
    del corpus
    say = lambda msg: log(f"[stream] {msg}")

    def trainer(sampler, n_epochs, callbacks=(), **kw):
        cfg = TrainerConfig(n_topics=K, vocab_size=V, corpus_dir=root, sampler=sampler,
                            n_epochs=n_epochs, package_len=L if sampler == "dense" else 0,
                            agg_every=S["agg_every"], n_mh=S["n_mh"], device="cuda", **kw)
        tr = Trainer(cfg, callbacks=list(callbacks))
        tr.log = lambda m: None
        return tr

    def release(*trainers):
        for t in trainers:
            t.state = t._tables = None
        gc.collect()
        torch.cuda.empty_cache()

    # ---- the main path: counts from 0, the dense Trainer's fit ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = trainer("dense", S["epochs"], [AlphaOptimizer(), Metrics(printer=say), epoch_peak()],
                 alpha_opt_from=S["alpha_from"])
    t0 = time.perf_counter()
    ops.launches = 0
    tr.fit()
    torch.cuda.synchronize()
    launches = ops.launches
    fit_s = time.perf_counter() - t0
    # ---- end of the main path ----
    peak = max(tr.metrics["peak_gib"])
    expected = S["epochs"] * n_seg * n_pkg
    if launches != expected:
        raise AssertionError(f"streamed Trainer: gibbs_argmax launched {launches} times, "
                             f"expected {expected}")
    lls = tr.metrics["ll"]
    if not all(np.isfinite(lls)) or not lls[-1] > lls[0]:
        raise AssertionError(f"streamed Trainer did not raise the word LL: {lls}")
    check_stream_state(tr, "streamed Trainer")
    if not bool(torch.isfinite(tr.alpha).all() & (tr.alpha > 0).all()) \
            or abs(float(tr.alpha.sum()) - 50.0) < 1e-3:
        raise AssertionError("streamed AlphaOptimizer left α non-finite, non-positive or "
                             "unmoved")
    dense_rows = stream_stats(tr, n_seg, "dense")
    log(f"[stream] dense Trainer from the directory, {S['epochs']} epochs: launches "
        f"gibbs_argmax={launches} (expected {expected}); word LL "
        f"{[f'{x:.6e}' for x in lls]}; α sum {float(tr.alpha.sum()):.4f} (was 50.0); "
        f"fit {fit_s:.2f} s (setup's pass over the segments, epochs, Ω folds, LL, α); "
        f"max_memory_allocated={peak:.2f} GiB over the session, the largest epoch's (card: "
        f"{card_line()})")

    # ---- one more epoch through fit, profiled (no callbacks; the Ω fold stays,
    # as the session's α re-estimation asks for it) ----
    tr.callbacks, n_before = [], len(tr.metrics["epoch_s"])
    tr.config = tr.config.replace(n_epochs=S["epochs"] + 1)
    device_breakdown("streamed dense epoch", tr.fit, top=10)
    prof = stream_stats(tr, n_seg, "dense, profiled", first=n_before)
    # ---- gibbs_argmax on the first package of a segment, held against its
    # plain version on the card (not counted; it moves the session's counts,
    # so it comes last) ----
    seg = next(iter(SegmentStream(disk, tr._z.copy(), prefetch=False,
                                  device=tr.device).epoch(0)))
    with held(ops, "gibbs_argmax", gibbs_check("cuda", "streamed dense"), first_only=True) \
            as seen:
        tr._epoch_fn(*tr.state, seg.wl, seg.dl, seg.uid, seg.z, tr.alpha, tr.beta, 4000)
    torch.cuda.synchronize()
    del seg
    log(f"[stream] first package of a segment: gibbs_argmax against its plain version on "
        f"the card: {seen[0]}; differing draws are near-ties (≤ 4 ulp)")
    release(tr)
    del tr

    # ---- prefetch on and off, one epoch each from one start: Φ, ψ, z equal ----
    runs = {}
    for prefetch in (True, False):
        t = trainer("dense", 1, prefetch=prefetch, alpha_opt_from=99)
        t.fit()
        torch.cuda.synchronize()
        runs[prefetch] = t
        stream_stats(t, n_seg, f"dense, prefetch {'on' if prefetch else 'off'}")
    on, off = runs[True], runs[False]
    same = dict(phi=torch.equal(on.state[0], off.state[0]),
                psi=torch.equal(on.state[1], off.state[1]), z=bool((on._z == off._z).all()))
    if not all(same.values()):
        raise AssertionError(f"prefetch on and off differ: equal {same}")
    prefetch_s = {p: float(sum(t.metrics['segment_s']) + sum(t.metrics['load_wait_s'])
                           + sum(t.metrics['save_shard_s'])) for p, t in runs.items()}
    log(f"[stream] one epoch with prefetch on and one with it off, from one start: Φ, ψ and "
        f"the global z store equal bit for bit; the stream's time {prefetch_s[True]:.4f} s "
        f"(on) vs {prefetch_s[False]:.4f} s (off)")
    release(on, off)
    del on, off, runs

    # ---- the alias Trainer from the same directory ----
    torch.cuda.reset_peak_memory_stats()
    ta = trainer("alias", S["alias_epochs"], [Metrics(printer=say), epoch_peak()],
                 alpha_opt_from=99)
    alias_ops.build_launches = alias_ops.mh_launches = 0
    t0 = time.perf_counter()
    ta.fit()
    torch.cuda.synchronize()
    alias_fit_s = time.perf_counter() - t0
    alias_launches = dict(alias_build=alias_ops.build_launches,
                          mh_resample=alias_ops.mh_launches)
    alias_peak = max(ta.metrics["peak_gib"])
    if alias_launches["mh_resample"] != S["alias_epochs"] * n_seg \
            or alias_launches["alias_build"] < 4:
        raise AssertionError(f"streamed alias Trainer: launches {alias_launches} (want "
                             f"{S['alias_epochs'] * n_seg} mh_resample, two table builds)")
    check_stream_state(ta, "streamed alias Trainer")
    alias_rows = stream_stats(ta, n_seg, "alias")
    window = T * S["alias_epochs"] / alias_fit_s
    log(f"[stream] alias Trainer from the directory, {S['alias_epochs']} epochs (tables "
        f"rebuilt every {S['agg_every']}), α held: launches {alias_launches}; word LL "
        f"{[f'{x:.6e}' for x in ta.metrics['ll']]}; fit {alias_fit_s:.2f} s = {window:.1f} "
        f"tokens/s over the whole fit (setup pass, table builds, LL); "
        f"max_memory_allocated={alias_peak:.2f} GiB")
    # ---- one more alias epoch through fit, profiled (no callbacks); the epoch
    # before it rebuilds the tables (epoch 6), so the profiled one does not ----
    ta.callbacks = []
    ta.config = ta.config.replace(n_epochs=S["alias_epochs"] + 1)
    ta.fit()
    n_before = len(ta.metrics["epoch_s"])
    ta.config = ta.config.replace(n_epochs=S["alias_epochs"] + 2)
    device_breakdown("streamed alias epoch", ta.fit, top=10)
    alias_prof = stream_stats(ta, n_seg, "alias, profiled", first=n_before)
    # ---- mh_resample on the first package of a segment, held against its plain
    # version on the card bit for bit (not counted; it moves the counts, so last) ----
    seg = next(iter(SegmentStream(disk, ta._z.copy(), prefetch=False,
                                  device=ta.device).epoch(0)))
    with held(alias_ops, "mh_resample", mh_check("streamed alias"), first_only=True) as seen:
        ta._epoch_fn(*ta.state, seg.wl, seg.dl, seg.uid, seg.z, ta.alpha, ta.beta, 4000,
                     *ta._epoch_tables())
    torch.cuda.synchronize()
    del seg
    log(f"[stream] first package of a segment: mh_resample against its plain version on the "
        f"card: {seen[0]}")
    release(ta)
    del ta

    # ---- the dense and the alias sampler from one z0, α held: LL per epoch and
    # the share of tokens whose topic changed in each epoch ----
    class Moved(TrainerCallback):
        def on_train_start(self, trainer):
            self.z, self.shares = None, []

        def on_epoch_end(self, trainer, epoch):
            if self.z is None:
                self.z = self.z0
            self.shares.append(float((trainer._z != self.z).mean()))
            self.z = trainer._z.copy()

    curves, moved, ll_launches = {}, {}, {}
    for sampler in ("dense", "alias"):
        mv = Moved()
        t = trainer(sampler, S["ll_epochs"], [Metrics(printer=lambda m: None), mv],
                    alpha_opt_from=99)
        t.setup()
        t._materialize_stream_state()
        mv.z0 = t._z.copy()
        ll_z0 = t.log_likelihood()
        ops.launches = alias_ops.build_launches = alias_ops.mh_launches = 0
        t.fit()
        torch.cuda.synchronize()
        n = dict(gibbs_argmax=ops.launches, alias_build=alias_ops.build_launches,
                 mh_resample=alias_ops.mh_launches)
        want = dict(dense=("gibbs_argmax", S["ll_epochs"] * n_seg * n_pkg),
                    alias=("mh_resample", S["ll_epochs"] * n_seg))[sampler]
        if n[want[0]] != want[1]:
            raise AssertionError(f"streamed {sampler} LL run: launches {n}, want {want}")
        check_stream_state(t, f"streamed {sampler} LL run")
        curves[sampler], moved[sampler], ll_launches[sampler] = \
            [ll_z0] + t.metrics["ll"], mv.shares, n
        log(f"[stream-ll] {sampler}: {S['ll_epochs']} epochs from the shared z0, α held at "
            f"50/K; launches {n}; epoch_s {[round(x, 4) for x in t.metrics['epoch_s']]}; "
            f"share of tokens that changed topic per epoch {[round(x, 6) for x in mv.shares]}")
        release(t)
        del t
    if curves["dense"][0] != curves["alias"][0]:
        raise AssertionError("the two streamed samplers did not start from one z0")
    log("[stream-ll] word LL after each epoch (epoch 0 = z0): " + "; ".join(
        f"{e}: dense {d:.6e} alias {a:.6e}"
        for e, (d, a) in enumerate(zip(curves["dense"], curves["alias"]))))
    shutil.rmtree(root, ignore_errors=True)
    return dict(gibbs=launches, alias=alias_launches, ll=ll_launches, dense=dense_rows,
                alias_rows=alias_rows, profiled=prof, alias_profiled=alias_prof,
                peak_gib=peak, alias_peak_gib=alias_peak)


def stream_small_phase():
    """SMALL's geometry streamed through ``repro_torch.launch.train.main`` in
    3 segments, dense and alias: an uninterrupted run; a run with a
    checkpoint at every segment boundary killed after segment 1 of epoch 2
    (exit 17) and resumed; the same corpus from a ``--corpus-dir``, once
    under a fault plane that fails the first ``disk.segment_read`` (retried);
    the same run on the CPU. All must equal the uninterrupted run bit for
    bit (a dense card/CPU difference must be a near-tie of a held draw)."""
    import contextlib
    import io
    import shutil
    from repro_torch.data import sources
    from repro_torch.kernels.alias import ops as alias_ops
    from repro_torch.kernels.gibbs import ops as gibbs_ops
    from repro_torch.launch import train
    from repro_torch.reliability import faults

    S = STREAM_SMALL
    root = os.path.join(ROOT, "build", "chip_smoke_stream_small")
    shutil.rmtree(root, ignore_errors=True)

    def run(sampler, device, ck, extra=()):
        argv = ["--device", device, "--sampler", sampler, "--docs", str(SMALL["n_docs"]),
                "--vocab", str(SMALL["vocab"]), "--topics", str(SMALL["n_topics"]),
                "--true-topics", str(SMALL["gen_topics"]), "--epochs", str(S["epochs"]),
                "--alpha-opt-from", "99", "--ckpt-every", "2", "--bench-out", "",
                "--ckpt-dir", os.path.join(root, ck), *extra]
        with contextlib.redirect_stdout(io.StringIO()):
            try:
                return train.main(argv), 0
            except SystemExit as exc:
                return None, exc.code

    def counted(sampler, *a, **kw):
        gibbs_ops.launches = alias_ops.build_launches = alias_ops.mh_launches = 0
        out = run(sampler, "cuda", *a, **kw)
        torch.cuda.synchronize()
        return out, dict(gibbs_argmax=gibbs_ops.launches, alias_build=alias_ops.build_launches,
                         mh_resample=alias_ops.mh_launches)

    def differ(a, b):
        return {name: int((x.cpu() != y.cpu()).sum()) for name, x, y in
                (("phi", a.state[0], b.state[0]), ("psi", a.state[1], b.state[1]),
                 ("alpha", a.alpha, b.alpha))} | {"z": int((a._z != b._z).sum())}

    seg_flags = ["--n-segments", str(S["segments"])]
    launches = {}
    for sampler in ("dense", "alias"):
        n = launches[sampler] = {}
        (gold, _), n["uninterrupted"] = counted(sampler, f"{sampler}-gold", seg_flags)
        (_, code), n["killed"] = counted(sampler, f"{sampler}-killed", seg_flags + [
            "--ckpt-segments", "1", "--kill-at", str(S["kill_at"]),
            "--kill-at-segment", str(S["kill_at_segment"])])
        (res, _), n["resumed"] = counted(sampler, f"{sampler}-killed", seg_flags + ["--resume"])
        d = os.path.join(root, f"{sampler}-segments")
        sources.save_segments(gold.source, d)
        (from_dir, _), n["corpus_dir"] = counted(sampler, f"{sampler}-dir", ["--corpus-dir", d])
        plane = faults.FaultPlane().fail("disk.segment_read", key="0", nth=1)
        with faults.injected(plane):
            (faulted, _), n["fault"] = counted(sampler, f"{sampler}-fault",
                                               ["--corpus-dir", d])
        kernel = "gibbs_argmax" if sampler == "dense" else "mh_resample"
        n_seg = S["segments"]
        done = (S["kill_at"] - 1) * n_seg + S["kill_at_segment"]
        want = dict(uninterrupted=S["epochs"] * n_seg, killed=done,
                    resumed=S["epochs"] * n_seg - done, corpus_dir=S["epochs"] * n_seg,
                    fault=S["epochs"] * n_seg)
        if code != 17 or any(n[r][kernel] != want[r] for r in want) \
                or (sampler == "alias" and n["uninterrupted"]["alias_build"] == 0):
            raise AssertionError(f"small streamed {sampler} loop: kill exit {code}, launches "
                                 f"{n} (want {want} {kernel} launches)")
        if plane.injected("disk.segment_read") != 1:
            raise AssertionError(f"small streamed {sampler} loop: the fault plane fired "
                                 f"{plane.injected('disk.segment_read')} times, not once")
        for name, other in (("resumed", res), ("corpus_dir", from_dir), ("fault", faulted)):
            diff = differ(gold, other)
            if any(diff.values()):
                raise AssertionError(f"small streamed {sampler} loop: the {name} run differs "
                                     f"from the uninterrupted one {diff}")
        cpu, _ = run(sampler, "cpu", f"{sampler}-cpu", seg_flags)
        diff = differ(gold, cpu)
        held_note = ""
        if sampler == "alias" and any(diff.values()):
            raise AssertionError(f"small streamed alias loop: card and CPU differ {diff}")
        if sampler == "dense":
            with held(gibbs_ops, "gibbs_argmax", gibbs_check("cpu", "small streamed dense")) \
                    as seen:
                again, _ = run(sampler, "cuda", f"{sampler}-held", seg_flags)
            if any(differ(gold, again).values()):
                raise AssertionError("small streamed dense loop: the held run left the "
                                     "card's path")
            ties = sum(x["mismatches"] for x in seen)
            if any(diff.values()) and not ties:
                raise AssertionError(f"small streamed dense loop: card and CPU differ {diff} "
                                     f"with no differing draw")
            held_note = (f"; every package ({len(seen)}) held against the plain version on "
                         f"the CPU: {ties} draws differ, all near-ties (≤ 4 ulp)")
        log(f"[stream-small] {sampler}: K={SMALL['n_topics']} V={SMALL['vocab']} "
            f"{SMALL['n_docs']} docs in {n_seg} segments, {S['epochs']} epochs through "
            f"launch.train.main; killed after segment {S['kill_at_segment']} of epoch "
            f"{S['kill_at']} (exit 17) and resumed, the --corpus-dir run, and the run whose "
            f"first disk.segment_read failed (retried): Φ, ψ, α and z equal the uninterrupted "
            f"run's bit for bit; card vs CPU entries that differ {diff}{held_note}; "
            f"launches {n}")
    shutil.rmtree(root, ignore_errors=True)
    return launches


# ------------------------------------------------------- embedding_bag kernel
BAG_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def check_bag(table, ids, w, combiner, label):
    """embedding_bag kernel against its plain version on the card; returns the
    largest |kernel − plain|. A bag of one row with weight 1 must be equal bit
    for bit; otherwise within 1e-5 (f32) or 2e-2 (bf16), the JAX kernel
    test's limits. The bf16 plain version rounds the weights to bf16 and the
    kernel keeps them in f32, so weighted bf16 bags are held (a) against the
    plain version with weights that are bf16 values, within 2e-2, and (b)
    with the raw weights against the plain version in f32 on the same row
    values, within the kernel's one rounding to bf16 (2⁻⁸ relative) + 1e-5."""
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_padded_ref
    bf16 = table.dtype == torch.bfloat16
    w_plain = w.to(torch.bfloat16).float() if (w is not None and bf16) else w
    out = embedding_bag_cuda(table, ids, w_plain, combiner)
    plain = embedding_bag_padded_ref(table, ids, w_plain, combiner)
    err = float((out.float() - plain.float()).abs().max()) if out.numel() else 0.0
    if ids.shape[1] == 1 and w is None:
        if not torch.equal(out, plain):
            raise AssertionError(f"embedding_bag {label}: a bag of one is not the row "
                                 f"bit for bit ({int((out != plain).sum())} entries)")
    else:
        tol = BAG_TOL[table.dtype]
        if not torch.allclose(out.float(), plain.float(), rtol=tol, atol=tol):
            raise AssertionError(f"embedding_bag {label}: |kernel − plain| {err} beyond "
                                 f"rtol = atol = {tol}")
    if w is not None and bf16:
        B, F = ids.shape
        rows = table[ids.reshape(-1).long()].float()            # the row values, in f32
        local = torch.arange(B * F, device=ids.device, dtype=torch.int32).reshape(B, F)
        exact = embedding_bag_padded_ref(rows, local, w, combiner)
        out = embedding_bag_cuda(table, ids, w, combiner).float()
        if not torch.allclose(out, exact, rtol=2 ** -8 + 1e-5, atol=1e-5):
            raise AssertionError(f"embedding_bag {label}: raw weights off the f32 sum by "
                                 f"{float((out - exact).abs().max())}")
    return err


def bag_kernel_phase():
    """embedding_bag at random shapes (D the model's and the tests' widths,
    F 1 / 3 / 26, f32 and bf16, sum and mean, weights and none, zero-weight
    padding) against its plain version; the full-width DLRM gather is checked
    in ``recsys_phase``, on the model's own table."""
    g = torch.Generator(device="cuda").manual_seed(13)
    errs, n = [], 0
    for D in (8, 10, 16, 18, 128, 512):
        for F in (1, 3, 26):
            for dtype in (torch.float32, torch.bfloat16):
                B = int(torch.randint(1, 300, (1,), generator=g, device="cuda"))
                V = int(torch.randint(50, 100_000, (1,), generator=g, device="cuda"))
                table = torch.randn((V, D), generator=g, device="cuda").to(dtype)
                ids = torch.randint(0, V, (B, F), generator=g, device="cuda",
                                    dtype=torch.int32)
                w = torch.rand((B, F), generator=g, device="cuda") * 1.9 + 0.1
                w[::2, -1] = 0.0                                   # zero-weight padding
                w[torch.rand((B, F), generator=g, device="cuda") < 0.1] = 0.0
                for combiner in ("sum", "mean"):
                    for weights in (None, w):
                        errs.append(check_bag(table, ids, weights, combiner,
                                              f"B={B} F={F} V={V} D={D} {dtype} {combiner} "
                                              f"{'weighted' if weights is not None else 'ones'}"))
                        n += 1
    log(f"[bag-kernel] {n} random cases (D 8…512, F 1/3/26, f32/bf16, sum/mean, weights "
        f"and none): bags of one bit for bit, the rest within the limits; max |kernel − "
        f"plain| {max(errs):.6g}")
    return max(errs)


def bag_full_width(table, spec, ids):
    """The kernel at the DLRM serving shape on the full table: the bulk
    batch's 262,144 × 26 ids as bags of one (``lookup``) and as one weighted
    bag per row (``multi_hot_lookup``), checked and timed beside the plain
    version and PyTorch's own call (a yardstick, never on the path)."""
    import torch.nn.functional as nnf
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_padded_ref
    from repro_torch.models.recsys import _flat_ids

    flat = _flat_ids(spec, ids)                                # [B, F] global rows
    B, F = flat.shape
    D = table.shape[1]
    one = flat.reshape(-1, 1)
    g = torch.Generator(device="cuda").manual_seed(17)
    w = torch.rand((B, F), generator=g, device="cuda")
    e1 = check_bag(table, one, None, "sum", f"full width, {B * F} bags of one, V={table.shape[0]}")
    e2 = check_bag(table, flat, w, "sum", f"full width, {B} bags of {F}, weighted")
    e3 = check_bag(table, flat, None, "sum", f"full width, {B} bags of {F}, ones")
    esz = table.element_size()
    row = D * esz
    distinct = int(torch.unique(flat).numel())          # the table rows the gather reads
    res = {}
    w_lib = w.to(table.dtype)                  # PyTorch's call takes the table's dtype
    # bytes: each distinct row read once, each output row written once, the
    # ids (and weights) read once; beside it the count that charges every
    # gathered row
    cases = (("lookup", one, None, lambda: nnf.embedding(one[:, 0], table),
              B * F * row + B * F * 4),
             ("multi_hot", flat, w,
              lambda: nnf.embedding_bag(flat, table, mode="sum", per_sample_weights=w_lib),
              B * row + 2 * B * F * 4))
    for label, i, ww, library, rest in cases:
        ms = timed_ms(lambda: embedding_bag_cuda(table, i, ww), reps=20)
        plain_ms = timed_ms(lambda: embedding_bag_padded_ref(table, i, ww), reps=5, warmup=1)
        library_ms = timed_ms(library, reps=20)
        bound_ms, bound_by = bound(distinct * row + rest, 2 * B * F * D)
        per_row_ms, _ = bound(B * F * row + rest, 2 * B * F * D)
        log(f"[bag-kernel] full width {label} ({B} × {F} ids, D={D}, {table.dtype}): "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}, {distinct} distinct rows read once) "
            f"share_of_bound={bound_ms / ms:.4f}; charging every gathered row: "
            f"{per_row_ms:.4f} ms, share {per_row_ms / ms:.4f}")
        res[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          bound_ms_per_gathered_row=per_row_ms)
    # the same gather with its ids folded into the table's first GiB: if it
    # reaches the bound and the real one does not, the page walks over the
    # 44.77 GiB table set the pace, not the kernel
    fold_rows = (1 << 30) // (D * esz)
    folded = (one % fold_rows).contiguous()
    e1 = max(e1, check_bag(table, folded, None, "sum", "ids folded into the first GiB"))
    fold_ms = timed_ms(lambda: embedding_bag_cuda(table, folded), reps=20)
    lk = res["lookup"]
    lk["folded_1gib_ms"] = fold_ms
    fold_bound, _ = bound(int(torch.unique(folded).numel()) * row + B * F * (row + 4),
                          2 * B * F * D)
    log(f"[bag-kernel] full width lookup, ids folded into the first GiB ({fold_rows} rows): "
        f"kernel_ms={fold_ms:.4f} bound_ms={fold_bound:.4f} "
        f"share_of_bound={fold_bound / fold_ms:.4f}; the real gather {lk['ms']:.4f} ms, "
        f"share {lk['bound_ms'] / lk['ms']:.4f}")
    del folded
    # the serve_p99 batch's gather: 512 × 26 bags of one, most of the path's launches
    small = one[:RECSYS["p99_batch"] * F].contiguous()
    ms = timed_ms(lambda: embedding_bag_cuda(table, small), reps=50)
    bound_ms, bound_by = bound(int(torch.unique(small).numel()) * row
                               + small.numel() * (row + 4), 2 * small.numel() * D)
    log(f"[bag-kernel] serve_p99 lookup ({RECSYS['p99_batch']} × {F} ids): kernel_ms={ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    return max(e1, e2, e3), res


# ------------------------------------------------------------ recsys phase
def recsys_inputs(arch, cfg, B, g):
    """Seeded serving inputs of ``arch`` on the card: ids uniform per field
    in [0, vocab_f), dense features N(0, 1); DIN histories -1-padded."""
    def field_ids(sizes):
        u = torch.rand((B, len(sizes)), generator=g, device="cuda", dtype=torch.float64)
        v = torch.tensor(sizes, dtype=torch.float64, device="cuda")
        return (u * v).floor().to(torch.int32)
    if arch == "din":
        S = cfg.seq_len
        hist = torch.randint(0, cfg.n_items, (B, S), generator=g, device="cuda",
                             dtype=torch.int32)
        length = torch.randint(1, S + 1, (B, 1), generator=g, device="cuda")
        hist[torch.arange(S, device="cuda")[None, :] >= length] = -1
        return (torch.randint(0, cfg.n_items, (B,), generator=g, device="cuda",
                              dtype=torch.int32), hist,
                torch.randint(0, cfg.context_vocab, (B, cfg.n_context), generator=g,
                              device="cuda", dtype=torch.int32))
    ids = field_ids(cfg.embedding.vocab_sizes)
    if arch == "dlrm-mlperf":
        return torch.randn((B, cfg.n_dense), generator=g, device="cuda"), ids
    return (ids,)


def serve_check(out, B, label):
    if out.shape != (B,) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: output of shape {tuple(out.shape)}, or not finite")


def recsys_phase():
    """dlrm-mlperf at full width (the 187,767,552 × 128 bf16 table, nothing
    cut) serving serve_p99 and serve_bulk batches; xdeepfm, din and autoint
    at full width one serve_p99 batch each; retrieval_scores at
    retrieval_cand. Returns dlrm-mlperf's parameters for
    ``recsys_train_phase``."""
    from repro_torch.configs import recsys_archs as ra
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.models import recsys as rec

    R = RECSYS
    torch.cuda.reset_peak_memory_stats()
    cfg = ra.DLRM
    t0 = time.perf_counter()
    params = rec.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
                             torch.bfloat16)
    torch.cuda.synchronize()
    table = params["table"]
    log(f"[recsys] dlrm-mlperf params: table {tuple(table.shape)} {table.dtype} "
        f"({table.numel() * table.element_size() / 1e9:.2f} GB), drawn in "
        f"{time.perf_counter() - t0:.2f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    g = torch.Generator(device="cuda").manual_seed(R["seed"])
    p99_in = [recsys_inputs("dlrm-mlperf", cfg, R["p99_batch"], g)
              for _ in range(R["p99_warmup"] + R["p99_batches"])]
    bulk_in = [recsys_inputs("dlrm-mlperf", cfg, R["bulk_batch"], g)
               for _ in range(1 + R["bulk_batches"])]
    bag_err, bag = bag_full_width(table, cfg.embedding, bulk_in[0][1])
    torch.cuda.empty_cache()

    others = {}
    for arch, ocfg in (("xdeepfm", ra.XDEEPFM), ("din", ra.DIN), ("autoint", ra.AUTOINT)):
        op = rec.init_params(ocfg, torch.Generator(device="cuda").manual_seed(1), "cuda",
                             torch.bfloat16)
        others[arch] = (ocfg, op, [recsys_inputs(arch, ocfg, R["p99_batch"], g)
                                   for _ in range(2)])
    cand = torch.randn((R["n_candidates"], cfg.embedding.dim), generator=g, device="cuda")
    query = torch.randn((1, cfg.embedding.dim), generator=g, device="cuda")
    forwards = {"xdeepfm": rec.xdeepfm_forward, "din": rec.din_forward,
                "autoint": rec.autoint_forward}
    torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts from 0, serve p99 → serve bulk → other archs → retrieval ----
    ops.launches = 0
    p99 = []
    for i, (dense, sparse) in enumerate(p99_in):
        t0 = time.perf_counter()
        out = rec.dlrm_forward(cfg, params, dense, sparse)
        torch.cuda.synchronize()
        if i >= R["p99_warmup"]:
            p99.append((time.perf_counter() - t0) * 1e3)
        serve_check(out, R["p99_batch"], "dlrm serve_p99")
    bulk = []
    for i, (dense, sparse) in enumerate(bulk_in):
        t0 = time.perf_counter()
        out = rec.dlrm_forward(cfg, params, dense, sparse)
        torch.cuda.synchronize()
        if i:
            bulk.append(time.perf_counter() - t0)
        serve_check(out, R["bulk_batch"], "dlrm serve_bulk")
    del out
    other_ms = {}
    for arch, (ocfg, op, batches) in others.items():
        for i, args in enumerate(batches):              # a warm-up batch, then the timed one
            t0 = time.perf_counter()
            out = forwards[arch](ocfg, op, *args)
            torch.cuda.synchronize()
            other_ms[arch] = (time.perf_counter() - t0) * 1e3
            serve_check(out, R["p99_batch"], f"{arch} serve_p99")
    t0 = time.perf_counter()
    top_s, top_i = rec.retrieval_scores(query, cand, top_k=100)
    torch.cuda.synchronize()
    retrieval_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launches
    # ---- end of the main path ----

    peak = torch.cuda.max_memory_allocated() / 2**30
    n_forward = len(p99_in) + len(bulk_in) + 2 * 2        # xdeepfm, autoint; din has no bag
    if launches != n_forward:
        raise AssertionError(f"embedding_bag launched {launches} times, expected {n_forward}")
    p50, p99v = np.percentile(p99, 50), np.percentile(p99, 99)
    bulk_rate = R["bulk_batch"] * len(bulk) / sum(bulk)
    log(f"[recsys] dlrm-mlperf serve_p99: {len(p99)} batches of {R['p99_batch']} after "
        f"{R['p99_warmup']} warm-up: p50 {p50:.4f} ms, p99 {p99v:.4f} ms, max {max(p99):.4f} ms "
        f"per batch (host clock + synchronize)")
    log(f"[recsys] dlrm-mlperf serve_bulk: {len(bulk)} batches of {R['bulk_batch']}: s "
        f"{[round(t, 5) for t in bulk]}; {bulk_rate:.1f} samples/s; "
        f"{ra._dlrm_flops(R['bulk_batch'], False) / np.median(bulk) / 1e12:.3f} TFLOP/s "
        f"of model FLOPs")
    flops = {"xdeepfm": ra._xdeepfm_flops, "din": ra._din_flops,
             "autoint": ra._autoint_flops}
    log(f"[recsys] full width, one serve_p99 batch after a warm-up: "
        + ", ".join(f"{a} {ms:.4f} ms ({flops[a](R['p99_batch'], False) / ms / 1e9:.4f} TFLOP/s "
                    f"of model FLOPs)" for a, ms in other_ms.items())
        + f"; retrieval_cand (1 × {R['n_candidates']} candidates, top-100) {retrieval_ms:.4f} ms")
    log(f"[recsys] launches embedding_bag={launches} (expected {n_forward}); "
        f"max_memory_allocated={peak:.2f} GiB on the main path, {setup_peak:.2f} GiB in "
        f"the set-up (params drawn chunk by chunk, the full-width kernel checks)")

    # what comes out is right: at each shape the main path gives the kernel
    # (the bulk gather is checked in ``bag_full_width``) the kernel equals its
    # plain version bit for bit, and each forward with the plain lookup (a
    # gather) gives the same logits bit for bit; the streamed top-k is the
    # top-k of the whole score plane
    gather = types.SimpleNamespace(lookup=lambda t, s, i: t[rec._flat_ids(s, i).long()],
                                   take=rec.LOCAL_READS.take)
    dense, sparse = p99_in[0]
    bag_err = max(bag_err, check_bag(table, rec._flat_ids(cfg.embedding, sparse).reshape(-1, 1),
                                     None, "sum", "dlrm serve_p99 gather"))
    if not torch.equal(rec.dlrm_forward(cfg, params, dense, sparse, reads=gather),
                       rec.dlrm_forward(cfg, params, dense, sparse)):
        raise AssertionError("dlrm forward: kernel lookup and plain gather disagree")
    for arch in ("xdeepfm", "autoint"):
        ocfg, op, batches = others[arch]
        ids = batches[-1][0]                                 # the timed batch
        bag_err = max(bag_err, check_bag(op["table"],
                                         rec._flat_ids(ocfg.embedding, ids).reshape(-1, 1),
                                         None, "sum", f"{arch} serve_p99 gather"))
        if not torch.equal(forwards[arch](ocfg, op, ids, reads=gather),
                           forwards[arch](ocfg, op, ids)):
            raise AssertionError(f"{arch} forward: kernel lookup and plain gather disagree")
    full = (query @ cand.T)[0]
    ref_s, ref_i = torch.sort(full, descending=True, stable=True)
    ref_s, ref_i = ref_s[:100], ref_i[:100]
    # an id may differ from the whole plane's only at a near-tie of scores
    ids_ok = (top_i[0] == ref_i) | torch.isclose(full[top_i[0].long()], ref_s, rtol=1e-5)
    if not torch.allclose(top_s[0], ref_s, rtol=1e-5, atol=1e-5) or not bool(ids_ok.all()):
        raise AssertionError("retrieval_scores is not the top-100 of the score plane")
    log(f"[recsys] checks: the kernel equals its plain version bit for bit on the gathers "
        f"of dlrm serve_p99 (512 × 26, D=128), xdeepfm (512 × 39, D=10) and autoint "
        f"(512 × 39, D=16); the kernel-lookup forward equals the plain-gather forward bit "
        f"for bit for all three; retrieval top-100 equals the full plane's (max score "
        f"{float(top_s[0, 0]):.4f})")

    device_breakdown("recsys bulk batch", lambda: rec.dlrm_forward(cfg, params, *bulk_in[0]))
    rows = device_breakdown("recsys serve_p99 batch",
                            lambda: rec.dlrm_forward(cfg, params, *p99_in[1]))
    bag_rows = [(ms, n) for ms, n, name in rows if "embedding_bag_kernel" in name]
    if bag_rows:
        bag["serve_p99_device_ms"] = sum(r[0] for r in bag_rows) / sum(r[1] for r in bag_rows)
        log(f"[recsys] embedding_bag at the serve_p99 gather (512 × 26 bags of one): "
            f"{bag['serve_p99_device_ms']:.4f} ms of device time per launch (profiler)")
    log(f"[recsys] max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(main path, checks and profile)")
    del table, others, cand, p99_in, bulk_in
    torch.cuda.empty_cache()
    return launches, bag_err, bag, params


# ------------------------------------------------------ recsys training phase
# the train_batch cell (repro/configs/base.py RECSYS_SHAPES) of each arch
# cut_floor: the least batch an arch may be cut to when a step does not fit
# the card (xdeepfm's CIN: 19.04 GiB f32 a layer at 65,536); the others run
# uncut or fail
RECSYS_TRAIN = dict(seed=21, dlrm_steps=10, steps=5, bwd_cases=100, untouched=65_536,
                    reps=10, cut_floor={"xdeepfm": 32_768})


def same_bits(x, y):
    return x.dtype == y.dtype and x.shape == y.shape and torch.equal(
        x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))


def bwd_check(grad, ids, w, combiner, label):
    """embedding_bag_bwd kernel against its plain version on the card: the
    same rows and the same bits, and a second launch gives the same bits.
    Returns max |kernel − plain| (0.0, or it raises)."""
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_bwd_cuda
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_padded_bwd_ref
    rows, got = embedding_bag_bwd_cuda(grad, ids, w, combiner)
    erows, expect = embedding_bag_padded_bwd_ref(grad, ids, w, combiner)
    if not torch.equal(rows, erows):
        raise AssertionError(f"embedding_bag_bwd {label}: rows differ from the plain version")
    bad = int((got.view(torch.int32) != expect.view(torch.int32)).sum())
    if bad:
        raise AssertionError(f"embedding_bag_bwd {label}: {bad} entries differ from the plain "
                             f"version (max |diff| {float((got - expect).abs().max())})")
    _, again = embedding_bag_bwd_cuda(grad, ids, w, combiner)
    if not same_bits(again, got):
        raise AssertionError(f"embedding_bag_bwd {label}: two launches differ")
    return float((got - expect).abs().max()) if got.numel() else 0.0


def bwd_kernel_cases():
    """The row-gradient kernel at ~100 random shapes: D in {1, 8, 10, 16,
    18, 100, 128}, F 1–40, ids all equal / from a few rows / from 10⁵ rows,
    every fifth case a third of its ids −1 (padding, in no row's run),
    weights absent and present, sum and mean, f32 and bf16 grad_out, every
    tenth grad_out one element off its alignment (the scalar loads)."""
    g = torch.Generator(device="cuda").manual_seed(RECSYS_TRAIN["seed"])
    rnd = lambda lo, hi: int(torch.randint(lo, hi, (1,), generator=g, device="cuda"))
    seen, err = set(), 0.0
    for i in range(RECSYS_TRAIN["bwd_cases"]):
        D = (1, 8, 10, 16, 18, 100, 128)[i % 7]
        dtype = (torch.float32, torch.bfloat16)[(i // 7) % 2]
        kind = ("all equal", "a few rows", "many rows")[i % 3]
        weighted, combiner = (i // 2) % 2 == 1, ("sum", "mean")[(i // 4) % 2]
        F = rnd(1, 41)
        B = rnd(1, max(2, 1200 // F)) if kind == "all equal" else rnd(1, 300)
        V = {"all equal": 1, "a few rows": rnd(2, 20), "many rows": 100_000}[kind]
        ids = torch.randint(0, V, (B, F), generator=g, device="cuda", dtype=torch.int32)
        if i % 5 == 4:                                   # padding: about a third −1
            ids[torch.rand((B, F), generator=g, device="cuda") < 1 / 3] = -1
        flat = torch.randn((B * D + 1,), generator=g, device="cuda").to(dtype)
        grad = (flat[1:] if i % 10 == 9 else flat[:-1]).view(B, D)
        w = None
        if weighted:
            w = torch.rand((B, F), generator=g, device="cuda") * 1.9 + 0.1
            w[::3, -1] = 0.0
        err = max(err, bwd_check(grad, ids, w, combiner, f"case {i}: B={B} F={F} D={D} "
                                 f"{dtype} {kind} {combiner} "
                                 f"{'weighted' if weighted else 'ones'}"))
        seen.add((D, dtype, kind, weighted, combiner))
    log(f"[recsys-train] embedding_bag_bwd kernel vs plain: {RECSYS_TRAIN['bwd_cases']} random "
        f"shapes ({len(seen)} distinct (D, dtype, repetition, weights, combiner) combinations, "
        f"D 1…128, F 1…40, ids all equal / a few rows / 10⁵ rows, every fifth with −1 "
        f"padding, every tenth grad_out unaligned): 0 mismatches, bit for bit (max |diff| "
        f"{err}); a second launch gave the same bits each time")
    return err


def bwd_long_cases():
    """The row-gradient kernel where runs reach its long-run path (more than
    ``LONG_RUN`` items): runs of LONG_RUN − 1, LONG_RUN and LONG_RUN + 1
    items at D = 1, 10, 18, 100 and 128 (widths that leave a partial column
    slice), "all equal" runs of 20,000 and 40,000 items, runs of ~5,000
    with weights and mean, gradients one element off their alignment, and
    4,200 long runs (more than the plan sorts in shared memory). Each case
    also holds the plan's kernels (``bwd_plan_cuda``) to their plain
    versions (``bwd_tiles``, ``long_runs``)."""
    from repro_torch.kernels.embedding_bag.kernel import (
        LONG_RUN, TILE_ITEMS, bwd_plan_cuda, bwd_tiles, long_runs)
    from repro_torch.kernels.embedding_bag.ref import row_runs
    g = torch.Generator(device="cuda").manual_seed(RECSYS_TRAIN["seed"] + 3)
    L, err = LONG_RUN, 0.0
    edges = [0] * (L - 1) + [1] * L + [2] * (L + 1)
    cases = [(f"runs of L-1, L, L+1 (+ 300 short ids), D={D} {dt}", D, dt, edges, 1, 300,
              "sum", False, 0)
             for D, dt in ((1, torch.float32), (10, torch.bfloat16), (18, torch.bfloat16),
                           (100, torch.float32), (128, torch.bfloat16))]
    cases += [("20,000 equal ids, D=128 bf16", 128, torch.bfloat16, [0] * 20_000, 1, 0,
               "sum", False, 0),
              ("40,000 equal ids, D=18 f32, weights and mean", 18, torch.float32,
               [0] * 40_000, 1, 0, "mean", True, 0),
              ("3,000 bags of 5 from 3 rows, D=128 bf16, weights and mean", 128,
               torch.bfloat16, "3 rows", 5, 0, "mean", True, 0),
              ("3,000 bags of 5 from 3 rows, D=100 bf16, unaligned, weights", 100,
               torch.bfloat16, "3 rows", 5, 0, "sum", True, 1),
              ("runs of L-1, L, L+1, D=10 f32, unaligned, mean", 10, torch.float32, edges, 1, 50,
               "mean", False, 1),
              ("4,200 runs of L+4, D=1 f32", 1, torch.float32,
               [u for u in range(4_200) for _ in range(L + 4)], 1, 0, "sum", False, 0)]
    for label, D, dt, runs, F, extra, combiner, weighted, offset in cases:
        if runs == "3 rows":
            ids = torch.randint(0, 3, (3_000, F), generator=g, device="cuda", dtype=torch.int32)
        else:
            flat = torch.tensor(runs, dtype=torch.int32, device="cuda")
            flat = torch.cat([flat, torch.randint(10, 100_000, (extra,), generator=g,
                                                  device="cuda", dtype=torch.int32)])
            ids = flat[torch.randperm(flat.numel(), generator=g, device="cuda")][:, None]
        B = ids.shape[0]
        grad = torch.randn((B * D + offset,), generator=g, device="cuda").to(dt)[offset:].view(B, D)
        w = torch.rand((B, F), generator=g, device="cuda") * 1.9 + 0.1 if weighted else None
        err = max(err, bwd_check(grad, ids.contiguous(), w, combiner, f"long-run case {label}"))
        _, _, starts = row_runs(ids)
        tiles, by_len = bwd_plan_cuda(starts, B * F)
        if not (torch.equal(tiles, bwd_tiles(starts, B * F, TILE_ITEMS))
                and torch.equal(by_len, long_runs(starts, B * F, L))):
            raise AssertionError(f"embedding_bag_bwd plan, {label}: the plan's kernels differ "
                                 f"from their plain versions")
    log(f"[recsys-train] embedding_bag_bwd kernel vs plain where runs are long (more than "
        f"{L} items): {len(cases)} cases (runs of L-1/L/L+1 at D 1, 10, 18, 100, 128; 20,000 "
        f"and 40,000 equal ids; ~5,000-item runs with weights and mean; unaligned gradients; "
        f"4,200 long runs): 0 mismatches, bit for bit (max |diff| {err}), two launches equal; "
        f"the plan's kernels equal their plain versions in each")
    return err


def bwd_full_width(ids):
    """The kernel at dlrm-mlperf's train_batch: the step's 65,536 × 26 ids as
    bags of one (``lookup``'s backward) into the 187,767,552 × 128 bf16
    table, bf16 gradient rows: checked bit for bit against the plain version,
    timed alone (the runs grouped beforehand) and with its stable sort, the
    plain version once, and ``index_add_`` into a zeroed [U, D] f32 (a
    yardstick, never on the path)."""
    from repro_torch.kernels.embedding_bag.kernel import (
        LONG_RUN, TILE_ITEMS, bwd_plan_cuda, bwd_tiles, embedding_bag_bwd_cuda,
        embedding_bag_bwd_runs_cuda, long_runs)
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_padded_bwd_ref, row_runs
    one = ids.reshape(-1, 1).contiguous()
    N, D = one.shape[0], 128
    g = torch.Generator(device="cuda").manual_seed(RECSYS_TRAIN["seed"] + 1)
    grad = torch.randn((N, D), generator=g, device="cuda").to(torch.bfloat16)
    order, rows, starts = row_runs(one)
    U = rows.numel()
    counts = starts[1:] - starts[:-1]
    tiles, by_len = bwd_plan_cuda(starts, N)
    if not (torch.equal(tiles, bwd_tiles(starts, N, TILE_ITEMS))
            and torch.equal(by_len, long_runs(starts, N, LONG_RUN))):
        raise AssertionError("embedding_bag_bwd plan at the full-width train gather: the plan's "
                             "kernels differ from their plain versions")
    n_long = int((counts > LONG_RUN).sum())
    reps = RECSYS_TRAIN["reps"]
    ms = timed_ms(lambda: embedding_bag_bwd_runs_cuda(grad, order, starts, 1), reps=reps)
    with_sort_ms = timed_ms(lambda: embedding_bag_bwd_cuda(grad, one, None, "sum"), reps=reps)
    plain_ms, (prows, plain) = events_ms(lambda: embedding_bag_padded_bwd_ref(grad, one))
    got = embedding_bag_bwd_runs_cuda(grad, order, starts, 1)
    bad = int((got.view(torch.int32) != plain.view(torch.int32)).sum())
    if not torch.equal(prows, rows) or bad:
        raise AssertionError(f"embedding_bag_bwd at the full-width train gather: {bad} entries "
                             f"differ from the plain version")
    err = float((got - plain).abs().max())
    del plain, got
    inverse = torch.empty(N, dtype=torch.int64, device="cuda")
    inverse[order] = torch.repeat_interleave(torch.arange(U, device="cuda"), counts)
    acc = torch.zeros((U, D), dtype=torch.float32, device="cuda")
    gradf = grad.float()
    library_ms = timed_ms(lambda: acc.index_add_(0, inverse, gradf), reps=reps)
    # bytes: each item's gradient row and its position read once, the run
    # offsets once, each distinct row's f32 gradient written once; ops: one
    # add an element
    moved = N * D * grad.element_size() + N * 8 + (U + 1) * 8 + U * D * 4
    bound_ms, bound_by = bound(moved, N * D)
    longest = int(counts.max())
    log(f"[recsys-train] embedding_bag_bwd at dlrm-mlperf train_batch ({N} bags of one, D={D}, "
        f"bf16 grad_out, {U} distinct rows, the longest run {longest} items, {n_long} runs "
        f"longer than {LONG_RUN}; the plan's kernels equal their plain versions): kernel_ms="
        f"{ms:.4f} (runs grouped beforehand), with its stable sort {with_sort_ms:.4f} ms, "
        f"plain_ms={plain_ms:.4f} (once), library_ms={library_ms:.4f} (index_add_ into a "
        f"zeroed [U, D] f32), bound_ms={bound_ms:.4f} ({bound_by}, {moved / 1e9:.4f} GB) "
        f"share_of_bound={bound_ms / ms:.4f}; bit for bit with the plain version")
    return dict(ms=ms, with_sort_ms=with_sort_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, distinct_rows=U, longest_run=longest,
                long_runs=n_long, max_abs_err=err)


def train_gathers(arch, cfg, inputs):
    """{table parameter: the ids int32 its one read a forward hands to
    ``embedding_bag`` (bags of one) or ``take_rows``}, as the forward makes
    them: DIN's target and history in one gather, the −1 padding kept."""
    from repro_torch.models.recsys import _flat_ids
    if arch == "din":
        target, hist, ctx = inputs
        off = torch.arange(cfg.n_context, device="cuda", dtype=torch.int32) * cfg.context_vocab
        return {"item_table": torch.cat([target[:, None], hist], dim=1),
                "ctx_table": ctx + off[None, :]}
    flat = _flat_ids(cfg.embedding, inputs[-1])
    return {"table": flat, **({"linear_w": flat} if arch == "xdeepfm" else {})}


def touched_rows(arch, cfg, inputs):
    """{table parameter: the distinct rows the batch reads}; −1 is padding."""
    return {k: torch.unique(ids[ids >= 0]).long()
            for k, ids in train_gathers(arch, cfg, inputs).items()}


def bwd_at_gathers(arch, cfg, params, inputs, g):
    """The row-gradient kernel against its plain version at each table's own
    gather of the step (the flat ids as bags of one, padding kept, a random
    grad_out in the table's dtype and width): bit for bit, two launches equal;
    then timed by CUDA events (the runs grouped beforehand, as
    ``bwd_full_width``) beside ``index_add_`` into a zeroed f32 (a
    yardstick; padding into a row of its own) and the bytes bound. Returns
    (max |kernel − plain| over the tables, {table: its numbers})."""
    from repro_torch.kernels.embedding_bag.kernel import LONG_RUN, embedding_bag_bwd_runs_cuda
    from repro_torch.kernels.embedding_bag.ref import row_runs
    err, numbers = 0.0, {}
    for k, ids in train_gathers(arch, cfg, inputs).items():
        flat = ids.reshape(-1, 1).to(torch.int32).contiguous()
        p = params[k]
        D = p.shape[1] if p.dim() == 2 else 1
        grad = torch.randn((flat.shape[0], D), generator=g, device="cuda").to(p.dtype)
        pad = int((flat < 0).sum())
        t0 = time.perf_counter()
        e = bwd_check(grad, flat, None, "sum", f"{arch} {k} at the step's gather")
        check_s = time.perf_counter() - t0
        order, rows, starts = row_runs(flat)
        U, N = rows.numel(), flat.shape[0]
        counts = starts[1:] - starts[:-1]
        longest, n_long = int(counts.max()), int((counts > LONG_RUN).sum())
        reps = RECSYS_TRAIN["reps"]
        ms = timed_ms(lambda: embedding_bag_bwd_runs_cuda(grad, order, starts, 1), reps=reps)
        inverse = torch.full((N,), U, dtype=torch.int64, device="cuda")
        inverse[order[pad:]] = torch.repeat_interleave(torch.arange(U, device="cuda"), counts)
        acc = torch.zeros((U + 1, D), dtype=torch.float32, device="cuda")
        gradf = grad.float()
        library_ms = timed_ms(lambda: acc.index_add_(0, inverse, gradf), reps=reps)
        moved = (N - pad) * (D * grad.element_size() + 8) + (U + 1) * 8 + U * D * 4
        bound_ms, bound_by = bound(moved, (N - pad) * D)
        log(f"[recsys-train] {arch}: embedding_bag_bwd at {k}'s own gather ({N} ids, "
            f"{pad} of them −1 padding, {U} distinct rows, the longest run {longest}, {n_long} "
            f"runs longer than {LONG_RUN}, D={D}, {p.dtype} grad_out): 0 mismatches against "
            f"the plain version, bit for bit (max |diff| {e}), two launches equal "
            f"({check_s:.2f} s); kernel_ms={ms:.4f} (runs grouped beforehand), "
            f"library_ms={library_ms:.4f} (index_add_ into a zeroed f32), bound_ms="
            f"{bound_ms:.4f} ({bound_by}) share_of_bound={bound_ms / ms:.4f}")
        numbers[k] = dict(ids=N, padding=pad, distinct_rows=U, longest_run=longest,
                          long_runs=n_long, D=D, ms=ms, library_ms=library_ms,
                          bound_ms=bound_ms)
        err = max(err, e)
        del grad, gradf, acc, inverse, order, starts
    return err, numbers


def einsum_path_line(B):
    """How torch.einsum contracts xdeepfm's CIN layer (h = 200) at batch B."""
    from repro_torch.configs import recsys_archs as ra
    F, D, h = ra.XDEEPFM.embedding.n_fields, ra.XDEEPFM.embedding.dim, ra.XDEEPFM.cin_layers[1]
    if not torch.backends.opt_einsum.is_available():
        return "opt_einsum absent: torch contracts left to right, the bid,bjd outer product first"
    import opt_einsum
    _, info = opt_einsum.contract_path("bid,bjd,hij->bhd", (B, h, D), (B, F, D), (h, h, F),
                                       shapes=True)
    return (f"opt_einsum ({torch.backends.opt_einsum.strategy}) path {info.path}, largest "
            f"intermediate {info.largest_intermediate:.4g} elements "
            f"({info.largest_intermediate * 4 / 2**30:.2f} GiB f32)")


def train_arch(arch, params=None):
    """One arch's train_batch cell at full width through ``cell.fn``: the
    counted steps on one fixed batch (dlrm-mlperf 10, the others 5), the
    batch halved until the first step fits the card (printed), then two
    steps from one state (bit for bit in the touched rows, the dense
    parameters and their moments), a sample of untouched rows (unchanged),
    and one profiled step."""
    from repro_torch.configs import recsys_archs as ra
    from repro_torch.kernels.embedding_bag import ops
    R = RECSYS_TRAIN
    cell = ra.specs()[arch].cell("train_batch")
    cfg = {"dlrm-mlperf": ra.DLRM, "xdeepfm": ra.XDEEPFM, "din": ra.DIN,
           "autoint": ra.AUTOINT}[arch]
    steps = R["dlrm_steps"] if arch == "dlrm-mlperf" else R["steps"]
    g = torch.Generator(device="cuda").manual_seed(R["seed"] + 2)
    t0 = time.perf_counter()
    params, state, labels, *inputs = cell.make_args(g, "cuda", params=params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    B = full = labels.shape[0]
    floor = R["cut_floor"].get(arch, full)
    sample, restore = {}, {}
    for k, rows in touched_rows(arch, cfg, inputs).items():   # rows the batch does not read
        if floor < full:     # a step that runs out of memory may have updated some rows
            restore[k] = (rows, params[k].index_select(0, rows))
        V = params[k].shape[0]
        pick = torch.randint(0, V, (R["untouched"],), generator=g, device="cuda")
        hit = torch.zeros(V, dtype=torch.bool, device="cuda")
        hit[rows] = True
        pick = pick[~hit[pick]]
        sample[k] = (pick, params[k][pick].clone())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts from 0, `steps` train steps ----
    ops.launches = ops.bwd_launches = 0
    losses, times, cut = [], [], []
    while True:
        batch = (labels[:B], *(x[:B] for x in inputs))
        oom = None
        try:
            t0 = time.perf_counter()
            params, state, loss = cell.fn(params, state, *batch)
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError as exc:     # the stated cut: halve the batch
            oom = str(exc).splitlines()[0][:160]
        if B // 2 < floor:
            raise AssertionError(f"{arch} train: out of memory at B={B} ({oom}); it may be cut "
                                 f"to {floor} at the least")
        for k, (rows, saved) in restore.items():
            params[k].index_copy_(0, rows, saved)
        cut.append((B, oom))
        B //= 2
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.launches = ops.bwd_launches = 0
    times.append(time.perf_counter() - t0)
    losses.append(float(loss))
    for _ in range(steps - 1):
        t0 = time.perf_counter()
        params, state, loss = cell.fn(params, state, *batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches, bwd_launches = ops.launches, ops.bwd_launches
    # ---- end of the main path ----

    peak = torch.cuda.max_memory_allocated() / 2**30
    del restore
    for b, msg in cut:
        log(f"[recsys-train] {arch}: batch {b} does not fit the card ({msg}); cut to {b // 2} "
            f"(the least allowed {floor})")
    med = float(np.median(times[1:]))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{arch} train: the loss did not fall: {losses}")
    if peak >= 80:
        raise AssertionError(f"{arch} train: peak {peak:.2f} GiB")
    per_step = {"dlrm-mlperf": (1, 1), "xdeepfm": (1, 2), "din": (0, 2), "autoint": (1, 1)}[arch]
    if (launches, bwd_launches) != (per_step[0] * steps, per_step[1] * steps):
        raise AssertionError(f"{arch} train: embedding_bag launched {launches} times and "
                             f"embedding_bag_bwd {bwd_launches}, expected "
                             f"{per_step[0] * steps} and {per_step[1] * steps}")
    flops = {"dlrm-mlperf": ra._dlrm_flops, "xdeepfm": ra._xdeepfm_flops,
             "din": ra._din_flops, "autoint": ra._autoint_flops}[arch](B, True)
    log(f"[recsys-train] {arch} train_batch at full width, B={B}"
        + (f" (cut from {full})" if B != full else "")
        + f": {steps} steps on one batch, median step {med * 1e3:.4f} ms (host clock + "
        f"synchronize; first step {times[0] * 1e3:.4f} ms), {B / med:.1f} samples/s, "
        f"{flops / med / 1e12:.4f} TFLOP/s of model FLOPs; peak {peak:.2f} GiB "
        f"(max_memory_allocated over the steps); set-up {setup_s:.2f} s; losses "
        f"{[round(x, 6) for x in losses]}; launches embedding_bag={launches} "
        f"embedding_bag_bwd={bwd_launches}")

    # two steps from one state: the tables change only in their touched rows
    # (restored before each), the dense parameters and the state come back as
    # new tensors
    touched = touched_rows(arch, cfg, batch[1:])
    saved = {k: params[k].index_select(0, rows) for k, rows in touched.items()}
    after = []
    for _ in range(2):
        for k, rows in touched.items():
            params[k].index_copy_(0, rows, saved[k])
        new, new_state, _ = cell.fn(dict(params), state, *batch)
        after.append(({k: new[k].index_select(0, rows) for k, rows in touched.items()},
                      {k: v for k, v in new.items() if k not in touched}, new_state))
    (ta, da, sa), (tb, db, sb) = after
    for k in ta:
        if not same_bits(ta[k], tb[k]):
            raise AssertionError(f"{arch} train: two steps from one state differ in {k}'s rows")
    for k in da:
        if not (same_bits(da[k], db[k]) and same_bits(sa["m"][k], sb["m"][k])
                and same_bits(sa["v"][k], sb["v"][k])):
            raise AssertionError(f"{arch} train: two steps from one state differ in {k}")
    for k, (pick, before) in sample.items():
        if not same_bits(new[k][pick], before):
            raise AssertionError(f"{arch} train: an untouched row of {k} changed")
    log(f"[recsys-train] {arch}: two steps from one state equal bit for bit in "
        f"{sum(r.numel() for r in touched.values())} touched rows of {sorted(touched)} and "
        f"{len(da)} dense parameters and their AdamW moments; "
        f"{sum(p.numel() for p, _ in sample.values())} sampled untouched rows unchanged bit for "
        f"bit after {steps + 2} steps")
    device_breakdown(f"recsys-train {arch} step (B={B})",
                     lambda: cell.fn(new, new_state, *batch))
    del after, ta, da, sa, tb, db, sb, saved
    bwd_err, bwd_gathers = bwd_at_gathers(arch, cfg, new, batch[1:], g)
    return dict(batch=B, cut_from=full if B != full else None, steps=steps,
                step_ms=med * 1e3, samples_per_s=B / med, peak_gib=peak, losses=losses,
                launches=launches, bwd_launches=bwd_launches, bwd_max_abs_err=bwd_err,
                bwd_gathers=bwd_gathers)


def recsys_train_phase(dlrm_params):
    """The recsys train_batch cell at full width on the card: the
    row-gradient kernel at ~100 random shapes, at 11 shapes of long runs and
    at dlrm-mlperf's train gather (bit for bit, timed), then ``cell.fn`` of
    all four archs (each table's own gather checked and timed):
    dlrm-mlperf on recsys_phase's 187,767,552 × 128 bf16 table (not drawn
    again), 10 steps; xdeepfm, din and autoint 5 steps each. Returns the
    kernel's numbers and each arch's report."""
    from repro_torch.configs import recsys_archs as ra
    from repro_torch.models.recsys import _flat_ids
    cases_err = max(bwd_kernel_cases(), bwd_long_cases())
    cell = ra.specs()["dlrm-mlperf"].cell("train_batch")
    g = torch.Generator(device="cuda").manual_seed(RECSYS_TRAIN["seed"] + 2)
    ids = cell.make_args(g, "cuda", params=dlrm_params)[-1]   # train_arch's own batch
    bwd = bwd_full_width(_flat_ids(ra.DLRM.embedding, ids))
    del ids
    log(f"[recsys-train] xdeepfm's CIN at B=65536: {einsum_path_line(65536)}")
    runs = {"dlrm-mlperf": train_arch("dlrm-mlperf", dlrm_params)}
    del dlrm_params
    for arch in ("xdeepfm", "din", "autoint"):
        gc.collect()
        torch.cuda.empty_cache()
        runs[arch] = train_arch(arch)
    gc.collect()
    torch.cuda.empty_cache()
    bwd["max_abs_err"] = max(cases_err, bwd["max_abs_err"],
                             *(r.pop("bwd_max_abs_err") for r in runs.values()))
    bwd["at_gathers"] = {f"{a} {k}": n for a, r in runs.items()
                         for k, n in r.pop("bwd_gathers").items()}
    return bwd, runs


def recsys_small_phase():
    """The four small_recsys() configs: the card's forwards (kernel lookups)
    against the same forwards on the CPU (plain lookups) with the same
    parameters and inputs, f32 and bf16 tables, within rtol = atol = 1e-5
    (the f32 products summed in another order on each side)."""
    from repro_torch.configs import recsys_archs as ra
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.models import recsys as rec

    forwards = {"dlrm-mlperf": rec.dlrm_forward, "xdeepfm": rec.xdeepfm_forward,
                "din": rec.din_forward, "autoint": rec.autoint_forward}
    worst = 0.0
    before = ops.launches
    for arch, cfg in ra.small_recsys().items():
        for dtype in (torch.float32, torch.bfloat16):
            params = rec.init_params(cfg, torch.Generator().manual_seed(5), "cpu", dtype)
            g = torch.Generator(device="cuda").manual_seed(6)
            args = [a.cpu() for a in recsys_inputs(arch, cfg, 64, g)]
            out = {dev: forwards[arch](cfg, {k: v.to(dev) for k, v in params.items()},
                                       *(a.to(dev) for a in args)).cpu()
                   for dev in ("cuda", "cpu")}
            if not torch.allclose(out["cuda"], out["cpu"], rtol=1e-5, atol=1e-5):
                raise AssertionError(f"small {arch} {dtype}: card and CPU differ by "
                                     f"{float((out['cuda'] - out['cpu']).abs().max())}")
            worst = max(worst, float((out["cuda"] - out["cpu"]).abs().max()))
    log(f"[recsys-small] 4 archs × f32/bf16 tables: card == CPU within 1e-5 (max |card − CPU| "
        f"{worst:.3g}); {ops.launches - before} kernel lookups on the card")


# ------------------------------------------------------------- GNN phase
# graphsage-reddit's four train cells at full size through cell.fn, every
# float scatter on their paths a launch of the row-gradient kernel
# (gather_segment_sum, segment_sum / gather_rows) or the bag kernel
# (minibatch_lg's aggregate)
GNN = dict(seed=26, steps=3, cora_steps=20, cora_degree=3, reddit_degree=20,
           reddit_seeds=1024, chunk=1_048_576)


def fingerprint(tree):
    """A bit-level digest of a tensor tree: per leaf, the int64 sum of its
    words (the element bits as int16 or int32), in sorted key order."""
    from repro_torch.checkpoint.io import leaves
    out = []
    for x in leaves(tree):
        x = x.detach().contiguous()
        w = x.view(torch.int16 if x.element_size() == 2 else torch.int32)
        out.append(int(w.sum(dtype=torch.int64)))
    return out


def plain_segment_sum(rows, seg, n):
    """segment_sum's plain version on the card: the row-gradient kernel's
    plain version (its order), copied into the distinct rows of zeros."""
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_padded_bwd_ref
    u, sums = embedding_bag_padded_bwd_ref(rows, seg.reshape(-1, 1), None, "sum")
    out = torch.zeros((n, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return out.index_copy_(0, u, sums.to(rows.dtype))


def scatter_check(h, src, dst, n, label):
    """gather_segment_sum(h, src, dst, n) in one chunk and its gradient with
    respect to h (itself with src and dst swapped) against their plain
    versions, bit for bit; timed beside index_add_ (the library call, whose
    order changes from run to run). Returns its numbers."""
    from repro_torch.kernels.embedding_bag import ops
    E = src.shape[0]
    x = h.detach().requires_grad_(True)
    out = ops.gather_segment_sum(x, src, dst, n, E)
    want = plain_segment_sum(h[src.long()], dst, n)
    if not same_bits(out.detach(), want):
        raise AssertionError(f"gather_segment_sum {label}: differs from its plain version by "
                             f"{float((out.detach() - want).abs().max())}")
    up = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(5),
                     device="cuda", dtype=h.dtype)
    (grad,) = torch.autograd.grad(out, x, up)
    want_g = plain_segment_sum(up[dst.long()], src, h.shape[0])
    if not same_bits(grad, want_g):
        raise AssertionError(f"gather_segment_sum {label}: its gradient differs from the "
                             f"plain version by {float((grad - want_g).abs().max())}")
    del x, out, want, up, grad, want_g
    ms = timed_ms(lambda: ops.gather_segment_sum(h, src, dst, n, E), 5)
    plain_ms, _ = events_ms(lambda: plain_segment_sum(h[src.long()], dst, n))
    rows = h[src.long()]
    lib_ms = timed_ms(lambda: torch.zeros((n, h.shape[1]), dtype=h.dtype, device="cuda")
                      .index_add_(0, dst.long(), rows), 5)
    # each edge's source row read once, both ids read, the output written once
    moved = rows.numel() * rows.element_size() + E * 8 + n * h.shape[1] * h.element_size()
    b_ms, b_by = bound(moved, rows.numel())
    log(f"[gnn] gather_segment_sum at {label} ({E:,} edges of {h.shape[1]} "
        f"{str(h.dtype).replace('torch.', '')} into {n:,}): kernel == plain bit for bit, "
        f"forward and gradient; {ms:.4f} ms (plain {plain_ms:.4f}, index_add_ {lib_ms:.4f}, "
        f"bound {b_ms:.4f} by {b_by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms)


@contextlib.contextmanager
def held_bwd(keep=None, first=None):
    """Every launch of the row-gradient kernel inside the block (or only the
    ``first`` ones) held against its plain version on the same inputs, bit
    for bit (the distinct rows and the sums): a mismatch raises. Yields the
    list of the held launches' shapes (ids, distinct rows, longest run, D,
    dtype); ``keep``, a dict, gets the inputs of the launch with the longest
    run (``run``) and of the one with the most distinct rows (``wide``), for
    timing."""
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_padded_bwd_ref
    real, calls = ops.embedding_bag_bwd_cuda, []

    def held(grad_out, ids, weights=None, combiner="sum"):
        if first is not None and len(calls) >= first:
            return real(grad_out, ids, weights, combiner)
        u, sums = real(grad_out, ids, weights, combiner)
        wu, ws = embedding_bag_padded_bwd_ref(grad_out, ids, weights, combiner)
        if not (torch.equal(u, wu) and same_bits(sums, ws)):
            raise AssertionError(f"embedding_bag_bwd on the path ({tuple(ids.shape)} ids, D "
                                 f"{grad_out.shape[1]}, {grad_out.dtype}): differs from its "
                                 f"plain version")
        flat = ids.reshape(-1)
        run = int(torch.unique(flat[flat >= 0], return_counts=True)[1].max())
        calls.append(dict(ids=flat.numel(), distinct_rows=u.numel(), longest_run=run,
                          D=grad_out.shape[1], dtype=str(grad_out.dtype)))
        if keep is not None and weights is None and ids.shape[1] == 1:
            args = (grad_out.detach(), ids)
            if run > keep.get("run", (-1,))[0]:
                keep["run"] = (run, args)
            if u.numel() > keep.get("wide", (-1,))[0]:
                keep["wide"] = (u.numel(), args)
        return u, sums

    ops.embedding_bag_bwd_cuda = held
    try:
        yield calls
    finally:
        ops.embedding_bag_bwd_cuda = real


def held_line(calls):
    """A summary of ``held_bwd``'s launches for a log line."""
    if not calls:
        return "no launch of embedding_bag_bwd"
    return (f"{len(calls)} launches of embedding_bag_bwd, each equal to its plain version bit "
            f"for bit ({min(c['ids'] for c in calls):,}–{max(c['ids'] for c in calls):,} ids, "
            f"D {sorted({c['D'] for c in calls})}, {sorted({c['dtype'] for c in calls})}, "
            f"the longest run {max(c['longest_run'] for c in calls):,} items)")


def bwd_at_call(label, grad, ids, tag):
    """The row-gradient kernel at one launch's own inputs taken from the path
    (``held_bwd``'s ``keep``): timed as the path launches it (its stable
    sort included), the plain version once, ``index_add_`` into a zeroed
    [U, D] f32 (a yardstick, never on the path) and the bytes bound."""
    from repro_torch.kernels.embedding_bag.kernel import LONG_RUN, embedding_bag_bwd_cuda
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_padded_bwd_ref, row_runs
    order, rows, starts = row_runs(ids)
    U, N, D = rows.numel(), ids.shape[0], grad.shape[1]
    counts = starts[1:] - starts[:-1]
    pad = N - int(counts.sum())
    ms = timed_ms(lambda: embedding_bag_bwd_cuda(grad, ids, None, "sum"), 5)
    plain_ms, _ = events_ms(lambda: embedding_bag_padded_bwd_ref(grad, ids, None, "sum"))
    inverse = torch.full((N,), U, dtype=torch.int64, device="cuda")
    inverse[order[pad:]] = torch.repeat_interleave(torch.arange(U, device="cuda"), counts)
    acc = torch.zeros((U + 1, D), dtype=torch.float32, device="cuda")
    gradf = grad.float()
    library_ms = timed_ms(lambda: acc.index_add_(0, inverse, gradf), 5)
    # each item's row and id read once, each distinct row and its f32 sum
    # written once; one add an element
    moved = (N - pad) * (D * grad.element_size() + 4) + U * (8 + D * 4)
    bound_ms, bound_by = bound(moved, (N - pad) * D)
    longest, n_long = int(counts.max()), int((counts > LONG_RUN).sum())
    log(f"{tag} embedding_bag_bwd at {label} ({N:,} ids, {U:,} distinct rows, the longest run "
        f"{longest:,}, {n_long} runs longer than {LONG_RUN}, D={D}, {grad.dtype}): "
        f"{ms:.4f} ms with its sort (plain {plain_ms:.4f}, index_add_ {library_ms:.4f}, bound "
        f"{bound_ms:.4f} by {bound_by})")
    return dict(ids=N, distinct_rows=U, longest_run=longest, long_runs=n_long, D=D,
                dtype=str(grad.dtype), ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms)


def bag_dense_check(table, nb, label):
    """The sampled aggregate's bag kernel with its dense row gradient (the
    table an activation) against the plain versions, bit for bit in the
    gradient (the row-gradient kernel, mean over the valid mask)."""
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_padded_bwd_ref
    ids, w = nb.clamp_min(0).to(torch.int32).contiguous(), (nb >= 0).to(torch.float32)
    x = table.detach().requires_grad_(True)
    out = ops.embedding_bag(x, ids, w, "mean", dense_grad=True)
    up = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(6),
                     device="cuda")
    (grad,) = torch.autograd.grad(out, x, up)
    u, sums = embedding_bag_padded_bwd_ref(up, ids, w, "mean")
    want = torch.zeros_like(grad).index_copy_(0, u, sums)
    if grad.is_sparse or not same_bits(grad, want):
        raise AssertionError(f"embedding_bag dense gradient {label}: differs from the plain "
                             "version")
    log(f"[gnn] embedding_bag mean with its dense row gradient at {label} "
        f"({ids.shape[0]:,} × {ids.shape[1]} into {table.shape[0]:,} rows of "
        f"{table.shape[1]}): the gradient equals the plain version bit for bit")


def pad_graph(g, N, E):
    """A random_graph laid into a full-graph cell's padded shapes: its nodes
    first, the padding edges from and to the last padded node, every real
    node in the loss."""
    src, dst = g.edge_list()
    feats = torch.zeros((N, g.feats.shape[1]))
    feats[:g.n_nodes] = torch.from_numpy(g.feats)
    s = torch.full((E,), N - 1, dtype=torch.int32)
    d = s.clone()
    s[:len(src)], d[:len(dst)] = torch.from_numpy(src), torch.from_numpy(dst)
    labels = torch.zeros(N, dtype=torch.int32)
    labels[:g.n_nodes] = torch.from_numpy(g.labels)
    mask = (torch.arange(N) < g.n_nodes).to(torch.float32)
    return [t.cuda() for t in (feats, s, d, labels, mask)]


def pad_blocks(feats, neigh, labels, sizes):
    """A NeighborSampler draw laid into minibatch_lg's padded level sizes
    (zero feature rows, −1 neighbor rows)."""
    fs = []
    for f, n in zip(feats, sizes):
        if f.shape[0] > n:
            raise AssertionError(f"a sampled level of {f.shape[0]} rows exceeds the cell's {n}")
        x = torch.zeros((n, f.shape[1]), device="cuda")
        x[:f.shape[0]] = torch.from_numpy(f).cuda()
        fs.append(x)
    ns = []
    for nb, n in zip(neigh, sizes):
        x = torch.full((n, nb.shape[1]), -1, dtype=torch.int32)
        x[:nb.shape[0]] = torch.from_numpy(nb)
        ns.append(x.cuda())
    return fs, ns, torch.from_numpy(labels).cuda()


def train_cell(label, cell, args, steps, want_fall=False, tag="[gnn]", keep=None):
    """``steps`` AdamW steps of a cell from ``args`` (params and state
    first), the first run twice from one state (the same bits), the counts
    from 0 before and read after; then one more step with every launch of
    the row-gradient kernel held against its plain version (``held_bwd``,
    ``keep`` as there) → its report."""
    from repro_torch.kernels.embedding_bag import ops
    params, state, *inputs = args
    free_card()
    bag0, bwd0 = ops.launches, ops.bwd_launches
    losses, times, prints = [], [], []
    for i in range(steps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        new, new_state, loss = cell.fn(params, state, *inputs)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        losses.append(float(loss))
        if i == 0:
            prints.append(fingerprint((new, new_state, loss)))
            del new, new_state, loss
            again = cell.fn(params, state, *inputs)
            prints.append(fingerprint(again))
            new, new_state, loss = again
            del again
        params, state = new, new_state
        del new, new_state
    launches = (ops.launches - bag0, ops.bwd_launches - bwd0)
    peak = peak_gib()
    with held_bwd(keep) as calls:
        cell.fn(params, state, *inputs)
    if len(calls) * (steps + 1) != launches[1]:
        raise AssertionError(f"{label}: the held step made {len(calls)} launches of "
                             f"embedding_bag_bwd, the {steps + 1} steps {launches[1]}")
    if prints[0] != prints[1]:
        raise AssertionError(f"{label}: step 1 twice from one state gave different bits")
    if not all(np.isfinite(losses)) or (want_fall and not losses[-1] < losses[0]):
        raise AssertionError(f"{label}: losses {losses}")
    med = float(np.median(times[1:] if steps > 1 else times))
    log(f"{tag} {label}: {steps} AdamW steps through cell.fn, median step {med:.4f} ms "
        f"(CUDA events; first {times[0]:.4f}), peak {peak:.2f} GiB, losses "
        f"{[round(x, 5) for x in (losses if steps <= 5 else losses[:3] + losses[-2:])]}; "
        f"step 1 twice from one state: the same bits in every parameter, moment and the "
        f"loss; launches embedding_bag={launches[0]} embedding_bag_bwd={launches[1]}; one "
        f"more step: {held_line(calls)}")
    return dict(step_ms=med, peak_gib=peak, losses=losses, bag=launches[0], bwd=launches[1],
                held=len(calls))


def gnn_phase():
    """The GNN slice on the card: segment_sum / gather_rows bit for bit at one
    ogb_products edge chunk (d = 100 f32), at cora's feature width (d =
    1,433) and at minibatch_lg's level-2 block (d = 602), the bag's dense
    gradient at the level-1 block; then the four cells (full_graph_sm on a
    random_graph of cora's size for 20 steps, minibatch_lg fed by the
    NeighborSampler on a random_graph of reddit's nodes, ogb_products and
    molecule on their drawn inputs). Returns each cell's report."""
    from repro_torch.configs import gnn_archs as ga
    from repro_torch.data import sampler as smp
    from repro_torch.dist import sharding as shd
    G = GNN
    g = torch.Generator(device="cuda").manual_seed(G["seed"])
    spec = ga.spec()
    scat = {}
    n = shd.round_up(ga.GNN_SHAPES["ogb_products"]["n_nodes"], 512)
    h = torch.randn((n, 100), generator=g, device="cuda")
    src = torch.randint(0, n, (G["chunk"],), generator=g, device="cuda", dtype=torch.int32)
    dst = torch.randint(0, n, (G["chunk"],), generator=g, device="cuda", dtype=torch.int32)
    scat["ogb_products edge chunk"] = scatter_check(h, src, dst, n + 1,
                                                   "one ogb_products edge chunk")
    del h, src, dst
    h = torch.randn((3072, 1433), generator=g, device="cuda")
    e = torch.randint(0, 3072, (2, 10752), generator=g, device="cuda", dtype=torch.int32)
    scat["cora width"] = scatter_check(h, e[0], e[1], 3073, "full_graph_sm's edges (d = 1,433)")
    sizes = [1024, 15360, 153600]
    h2 = torch.randn((sizes[2], 602), generator=g, device="cuda")
    ids = torch.arange(sizes[2], device="cuda", dtype=torch.int32)
    seg = ids // 10
    scat["minibatch_lg level 2"] = scatter_check(h2, ids, seg, sizes[1],
                                                 "minibatch_lg's level-2 block (d = 602)")
    h1 = torch.randn((sizes[1], 128), generator=g, device="cuda")
    nb = torch.arange(sizes[1], device="cuda", dtype=torch.int32).reshape(1024, 15)
    nb[torch.rand(nb.shape, generator=g, device="cuda") < 0.1] = -1
    bag_dense_check(h1, nb, "minibatch_lg's level-1 block (h[1], d = 128)")
    del h2, ids, seg, h1, nb
    free_card()

    runs = {}
    # full_graph_sm: a random graph of cora's nodes (avg degree cut to fit
    # the cell's 10,752 padded edges), 20 steps, the loss must fall
    shape = ga.GNN_SHAPES["full_graph_sm"]
    t0 = time.perf_counter()
    graph = smp.random_graph(G["seed"], shape["n_nodes"], G["cora_degree"], shape["d_feat"],
                             shape["n_classes"])
    cell = spec.cell("full_graph_sm")
    params, state = cell.make_args(g, "cuda")[:2]
    inputs = pad_graph(graph, 3072, 10752)
    log(f"[gnn] full_graph_sm: random_graph of {graph.n_nodes:,} nodes, {graph.n_edges:,} edges "
        f"(avg degree {G['cora_degree']}: cora's 10,556 edges pad to the cell's 10,752), "
        f"{shape['d_feat']} features, {shape['n_classes']} classes, drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    runs["full_graph_sm"] = train_cell("full_graph_sm (random_graph at cora's size)", cell,
                                       [params, state] + inputs, G["cora_steps"], want_fall=True)
    # minibatch_lg: the NeighborSampler on a random graph of reddit's nodes
    shape = ga.GNN_SHAPES["minibatch_lg"]
    t0 = time.perf_counter()
    graph = smp.random_graph(G["seed"], shape["n_nodes"], G["reddit_degree"], shape["d_feat"],
                             shape["n_classes"])
    drawn = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler = smp.NeighborSampler(graph, shape["fanouts"], seed=G["seed"])
    seeds = np.random.default_rng(G["seed"]).choice(graph.n_nodes, G["reddit_seeds"],
                                                    replace=False)
    feats, neigh, labels = sampler.sample(seeds)
    sampled = time.perf_counter() - t0
    log(f"[gnn] minibatch_lg: random_graph of {graph.n_nodes:,} nodes and {graph.n_edges:,} "
        f"edges (avg degree cut to {G['reddit_degree']} from the published graph's "
        f"{shape['n_edges'] / shape['n_nodes']:.0f}, so the host draw stays within seconds; "
        f"the blocks' shapes do not change while the degree exceeds the fanouts "
        f"{shape['fanouts']}), drawn in {drawn:.2f} s; NeighborSampler on "
        f"{G['reddit_seeds']} seeds in {sampled:.2f} s: levels "
        f"{[f.shape[0] for f in feats]}, padding {[int((x < 0).sum()) for x in neigh]}")
    del graph
    cell = spec.cell("minibatch_lg")
    params, state = cell.make_args(g, "cuda")[:2]
    fs, ns, ls = pad_blocks(feats, neigh, labels, sizes)
    runs["minibatch_lg"] = train_cell("minibatch_lg (NeighborSampler blocks)", cell,
                                      [params, state, fs, ns, ls], G["steps"])
    del fs, ns, ls, feats, neigh
    for name in ("ogb_products", "molecule"):
        free_card()
        cell = spec.cell(name)
        t0 = time.perf_counter()
        args = cell.make_args(g, "cuda")
        torch.cuda.synchronize()
        log(f"[gnn] {name}: inputs drawn on the card in {time.perf_counter() - t0:.2f} s "
            f"({ga.GNN_SHAPES[name]})")
        runs[name] = train_cell(name, cell, list(args), G["steps"])
        del args
    if runs["minibatch_lg"]["bag"] == 0 or any(r["bwd"] == 0 for r in runs.values()):
        raise AssertionError(f"a GNN cell launched no kernel: {runs}")
    free_card()
    return runs, scat


# -------------------------------------------------------------- LM phase
# qwen3-0.6b's train_4k at full width on one microbatch, qwen2-moe-a2.7b's
# train step at two layers and its serving at full depth in bf16
# moe_held: of an MoE's serving, only the first layer's dispatch and combine of
# the one more decode step are held (each plain version takes 0.25-0.5 s; all
# 96 of them once took ~35 s of the smoke's time)
LM = dict(seed=27, steps=3, serve_batch=4, prompt=4096, cache=32_768, decode=16,
          check_batch=2, tol={"bfloat16": (0.03, 0.1), "float32": (1e-3, 2e-3)},
          tie_eps=1e-4, moe_held=2)


def lm_train(label, cfg, cell):
    """``LM['steps']`` steps of an LM train cell (one microbatch), step 1 run
    twice from one state (the same bits)."""
    g = torch.Generator(device="cuda").manual_seed(LM["seed"])
    t0 = time.perf_counter()
    args = cell.make_args(g, "cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    tokens = args[2].numel()
    keep = {}
    rep = train_cell(label, cell, list(args), LM["steps"], tag="[lm]", keep=keep)
    rep.update(tokens_per_s=tokens / (rep["step_ms"] / 1e3), setup_s=setup,
               n_params=cfg.n_params)
    log(f"[lm] {label}: {cfg.n_params / 1e9:.3f}·10⁹ params ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}"
        + (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k}" if cfg.moe else "")
        + f"), {tokens} tokens a step: {rep['tokens_per_s']:.1f} tokens/s, step "
        f"{rep['step_ms']:.4f} ms, peak {rep['peak_gib']:.2f} GiB, set-up {setup:.2f} s")
    del args
    free_card()
    seen = []
    for k, what in (("wide", "the launch with the most distinct rows"),
                    ("run", "the launch with the longest run")):
        if k in keep and not any(keep[k][1] is a for a in seen):
            seen.append(keep[k][1])
            rep[k] = bwd_at_call(f"{label}: {what}", *keep[k][1], "[lm]")
    del keep, seen
    return rep


def logit_stats(got, want, tol):
    """(max |Δ|, the share of rows whose every logit lies within |Δ| ≤ atol
    + rtol·|want|, the share of rows whose argmax agrees)."""
    rtol, atol = tol
    d = (got - want).abs()
    ok = (d <= atol + rtol * want.abs()).reshape(-1, d.shape[-1]).all(-1)
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean()
    return float(d.max()), float(ok.float().mean()), float(agree)


@contextlib.contextmanager
def routes_of(moe):
    """Record every MoE router call inside the block: a list of (probs [T,
    E] f32, expert ids [T, k]), one a layer a call, in call order."""
    real, calls = moe.route, []

    def recorded(x, router, cfg):
        probs, gate, expert = real(x, router, cfg)
        calls.append((probs.detach(), expert))
        return probs, gate, expert

    moe.route = recorded
    try:
        yield calls
    finally:
        moe.route = real


def first_flips(dec_routes, fwd_routes, n_layers, B, P, D, mcfg):
    """({batch row: its first (decode step, layer) whose expert ids differ
    from forward's at that position, with forward's gap between its k-th and
    (k+1)-th router probability there}, the router's numbers: forward's gaps
    over every decode position and layer (min, median), and the largest
    |Δ probability| between the two paths' routers on the rows before each
    batch row's flip). Raises where a flip's gap is not below
    ``LM['tie_eps']``: only a near-tie may flip. ({}, {}) for a dense model."""
    if mcfg is None:
        return {}, {}
    k, S = mcfg.top_k, P + D
    flips, gaps, dev = {}, [], 0.0
    for b in range(B):
        for i in range(D):
            for layer in range(n_layers):
                dp, de = dec_routes[i * n_layers + layer]
                fp, fe = fwd_routes[layer]
                row = b * S + P + i
                p = torch.sort(fp[row], descending=True).values
                gap = float(p[k - 1] - p[k])
                gaps.append(gap)
                if b in flips:
                    continue
                if torch.equal(torch.sort(de[b]).values, torch.sort(fe[row]).values):
                    dev = max(dev, float((dp[b] - fp[row]).abs().max()))
                    continue
                flips[b] = dict(step=i, layer=layer, gap=gap,
                                experts=(torch.sort(de[b]).values.tolist(),
                                         torch.sort(fe[row]).values.tolist()))
    stats = dict(gap_min=min(gaps), gap_median=float(np.median(gaps)), held_router_dev=dev)
    bad = {b: f for b, f in flips.items() if not f["gap"] < LM["tie_eps"]}
    if bad:
        raise AssertionError(f"router flips that are no near-tie (gap ≥ {LM['tie_eps']}): "
                             f"{bad}; {stats}")
    return flips, stats


def lm_serve(cfg, label, check_dtype):
    """``cfg`` at full depth in bf16: one 4,096-token chunked-prefill step at
    B = 4 into a 32,768-position cache, then 16 decode steps (the timed
    path); then one more decode step and ``prefill`` of the prompt with
    every row-gradient launch held against its plain version
    (``held_bwd``). Then the check, in ``check_dtype``, on the prompt's
    first ``LM['check_batch']`` rows (the f32 weights of qwen2-moe take 57
    GB) and a cache of the 4,112 positions it fills: the chunk's logits
    against ``prefill``'s and the decode logits against ``forward``'s over
    the whole sequence, within ``LM['tol']`` of its dtype. An MoE is checked
    in f32 (weights drawn again in f32): in bf16 its rows disagree wherever
    rounding flips a near-tie of a router's top-k (near-uniform routers of
    random weights), which sends a token to another expert; the bf16 path's
    argmax agreement is printed. In f32 such a flip is rare but was seen
    once in 768 decode routings, and the decode rows from it on part from
    forward's: so each batch row's first decode routing that differs from
    forward's must be a near-tie there (``first_flips``), and every decode
    row before it, and every row of a batch row with none, is held to the
    tolerance. The check runs an MoE at capacity factor E/k (15) on both
    sides: an expert's capacity is then at least the step's tokens, so no
    pair drops (at 4, random routers load some experts past it, and
    ``forward``, whose token order puts the second row's decode positions
    last, drops pairs the decode steps keep)."""
    import dataclasses
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.models import moe, transformer as tf
    L = LM
    g = torch.Generator(device="cuda").manual_seed(L["seed"] + 1)
    free_card()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, g, "cuda", cfg.dtype)
    cache = tf.init_kv_cache(cfg, L["serve_batch"], L["cache"], device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    B, P, D = L["serve_batch"], L["prompt"], L["decode"]
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device="cuda",
                           dtype=torch.int32)
    bag0, bwd0 = ops.launches, ops.bwd_launches
    # ---- the main path: chunked prefill, then decode ----
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    nxt, chunk_logits, cache = tf.serve_step(cfg, params, prompt, cache, 0)
    b.record()
    b.synchronize()
    prefill_ms = a.elapsed_time(b)
    cur, times = nxt, []
    for i in range(D):
        a.record()
        cur, logits, cache = tf.decode_step(cfg, params, cur, cache, P + i)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    launches = (ops.launches - bag0, ops.bwd_launches - bwd0)
    # ---- end of the main path ----
    peak = peak_gib()
    decode_ms = float(np.sum(times))
    if not torch.isfinite(chunk_logits).all() or not torch.isfinite(logits).all():
        raise AssertionError(f"{label} serving: non-finite logits")
    cache_gb = 2 * cache["k"].numel() * cache["k"].element_size() / 1e9
    is_moe = cfg.moe is not None                  # an MoE holds LM["moe_held"] launches
    with held_bwd(first=L["moe_held"] if is_moe else None) as held_decode:
        tf.decode_step(cfg, params, cur, cache, P + D)    # one more decode step, held
    del cache, logits
    with held_bwd(first=0 if is_moe else None) as held_prefill:
        want, _ = tf.prefill(cfg, params, prompt, max_len=P)   # the prompt at the chunk's shapes
    bf16_agree = float((chunk_logits.argmax(-1) == want.argmax(-1)).float().mean())
    del want
    log(f"[lm] {label} serving at full depth in bf16 ({cfg.n_params / 1e9:.3f}·10⁹ params, "
        f"{sum(x.numel() * x.element_size() for x in tf.leaves(params)) / 1e9:.2f} GB; "
        f"cache {B} × {L['cache']:,} positions, {cache_gb:.2f} GB; set-up {setup:.2f} s): a "
        f"{P:,}-token chunked-prefill step at B = {B} {prefill_ms:.4f} ms "
        f"({B * P / prefill_ms * 1e3:.1f} tokens/s), {D} decode steps {decode_ms:.4f} ms "
        f"({B * D / decode_ms * 1e3:.1f} tokens/s, median step "
        f"{float(np.median(times)):.4f} ms), peak {peak:.2f} GiB; the chunk's argmax agrees "
        f"with prefill's on {bf16_agree:.4f} of the rows; launches embedding_bag="
        f"{launches[0]} embedding_bag_bwd={launches[1]}; held: prefill at B = {B}: "
        + ("not held (cut: the decode step's first layer holds the MoE's kernel)" if is_moe
           else held_line(held_prefill))
        + f"; one more decode step: {held_line(held_decode)}"
        + (f" (cut to layer 0's dispatch and combine, LM['moe_held'])" if is_moe else ""))

    # ---- the check, in check_dtype ----
    c = dataclasses.replace(cfg, dtype=check_dtype)
    if c.moe is not None:
        # C = ceil(T·k/E)·E/k ≥ T: no expert can overflow, so no pair drops
        cf = c.moe.n_experts / c.moe.top_k
        c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=cf))
    if check_dtype != cfg.dtype:
        del params
        free_card()
        params = tf.init_params(c, g, "cuda", check_dtype)
    tol = L["tol"][str(check_dtype).replace("torch.", "")]
    Bc = L["check_batch"]
    pc = prompt[:Bc]
    cache = tf.init_kv_cache(c, Bc, P + D, device="cuda")
    _, first, cache = tf.serve_step(c, params, pc, cache, 0)
    want, _ = tf.prefill(c, params, pc, max_len=P)
    pre = logit_stats(first, want, tol)
    del want
    seq, cur, got = [pc], first.argmax(-1).to(torch.int32)[:, None], []
    with routes_of(moe) as dec_routes:
        for i in range(D):
            seq.append(cur)
            nxt, step_logits, cache = tf.decode_step(c, params, cur, cache, P + i)
            got.append(step_logits)
            cur = nxt
    del cache
    with torch.no_grad(), routes_of(moe) as fwd_routes:
        x, head, _ = tf.forward(c, params, torch.cat(seq, dim=1))
        ref = x[:, P:].to(torch.float32) @ head.to(torch.float32)
    got = torch.stack(got, dim=1)
    dec = logit_stats(got, ref, tol)
    # an MoE's decode row may part from forward's after a router near-tie
    # flips (the two paths' GEMMs differ in shape): each batch row's first
    # decode step whose expert ids differ from forward's at that position
    # must be a near-tie in forward's router, and the rows before it are held
    flips, router = first_flips(dec_routes, fwd_routes, c.n_layers, Bc, P, D, c.moe)
    held = torch.ones((Bc, D), dtype=torch.bool, device="cuda")
    for b_, f in flips.items():
        held[b_, f["step"]:] = False
    rtol, atol = tol
    ok = ((got - ref).abs() <= atol + rtol * ref.abs()).all(-1)
    n_held, n_ok = int(held.sum()), int((ok & held).sum())
    del params, x, head, ref, got, dec_routes, fwd_routes
    free_card()
    log(f"[lm] {label} checked in {str(check_dtype).replace('torch.', '')} at full depth"
        + ("" if c.moe is None else f", capacity factor {c.moe.capacity_factor} (no drops)")
        + ": the "
        f"chunk's logits vs prefill's: max |Δ| {pre[0]:.4g}, argmax agrees on {pre[2]:.4f}; "
        f"decode vs forward ({D} steps × B = {Bc}): max |Δ| {dec[0]:.4g}, argmax agrees on "
        f"{dec[2]:.4f}; within |Δ| ≤ {tol[1]} + {tol[0]}·|logit|: chunk {pre[1]:.4f} of the "
        f"rows (must be 1), decode {n_ok} of the {n_held} held rows (must be all)"
        + ("" if c.moe is None else
           f"; router flips against forward's (batch row: step, layer, forward's gap between "
           f"its top-{c.moe.top_k} and next probability, which must be below "
           f"{L['tie_eps']}): {flips or 'none'}; forward's gaps over the {D} decode "
           f"positions × {c.n_layers} layers: min {router['gap_min']:.3g}, median "
           f"{router['gap_median']:.3g}; the routers' largest |Δ probability| on the held "
           f"rows {router['held_router_dev']:.3g}"))
    if pre[1] < 1.0 or n_ok < n_held:
        raise AssertionError(f"{label}: chunked prefill / decode disagree with prefill / "
                             f"forward: {pre}, {dec}, {n_ok} of {n_held} held decode rows")
    return dict(prefill_ms=prefill_ms, decode_ms=decode_ms,
                prefill_tokens_per_s=B * P / prefill_ms * 1e3,
                decode_tokens_per_s=B * D / decode_ms * 1e3, peak_gib=peak,
                bf16_prefill_argmax_agrees=bf16_agree, prefill_vs_chunk=pre,
                decode_vs_forward=dec, decode_rows_held=n_held, router_flips=flips,
                router=router,
                bag=launches[0], bwd=launches[1],
                held=len(held_prefill) + len(held_decode))


def lm_phase():
    """The LM/MoE slice on the card: qwen3-0.6b's train_4k at full width on
    one microbatch of 2 × 4,096 (remat on), qwen2-moe-a2.7b's train step at
    full width cut to 2 layers; then serving at full depth in bf16, the
    dense qwen3-0.6b and qwen2-moe-a2.7b (``lm_serve``)."""
    import dataclasses
    from repro_torch.configs import base, lm_archs as la
    runs = {}
    cell = la.specs()["qwen3-0.6b"].cell("train_4k").one_rank_cut()
    runs["qwen3-0.6b train_4k"] = lm_train(f"qwen3-0.6b train_4k, {cell.reduced}",
                                           la.QWEN3_0_6B, cell)
    cfg = dataclasses.replace(la.QWEN2_MOE, n_layers=2)
    cell = base.build_lm_cell(cfg, "train_4k", None, micro_per_device=1, batch=1)
    runs["qwen2-moe-a2.7b train_4k (2 layers)"] = lm_train(
        "qwen2-moe-a2.7b train_4k at 2 of 24 layers, one sequence of 4,096", cfg, cell)
    runs["qwen3-0.6b serving"] = lm_serve(la.QWEN3_0_6B, "qwen3-0.6b", torch.bfloat16)
    runs["qwen2-moe-a2.7b serving"] = lm_serve(la.QWEN2_MOE, "qwen2-moe-a2.7b", torch.float32)
    if any(r["bwd"] == 0 for r in runs.values() if r is not runs["qwen3-0.6b serving"]):
        raise AssertionError(f"an LM path launched no row-gradient kernel: {runs}")
    return runs


# ------------------------------------------------------------ dry run phase
# python -m repro_torch.launch.dryrun over every cell at both production
# meshes, each cell's one-rank step on this card; the cells earlier phases
# ran must be ok, the rest ok or out of memory (xdeepfm's CIN at its
# batches, minicpm-2b's train_4k); the budget: 87.4–113.5 s in runs with
# the GNN and LM cells (one timed step for an LM train or prefill cell,
# three for the rest: 90.1 s), on an H100 80GB HBM3 at 700 W
DRYRUN = dict(budget_s=120, timeout_s=600,
              must_ok=[("dlrm-mlperf", s) for s in ("train_batch", "serve_p99", "serve_bulk",
                                                    "retrieval_cand")]
              + [(a, "serve_p99") for a in ("xdeepfm", "din", "autoint")]
              + [("din", "train_batch"), ("autoint", "train_batch")]
              + [("graphsage-reddit", s) for s in ("full_graph_sm", "minibatch_lg",
                                                   "ogb_products", "molecule")]
              + [("smollm-135m", "train_4k"), ("qwen3-0.6b", "train_4k")],
              step_ratio=(0.5, 2.0))


def src_env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def dryrun_phase(dlrm_step_ms):
    """``python -m repro_torch.launch.dryrun --all --both-meshes --json``, then
    ``--shard-table --json``, in subprocesses (the parent holds no table by
    now). Holds the records to their contract, prints each one-rank step's
    ms, live GiB, roofline share and bottleneck, and returns the
    ``embedding_bag`` and ``embedding_bag_bwd`` launches of those steps."""
    from repro_torch.configs import all_specs

    specs = all_specs()
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    proc = subprocess.run(cmd + ["--all", "--both-meshes", "--json"], capture_output=True,
                          text=True, timeout=DRYRUN["timeout_s"], env=src_env(), cwd=ROOT)
    if proc.returncode:
        raise AssertionError(f"launch.dryrun --all failed (rc={proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    recs = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke_dryrun.jsonl"), "w") as f:
        f.write("\n".join(json.dumps(r) for r in recs) + "\n")
    one = {}
    for r in recs:
        key = (r["arch"], r["shape"])
        if r["shape"] in specs[r["arch"]].skip:
            if r["status"] != "skip":
                raise AssertionError(f"{key}: JAX skips this cell, got {r}")
            continue
        if r["status"] != "ok":
            raise AssertionError(f"{key} [{r['mesh']}]: {r['status']}: {r.get('error')}")
        one[key] = r["one_rank"]
        if r["arch"] == "peacock-lda" and r["one_rank"].get("fits_80gb_hbm") is not False:
            raise AssertionError(f"{key}: one rank's arguments must not fit 80 GB")
    meshes = {(r["arch"], r["shape"], r["mesh"]) for r in recs}
    for shape in ("train_segment", "train_segment_opt", "serve_rt"):
        for m in ("16x16", "2x16x16"):
            if ("peacock-lda", shape, m) not in meshes:
                raise AssertionError(f"peacock-lda/{shape} has no record at {m}")
    launches = {"embedding_bag": 0, "embedding_bag_bwd": 0}
    by_family = {}
    for key, o in sorted(one.items()):
        if o["status"] == "not_run":
            if key in DRYRUN["must_ok"] or o["arguments_bytes"] < 80e9:
                raise AssertionError(f"{key}: not run at one rank: {o}")
            log(f"[dryrun] {key[0]}/{key[1]}: not run at one rank ({o['reason']}); "
                f"arguments {o['arguments_bytes'] / 1e9:.2f} GB")
            continue
        oom = o["status"] == "fail" and "OutOfMemoryError" in o.get("error", "")
        if o["status"] != "ok" and (key in DRYRUN["must_ok"] or not oom):
            raise AssertionError(f"{key}: one-rank step {o['status']}: {o.get('error')}")
        if oom:
            log(f"[dryrun] {key[0]}/{key[1]}: one rank runs out of memory "
                f"(arguments {o['arguments_bytes'] / 1e9:.2f} GB): {o['error'][:160]}")
            continue
        if o["live_bytes_per_device"] < o["arguments_bytes"]:
            raise AssertionError(f"{key}: live bytes {o['live_bytes_per_device']} below its "
                                 f"arguments' {o['arguments_bytes']}")
        fam = by_family.setdefault(specs[key[0]].family, dict.fromkeys(launches, 0))
        for k in launches:
            launches[k] += o["launches"][k]
            fam[k] += o["launches"][k]
        kern = ", ".join(f"{k} {v['calls']:.0f}x {v['bytes'] / 1e6:.1f} MB"
                         for k, v in o["cost"]["kernels"].items())
        log(f"[dryrun] {key[0]}/{key[1]}"
            + (f" ({o['reduced']})" if o.get("reduced") else "")
            + f": one-rank step {o['step_ms']:.4f} ms"
            + (" (timed on its counted warm-up step)" if o.get("timed_on_counted_step") else "")
            + ", live "
            f"{o['live_bytes_per_device'] / 2**30:.2f} GiB (arguments "
            f"{o['arguments_bytes'] / 2**30:.2f} GiB), counted {o['cost']['flops'] / 1e9:.3f} "
            f"GFLOP, {o['cost']['bytes'] / 1e9:.3f} GB in and out of its ops, "
            f"{o['cost']['moved_bytes'] / 1e9:.3f} GB moved ({kern or 'no kernel'}), useful "
            f"flops ratio {o['useful_flops_ratio'] or 0:.4f}, roofline share "
            f"{o['roofline_share']:.4f} ({o['bottleneck']}) on {o['card']}")
    ratio = one[("dlrm-mlperf", "train_batch")]["step_ms"] / dlrm_step_ms
    lo, hi = DRYRUN["step_ratio"]
    log(f"[dryrun] dlrm-mlperf/train_batch: {ratio:.3f}x recsys_train_phase's step "
        f"({dlrm_step_ms:.4f} ms)")
    if not lo <= ratio <= hi:
        raise AssertionError(f"dlrm-mlperf's one-rank step is {ratio:.3f}x the train phase's")
    if not launches["embedding_bag"] or not launches["embedding_bag_bwd"]:
        raise AssertionError(f"the one-rank steps launched no kernel: {launches}")
    table = subprocess.run(cmd + ["--shard-table", "--json"], capture_output=True, text=True,
                           timeout=120, env=src_env(), cwd=ROOT, check=True)
    rows = json.loads(table.stdout)["shard_table"]["rows"]
    for r in rows:
        log(f"[dryrun] shard table P={r['model_shards']:.0f}: "
            f"{r['hbm_bytes_per_device'] / 1e9:.1f} GB a card, fits 80 GB: {r['fits_80gb_hbm']}")
    if rows[0]["fits_80gb_hbm"] or not rows[1]["fits_80gb_hbm"]:
        raise AssertionError("the shard table must not fit P = 1 and must fit P = 2")
    spent = time.perf_counter() - t0
    log(f"[dryrun] {len(recs)} records, {len(one)} cells; {spent:.1f} s (budget "
        f"{DRYRUN['budget_s']} s{'' if spent <= DRYRUN['budget_s'] else ', OVER'}); launches "
        f"of the one-rank steps by family: {by_family}")
    for fam in ("gnn", "lm"):
        if not by_family.get(fam, {}).get("embedding_bag_bwd"):
            raise AssertionError(f"the {fam} cells' one-rank steps launched no row-gradient "
                                 f"kernel: {by_family}")
    return launches, by_family


# ------------------------------------------------------------ preflight phase
# the launch gate on this card, right after the kernel phases: the built
# kernels' own registers, shared memory and spills (every instantiation their
# launches can reach) with the plans at the shapes this run launches; then the
# three launchers' gates, each launcher's main called in one process of their
# own (``start_preflight_gates``), one after the other, while the card runs
# the dry run; timeout_s bounds the wait for it
PREFLIGHT = dict(budget_s=30, timeout_s=600,
                 gates={"launch.train --preflight": ("train", ["--preflight"], 0),
                        "launch.serve --preflight": ("serve", ["--preflight"], 0),
                        "launch.dryrun --verify": ("dryrun", ["--verify"], 0),
                        "launch.train --preflight, 430 GB a rank": (
                            "train", ["--preflight", "--topics", "100000", "--vocab", "1000000"],
                            1)})


def smoke_plans():
    """The plans of this run's largest launches: the trainer's and stream
    cell's packages (10,000 tokens at K = 100,000), the synthetic 32,768 ×
    100,000 word table in one build, the MH probe's three kernels (pair caps
    16, 32 and 64), dlrm-mlperf's bulk and serve_p99 bags and its train
    gather's gradient (bags of one id, 128 bf16 columns)."""
    from repro_torch.kernels.alias import kernel as ak
    from repro_torch.kernels.embedding_bag import kernel as ek
    from repro_torch.kernels.gibbs import kernel as gk
    K, T = FULL["n_topics"], TRAINER["max_package"]
    plans = [gk.gibbs_argmax_plan(T, K), ak.alias_build_plan(32_768, K)]
    plans += [ak.mh_resample_plan(T, K, cap, ALIAS["n_mh"]) for cap in (16, 32, 64)]
    plans += [ek.bag_plan(128, 1, B, 26, True, 0) for B in (RECSYS["bulk_batch"],
                                                             RECSYS["p99_batch"])]
    plans += ek.bwd_plans(1, 128, 1, ek.bwd_vec(128, 2, 0), ek.bwd_copy(128, 2, 0), 0)
    return plans


def preflight_phase():
    """[preflight]: every kernel instantiation as built for this card
    (``repro_torch.analysis.smem``: regs, static and dynamic shared bytes,
    spills, blocks an SM, binaryVersion), held to sm_90's limits, and the
    plans of this run's largest launches (each instantiation among the
    built ones, its int arguments within int32)."""
    from repro_torch.analysis import smem
    t0 = time.perf_counter()
    attrs = smem.card_attributes()
    card = card_line()
    for a in attrs:
        log(f"[preflight] {smem.attribute_line(a)}; card {card}")
    plans = smoke_plans()
    findings = smem.check_plans(plans) + smem.check_attributes(attrs, plans)
    bad = [f for f in findings if f.severity == "error"]
    if bad:
        raise AssertionError("[preflight] sm_90 limits:\n" + "\n".join(f.message for f in bad))
    for f in findings:
        if f.severity == "warning":
            log(f"[preflight] warning: {f.message}")
    built = {(a["library"], a["kernel"]): a for a in attrs}
    for p in plans:
        a = built[(p.library, p.kernel)]
        log(f"[preflight] plan {p.kernel}: {a['threads']} threads, {a['dynamic_smem']:,} "
            f"dynamic shared bytes, {a['blocks_per_sm']} blocks/SM, int arguments "
            f"{dict(p.int_args)}")
    if any(a["binary_version"] != 90 for a in attrs):
        raise AssertionError("[preflight] a kernel is not built for sm_90a")
    log(f"[preflight] {len(attrs)} kernel instantiations built for sm_90a within its register "
        f"and shared-memory limits ({sum(a['local_bytes'] > 0 for a in attrs)} spill); "
        f"{len(plans)} plans of this run's launches fit ({time.perf_counter() - t0:.1f} s)")


def preflight_gates():
    """[preflight] gates: ``launch.train --preflight``, ``launch.serve
    --preflight`` and ``launch.dryrun --verify`` (exit 0), and the train gate
    on a 430 GB-a-rank session (exit 1), each ``repro_torch.launch.<name>
    .main`` called here with its report captured; each gate's seconds and
    their sum against the budget. ``start_preflight_gates`` runs it in a
    process of its own beside the dry run."""
    import contextlib
    import importlib
    import io
    t0 = time.perf_counter()
    for name, (module, argv, want) in PREFLIGHT["gates"].items():
        main = importlib.import_module(f"repro_torch.launch.{module}").main
        out, t = io.StringIO(), time.perf_counter()
        with contextlib.redirect_stdout(out):
            try:
                code = main(argv)
            except SystemExit as exc:
                code = exc.code
        text = out.getvalue()
        passes = [ln.split()[1:4] for ln in text.splitlines() if ln.startswith("[preflight] ")
                  and ln.split()[1] in ("PASS", "FAIL")]
        log(f"[preflight] {name}: exit {code} (want {want}) in {time.perf_counter() - t:.1f} s; "
            "passes " + ", ".join(f"{p[1]} {p[0]} {p[2]}" for p in passes))
        if code != want:
            raise AssertionError(f"[preflight] {name} exited {code}, want {want}:\n{text[-4000:]}")
    spent = time.perf_counter() - t0
    log(f"[preflight] {len(PREFLIGHT['gates'])} gates in {spent:.1f} s (budget "
        f"{PREFLIGHT['budget_s']} s{'' if spent <= PREFLIGHT['budget_s'] else ', OVER'})")


def start_preflight_gates():
    """``preflight_gates`` in a process of its own at the lowest CPU
    priority: its gates run on the host (gloo CPU ranks, the analyzers), so
    they take the cores the dry run leaves idle. Returns the process;
    ``finish_preflight_gates`` prints its lines and raises if it failed."""
    src = os.path.join(ROOT, "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    return subprocess.Popen([sys.executable, "-c", "import chip_smoke; chip_smoke.preflight_gates()"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, preexec_fn=lambda: os.nice(19))


def finish_preflight_gates(proc):
    try:
        out, _ = proc.communicate(timeout=PREFLIGHT["timeout_s"])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for line in out.splitlines():
        log(line)
    if proc.returncode:
        raise AssertionError(f"[preflight] the gates' process exited {proc.returncode}")


# ------------------------------------------------------------ examples phase
# the torch twins of the examples, each its own process on this card, all at
# once; each must exit 0 and launch its path's kernels
EXAMPLES = dict(budget_s=60, timeout_s=600,
                kernels={"serve_topics": ("gibbs_argmax",), "live_refresh": ("gibbs_argmax",),
                         "out_of_core": ("gibbs_argmax",), "fleet_demo": ("gibbs_argmax",),
                         "big_model": ("alias_build", "mh_resample"),
                         "lm_train": ("embedding_bag_bwd",)})


def examples_phase():
    """Run ``examples/<name>_torch.py`` of each twin on the card, in parallel;
    returns each one's kernel launches (its ``[launches]`` line)."""
    import tempfile

    t0 = time.perf_counter()
    procs = {}
    for name in EXAMPLES["kernels"]:
        path = os.path.join(ROOT, "examples", f"{name}_torch.py")
        sink = tempfile.TemporaryFile(mode="w+")
        procs[name] = (sink, subprocess.Popen([sys.executable, path], stdout=sink,
                                              stderr=subprocess.STDOUT, text=True,
                                              env=src_env(), cwd=ROOT))
    secs = {}
    while len(secs) < len(procs):           # each one's own seconds
        for name, (_, proc) in procs.items():
            if name not in secs and proc.poll() is not None:
                secs[name] = time.perf_counter() - t0
        if time.perf_counter() - t0 > EXAMPLES["timeout_s"]:
            for name, (_, proc) in procs.items():
                if name not in secs:
                    proc.kill()
                    proc.wait()
                    secs[name] = time.perf_counter() - t0
        time.sleep(0.05)
    out, failed = {}, []
    for name, (sink, proc) in procs.items():
        sink.seek(0)
        text = sink.read()
        sink.close()
        lines = [ln for ln in text.splitlines() if ln.startswith("[launches] ")]
        if proc.returncode or not lines:
            failed.append(f"{name}_torch.py rc={proc.returncode}:\n{text[-2500:]}")
            continue
        out[name] = json.loads(lines[-1][len("[launches] "):])
        missing = [k for k in EXAMPLES["kernels"][name] if not out[name][k]]
        if missing:
            failed.append(f"{name}_torch.py launched no {missing}: {out[name]}")
        log(f"[examples] {name}_torch.py: exit 0 in {secs[name]:.1f} s; launches "
            + ", ".join(f"{k} {v}" for k, v in out[name].items() if v))
    if failed:
        raise AssertionError("\n".join(failed))
    spent = time.perf_counter() - t0
    log(f"[examples] {len(procs)} twins in {spent:.1f} s (budget {EXAMPLES['budget_s']} s"
        f"{'' if spent <= EXAMPLES['budget_s'] else ', OVER'})")
    return out


# ------------------------------------------------------------ serving phases
# RT-LDA serving through the port's engine and fleet at peacock-lda's width
# (FULL's K and V): the model is launch.serve's own (quick_train: the dense
# sampler, so gibbs_argmax, then build_model), the swap target the model of
# Φ + 1, built in place so no second Φ exists; quick_train runs 5 of
# launch.serve's 25 iterations (depth: six models are built, and the served
# batch's time does not depend on how far Φ was trained)
SERVE = dict(buckets=(8, 16, 32, 64), batch=256, n_trials=2, train_iters=5, per_bucket=24,
             over_long=6, swap_rows=16, profile_rows=(1, 256), profile_reps=5,
             duration=3, deadline_ms=50, burst=4096, cache_mb=64, zipf_pool=512, replicas=2)
# launch.serve's open-loop runs: name → (offered queries/s, fleet flags); the
# 500 and 1,000 queries/s runs sit below the capacity that serve_capacity
# measures, the 2,000 queries/s ones above it (overload points)
SERVE_RUNS = {"engine_500": (500, None), "engine": (1000, None), "fleet": (1000, "--shed"),
              "engine_overload": (2000, None), "fleet_overload": (2000, "--no-shed")}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance_ms(self, ms):
        self.t += ms / 1e3


def same_response(r, pkd, ids, w, label):
    """A served row against the function's row: ``pkd`` bit for bit; ids and
    weights bit for bit, or else (the Eq. 5 GEMM on another stream) ids equal
    but at tied weights and weights within rtol 1e-6. Returns which held."""
    if r.pkd.dtype != np.float32 or not np.array_equal(r.pkd, pkd):
        raise AssertionError(f"{label}: pkd differs from the function's "
                             f"(max |d| {float(np.abs(r.pkd - pkd).max())})")
    if np.array_equal(r.feature_ids, ids) and np.array_equal(r.feature_weights, w):
        return "bitwise"
    if not np.allclose(r.feature_weights, w, rtol=1e-6, atol=0):
        raise AssertionError(f"{label}: feature weights differ beyond rtol 1e-6")
    at = dict(zip(ids.tolist(), w.tolist()))
    for i in np.flatnonzero(r.feature_ids != ids):
        ref = at.get(int(r.feature_ids[i]), float(w[-1]))
        if not np.isclose(w[i], ref, rtol=1e-6, atol=0):
            raise AssertionError(f"{label}: feature id {r.feature_ids[i]} at {i} is no tie")
    return "pkd bitwise, ids equal but at ties, weights within rtol 1e-6"


def chunk_lengths(n, widest):
    """An over-long query's chunks: the widest bucket's length, then the rest."""
    return [min(widest, n - i) for i in range(0, n, widest)]


def engine_rows(eng, submitted):
    """The (bucket, row) slots each submitted query takes in the engine's
    bucket FIFOs (one batch a bucket: each holds at most max_batch rows); an
    over-long query with chunking on takes one slot per widest-bucket chunk,
    each chunk in the bucket of its own length."""
    from repro_torch.core.rtlda import select_bucket
    pos = {b: 0 for b in eng.buckets}
    out = []
    for toks in submitted:
        if eng.chunk_long and len(toks) > eng.buckets[-1]:
            lengths = chunk_lengths(len(toks), eng.buckets[-1])
        else:
            lengths = [len(toks)]
        slots = []
        for n in lengths:
            b, _ = select_bucket(n, eng.buckets)
            slots.append((b, pos[b]))
            pos[b] += 1
        out.append(slots)
    if max(pos.values()) > eng.max_batch:
        raise AssertionError("a bucket holds more than one batch")
    return out


def fold_ref(rows, lengths):
    """An over-long query's answer from its chunks' rows ``(pkd, ids,
    weights)``, from the definition: P(k|d) is the token-count-weighted mean
    of the chunks' pkd (f64, renormalised); each feature id's weight is summed
    over the chunks, each term times its chunk's weight, and the top-n are
    taken by weight, then id."""
    w = np.asarray(lengths, np.float64)
    w = w / w.sum()
    pkd = np.zeros(rows[0][0].shape, np.float64)
    for wc, (p, _, _) in zip(w, rows):
        pkd = pkd + wc * p.astype(np.float64)
    pkd = pkd / pkd.sum()
    ids = np.concatenate([i for _, i, _ in rows])
    terms = np.concatenate([wc * f.astype(np.float64) for wc, (_, _, f) in zip(w, rows)])
    keep = ids >= 0
    uniq, inv = np.unique(ids[keep], return_inverse=True)
    summed = np.zeros(len(uniq))
    np.add.at(summed, inv, terms[keep])
    order = np.lexsort((uniq, -summed))[:rows[0][1].shape[0]]
    top_ids = np.full(rows[0][1].shape, -1, np.int32)
    top_w = np.zeros(rows[0][1].shape, np.float32)
    top_ids[:len(order)], top_w[:len(order)] = uniq[order], summed[order]
    return pkd.astype(np.float32), top_ids, top_w


def check_engine(eng, submitted, futs, calls, fn, model, label):
    """Each response of ``eng`` (one pump, one batch a bucket, recorded in
    ``calls``) against ``fn`` on the same padded batch and seed; a chunked
    query against ``fold_ref`` of the function's rows."""
    direct = {}
    for q, seed in calls:
        if q.shape[1] in direct:
            raise AssertionError(f"{label}: two batches in bucket {q.shape[1]}")
        direct[q.shape[1]] = [x.cpu().numpy() for x in fn(model, q, seed)]
    modes = {}
    for toks, fut, slots in zip(submitted, futs, engine_rows(eng, submitted)):
        r = fut.result(timeout=60)
        if len(slots) == 1:
            (b, i), = slots
            pkd, ids, w = (x[i] for x in direct[b])
            mode = same_response(r, pkd, ids, w, f"{label} bucket {b}")
        else:
            pkd, ids, w = fold_ref([[x[i] for x in direct[b]] for b, i in slots],
                                   chunk_lengths(len(toks), eng.buckets[-1]))
            mode = same_response(r, pkd, ids, w,
                                 f"{label} {len(toks)}-token query in {len(slots)} chunks")
        modes[mode] = modes.get(mode, 0) + 1
    return modes


def serve_engine_phase():
    """Engine against the function at full width, on the card: a
    ``start=False`` engine on a fake clock, pumped once over mixed-length
    queries in every bucket (and over-long ones, chunked; and truncated by a
    second engine with chunking off); each response equals a direct
    ``make_serving_fn`` call on the same padded batch and seed. Then a swap
    to the Φ + 1 model: the next batch equals the function on it, at version
    1. Then where a served batch's time goes, at rows 1 and 256 in bucket 8.
    Returns gibbs_argmax's launches in the model's build."""
    from repro_torch.core import rtlda
    from repro_torch.core.features import make_serving_fn
    from repro_torch.kernels.gibbs import ops
    from repro_torch.launch import serve
    from repro_torch.serving import TopicEngine

    K, V, S = FULL["n_topics"], FULL["vocab"], SERVE
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ops.launches = 0
    with held(ops, "gibbs_argmax", gibbs_check("cuda", "launch.serve quick_train"),
              first_only=True) as seen:
        model, state = serve.build_model(K, V, S["train_iters"], device="cuda")
    torch.cuda.synchronize()
    build_launches = ops.launches
    if not seen:
        raise AssertionError("quick_train's gibbs_argmax was not held")
    phi, beta, alpha = state.phi, state.beta, state.alpha
    del state
    phi += 1
    model_b = rtlda.build_model(phi, beta, alpha, device="cuda")
    del phi
    torch.cuda.synchronize()
    log(f"[serve-engine] K={K} V={V}: launch.serve.build_model (quick_train, "
        f"{build_launches} gibbs_argmax launches; the first held against the plain "
        f"version: {seen[0]}) and the Φ + 1 model in "
        f"{time.perf_counter() - t0:.2f} s; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB")
    if build_launches == 0:
        raise AssertionError("launch.serve.build_model launched no gibbs_argmax")

    fn = make_serving_fn(n_iters=5, n_trials=S["n_trials"], top_n=30, device="cuda")
    rng = np.random.default_rng(5)
    lo = 1
    queries = []
    for b in S["buckets"]:
        queries += [rng.integers(0, V, size=int(n)) for n in rng.integers(lo, b + 1,
                                                                            S["per_bucket"])]
        lo = b + 1
    longs = [rng.integers(0, V, size=int(n)) for n in rng.integers(65, 200, S["over_long"])]

    def run(queries, chunk_long):
        clock = FakeClock()
        eng = TopicEngine(model, buckets=S["buckets"], max_batch=S["batch"],
                          n_trials=S["n_trials"], clock=clock, chunk_long=chunk_long,
                          start=False)
        calls, real = [], eng._infer
        eng._infer = lambda mm, q, seed: calls.append((q.copy(), seed)) or real(mm, q, seed)
        futs = [eng.submit(q) for q in queries]
        if eng.pump() != 0:
            raise AssertionError("the engine flushed before the slack expired")
        clock.advance_ms(eng.max_delay_ms + 1)
        n = eng.pump()
        return eng, futs, calls, n, clock

    eng, futs, calls, n, clock = run(queries + longs, True)
    modes = check_engine(eng, queries + longs, futs, calls, fn, model, "engine")
    trunc_eng, tfuts, tcalls, _, _ = run(longs, False)
    modes_t = check_engine(trunc_eng, longs, tfuts, tcalls, fn, model, "truncating engine")
    if not all(f.result().truncated for f in tfuts) or \
            any(f.result().truncated for f in futs):
        raise AssertionError("truncated flags wrong")
    log(f"[serve-engine] {len(queries)} queries in buckets {S['buckets']} and "
        f"{len(longs)} over-long ones (lengths {sorted(len(q) for q in longs)}), one pump: "
        f"{n} batches of rows {sorted(q.shape for q, _ in calls)}; every response equals "
        f"make_serving_fn on the same padded batch and seed: {modes}; with chunking off "
        f"the over-long ones are truncated to 64 and equal it too: {modes_t}")

    eng.swap_model(model_b)
    calls.clear()
    swap_q = [rng.integers(0, V, size=int(n)) for n in rng.integers(1, 9, S["swap_rows"])]
    sfuts = [eng.submit(q) for q in swap_q]
    clock.advance_ms(eng.max_delay_ms + 1)
    eng.pump()
    modes_s = check_engine(eng, swap_q, sfuts, calls, fn, model_b, "after the swap")
    if {f.result().model_version for f in sfuts} != {1}:
        raise AssertionError("the batch after swap_model does not carry version 1")
    log(f"[serve-engine] swap_model(Φ + 1): the next batch ({len(swap_q)} rows) equals the "
        f"function on the new model: {modes_s}, all at version 1")
    del eng, trunc_eng, futs, tfuts, sfuts, calls, tcalls

    capacity = serve_capacity(model)
    serve_breakdown(model, fn)
    del model, model_b
    gc.collect()
    torch.cuda.empty_cache()
    return build_launches, capacity


def serve_capacity(model):
    """The path's capacity: 4,096 distinct queries of ``launch.serve``'s
    mixed-length traffic submitted at once, with no deadline, to a warmed
    engine and to a warmed fleet of 2 replicas without admission control
    (so every query is served); queries/s from the first submit to the last
    result."""
    from repro_torch.launch import serve
    from repro_torch.serving import Response, TopicEngine, TopicFleet

    S, V = SERVE, FULL["vocab"]
    kw = dict(buckets=S["buckets"], max_batch=S["batch"], n_trials=S["n_trials"])
    make = {"engine": lambda: TopicEngine(model, **kw),
            "fleet": lambda: TopicFleet(model, n_replicas=S["replicas"], cache_mb=S["cache_mb"],
                                        shed=False, deadline_budget_ms=S["deadline_ms"], **kw)}
    traffic = serve.make_traffic(S["burst"], V, S["buckets"], seed=11)
    out = {}
    for name, build in make.items():
        target = build()
        try:
            serve.warm_shape_grid(target, S["buckets"], S["batch"], V)
            if name == "fleet":
                target.cache.clear()
            t0 = time.perf_counter()
            futs = [target.submit(q) for q in traffic]
            res = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
        finally:
            target.close()
        if not all(isinstance(r, Response) and np.isfinite(r.pkd).all() for r in res):
            raise AssertionError(f"capacity {name}: a query was not served, or its pkd "
                                 f"is not finite")
        out[name] = len(res) / wall
        log(f"[serve-capacity] {name}: {len(res)} queries at once in {wall:.3f} s = "
            f"{out[name]:.1f} queries/s")
    return out


def serve_breakdown(model, fn):
    """Where a served batch's time goes, at rows 1 and 256 of bucket 8: a
    ``start=False`` engine on the host clock, the batch run by ``flush_all``;
    host seconds from the first submit to the launch (``_infer`` entered) and
    from the launch to the futures' results, medians of a few batches; then
    one batch under the profiler: device busy time, and the D2H copy of pkd
    ([rows, K] f32) as a share of it."""
    from repro_torch.serving import TopicEngine

    V, S = FULL["vocab"], SERVE
    eng = TopicEngine(model, buckets=(8,), max_batch=max(S["profile_rows"]),
                      n_trials=S["n_trials"], start=False)
    marks, real = {}, eng._infer

    def timed(m, q, seed):
        marks["launch"] = time.perf_counter()
        return real(m, q, seed)

    eng._infer = timed
    rng = np.random.default_rng(9)
    for rows in S["profile_rows"]:
        qs = [rng.integers(0, V, size=8) for _ in range(rows)]

        def batch():
            t0 = time.perf_counter()
            futs = [eng.submit(q) for q in qs]
            eng.flush_all()
            out = [f.result() for f in futs]
            return marks["launch"] - t0, time.perf_counter() - marks["launch"], out

        batch()                                    # warm-up
        runs = [batch()[:2] for _ in range(S["profile_reps"])]
        to_launch = float(np.median([a for a, _ in runs]))
        to_done = float(np.median([b for _, b in runs]))
        rows_prof = device_breakdown(f"engine batch rows {rows} bucket 8", batch, top=6)
        busy = sum(r[0] for r in rows_prof)
        d2h = sum(r[0] for r in rows_prof if "DtoH" in r[2])
        log(f"[serve-breakdown] rows {rows}: host submit → launch {to_launch * 1e3:.3f} ms, "
            f"launch → results {to_done * 1e3:.3f} ms (medians of {S['profile_reps']}); "
            f"device busy {busy:.3f} ms, D2H of pkd ({rows * FULL['n_topics'] * 4 / 1e6:.1f} MB) "
            f"{d2h:.3f} ms = {d2h / busy if busy else 0:.3f} of it")
    eng.close()


def serve_open_loop_phase(capacity):
    """The open loop through the entry point at full width: ``launch.serve.main``
    with one engine (mixed-length all-distinct traffic) and with a fleet of 2
    replicas (a 64 MB cache, Zipf traffic over 512 queries), each for 3 s
    with a mid-run swap: below ``capacity`` the engine at 500 and 1,000
    queries/s and the fleet with admission control at 1,000; above it, at
    2,000, the engine and the fleet without admission control. Each run's
    first ``gibbs_argmax`` launch (its quick_train) is held against the plain
    version. Returns the kernel's launches in each run.

    The swap: no response after it may carry another version than 1, and a
    run must serve some at version 1, except a fleet that sheds every paying
    miss from then on. That fleet is caught as it is built and must end the
    run shedding, its p99 estimate above the level at which it stops
    (ROADMAP §3: under deadlined traffic its p99 rides the deadline, so it
    sheds for good). A fleet fails no request and retries none; the
    shedding one ends with every breaker closed, while the overloaded one
    may end with breakers that its deadline blowouts tripped (printed)."""
    import repro_torch.serving as serving
    from repro_torch.kernels.gibbs import ops
    from repro_torch.launch import serve

    S = SERVE
    out = os.path.join(ROOT, "build", "chip_smoke_serve")
    os.makedirs(out, exist_ok=True)
    base = ["--topics", str(FULL["n_topics"]), "--vocab", str(FULL["vocab"]),
            "--batch", str(S["batch"]), "--buckets", ",".join(map(str, S["buckets"])),
            "--n-trials", str(S["n_trials"]), "--deadline-ms", str(S["deadline_ms"]),
            "--duration", str(S["duration"]), "--swap-mid", "--train-iters", str(S["train_iters"])]
    fleet = ["--replicas", str(S["replicas"]), "--cache-mb", str(S["cache_mb"]),
             "--zipf-pool", str(S["zipf_pool"])]
    fleets, real_fleet = [], serving.TopicFleet

    class CaughtFleet(real_fleet):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            fleets.append(self)

    launches = {}
    for name, (qps, shed) in SERVE_RUNS.items():
        fleets.clear()                 # the last run's fleet holds its model
        gc.collect()
        torch.cuda.empty_cache()
        ops.launches = 0
        argv = base + ["--qps", str(qps), "--bench-out", os.path.join(out, f"{name}.json")]
        argv += fleet + [shed] if shed else []
        serving.TopicFleet = CaughtFleet
        try:
            with held(ops, "gibbs_argmax", gibbs_check("cuda", f"launch.serve {name}"),
                      first_only=True) as seen:
                rec = serve.main(argv)
        finally:
            serving.TopicFleet = real_fleet
        torch.cuda.synchronize()
        launches[name] = ops.launches
        cap = capacity["fleet" if shed else "engine"]
        log(f"[serve-open-loop] {name}: {json.dumps(rec)}")
        log(f"[serve-open-loop] {name}: offered {rec['offered_qps']:.0f} queries/s "
            f"({rec['offered_qps'] / cap:.2f} of the capacity {cap:.1f}) → achieved "
            f"{rec['achieved_qps']:.1f} queries/s, p50 {rec['p50_ms']:.3f} ms, p99 "
            f"{rec['p99_ms']:.3f} ms, miss rate {rec['deadline_miss_rate']:.4f} @ "
            f"{rec['deadline_ms']:.0f} ms, occupancy {rec['mean_batch_occupancy']:.3f}, "
            + (f"per bucket {rec['per_bucket']}" if not shed else
               f"routed {rec['routed']}, cache hit rate {rec['cache_hit_rate']:.4f}, shed rate "
               f"{rec['shed_rate']:.4f} ({rec['shed']} shed, {rec['backed_off']} backed off), "
               f"hedges {rec['hedges']}, probes {rec['probes']}")
            + f", versions after the swap {rec['versions_after_swap']}, peak "
            f"{rec['peak_gib']:.2f} GiB; {launches[name]} gibbs_argmax launches, the first "
            f"held: {seen[0] if seen else None}")
        if launches[name] == 0 or not seen:
            raise AssertionError(f"{name}: launch.serve launched no gibbs_argmax")
        if rec["pkd_sum_err_max"] > 1e-5 or not rec["ids_in_range"]:
            raise AssertionError(f"{name}: a pkd row does not sum to 1 within 1e-5 "
                                 f"({rec['pkd_sum_err_max']}) or an id is outside [0, V)")
        if shed and (rec["failed"] or rec["retries"]):
            raise AssertionError(f"{name}: failed {rec['failed']}, retries {rec['retries']}")
        # the shedding fleet's breakers end closed; without shedding, above
        # the capacity, a replica's deadline blowouts (3 × the deadline) trip
        # its breaker by design
        if shed == "--shed" and any(s != "closed" for s in rec["breakers"]):
            raise AssertionError(f"{name}: breakers {rec['breakers']} at the end")
        after = rec["versions_after_swap"]
        if set(after) - {"1"}:
            raise AssertionError(f"{name}: a response after the swap is not at version 1 "
                                 f"({after})")
        if not after:
            ended = shed == "--shed" and len(fleets) == 1 and ended_shedding(fleets[0])
            if not (ended and rec["shed"] > 0):
                raise AssertionError(f"{name}: no response after the swap carries version 1, "
                                     f"and no shedding fleet explains it")
            log(f"[serve-open-loop] {name}: no paying request served after the swap: the "
                f"fleet ended the run shedding, its p99 estimate {ended[0]:.3f} ms above "
                f"the {ended[1]:.1f} ms at which it stops")
    fleets.clear()
    return launches


def ended_shedding(fleet):
    """``(p99 estimate, the level at which it stops shedding)`` when ``fleet``
    is shedding and its estimate is above that level, else None."""
    st = fleet.stats()
    stop = fleet.deadline_budget_ms * (1 - fleet.shed_hysteresis)
    return (st.p99_est_ms, stop) if st.shedding and st.p99_est_ms >= stop else None


def small_model(device, K=16, V=400, seed=0):
    from repro_torch.core import rtlda
    phi = torch.from_numpy(np.random.default_rng(seed).integers(0, 20, (V, K)).astype(np.int32))
    return rtlda.build_model(phi, torch.tensor(0.01), torch.full((K,), 0.5), device=device)


def serve_publish_phase():
    """Publish → watch → swap on the card at SMALL's width: the small
    ``launch.train`` loop publishes; a card ``TopicFleet`` of 2 (fake clock,
    pumped) with a ``SnapshotWatcher`` a replica reaches the newest version,
    and serves what a CPU fleet serves from the same snapshot (pkd within
    rtol 1e-6, atol 1e-7). Returns gibbs_argmax's launches in the training."""
    import io as io_mod
    import shutil
    from repro_torch.checkpoint import snapshots
    from repro_torch.kernels.gibbs import ops
    from repro_torch.launch import train
    from repro_torch.serving import TopicEngine, TopicFleet

    root = os.path.join(ROOT, "build", "chip_smoke_serve_publish")
    shutil.rmtree(root, ignore_errors=True)
    pub = os.path.join(root, "snap")
    ops.launches = 0
    with contextlib.redirect_stdout(io_mod.StringIO()):
        train.main(["--device", "cuda", "--docs", str(SMALL["n_docs"]), "--vocab",
                    str(SMALL["vocab"]), "--topics", str(SMALL["n_topics"]), "--epochs", "4",
                    "--alpha-opt-from", "99", "--ckpt-dir", os.path.join(root, "ck"),
                    "--publish-dir", pub, "--bench-out", ""])
    torch.cuda.synchronize()
    launches = ops.launches
    versions = snapshots.snapshot_versions(pub)
    newest = versions[-1]

    def fleet_on(model):
        clock = FakeClock()
        engines = [TopicEngine(model, buckets=(8, 16), max_batch=32, clock=clock,
                               start=False, name=f"replica{i}") for i in range(2)]
        return TopicFleet(engines=engines, clock=clock, cache_mb=0.0, shed=False)

    card = fleet_on(small_model("cuda", SMALL["n_topics"], SMALL["vocab"]))
    cpu_model, _ = snapshots.load_snapshot(pub, newest, device="cpu")
    cpu = fleet_on(cpu_model)
    cpu.swap_model(cpu_model, version=newest)
    try:
        card.attach_watchers(pub, poll_s=0.05)
        if not card.wait_for_version(newest, timeout_s=60) or card.live_version() != newest:
            raise AssertionError(f"the card fleet did not reach v{newest}")
        rng = np.random.default_rng(4)
        qs = [rng.integers(0, SMALL["vocab"], size=int(n)) for n in rng.integers(1, 17, 64)]
        got, want = card.infer(qs), cpu.infer(qs)
    finally:
        card.close()
        cpu.close()
    err = 0.0
    for g, w in zip(got, want):
        if g.model_version != newest or g.model_version != w.model_version:
            raise AssertionError("a served version is not the newest")
        if not np.allclose(g.pkd, w.pkd, rtol=1e-6, atol=1e-7):
            raise AssertionError("card and CPU fleets serve different pkd")
        err = max(err, float(np.abs(g.pkd - w.pkd).max()))
    log(f"[serve-publish] launch.train published {versions}; a card fleet of 2 with a "
        f"SnapshotWatcher each reached v{newest} and served {len(qs)} queries as a CPU fleet "
        f"from the same snapshot (max |card − CPU| pkd {err:.3g}); {launches} gibbs_argmax "
        f"launches in the training")
    shutil.rmtree(root, ignore_errors=True)
    return launches


def serve_chaos_phase():
    """``tests/test_chaos.py::test_breaker_trips_and_router_skips_the_sick_replica``
    on the card: a real ``FaultPlane`` fails every inference of replica 0; its
    breaker opens, the router sends the next requests to replica 1, and every
    future resolves."""
    from repro_torch.reliability import faults
    from repro_torch.serving import TopicEngine, TopicFleet

    model = small_model("cuda")
    clock = FakeClock()
    engines = [TopicEngine(model, buckets=(4, 8, 16), max_batch=4, n_iters=2, n_trials=1,
                           top_n=3, clock=clock, start=False, name=f"replica{i}")
               for i in range(2)]
    fleet = TopicFleet(engines=engines, clock=clock, cache_mb=0.0, shed=False,
                       breaker_threshold=1)
    rng = np.random.default_rng(1)

    def drain(futs):
        for _ in range(4):
            fleet.flush_all()
            if all(f.done() for f in futs):
                return
        raise AssertionError("chaos: futures still pending after a bounded drain")

    with faults.injected(faults.FaultPlane().fail("engine.infer", key="replica0")):
        first = fleet.submit(rng.integers(0, 400, size=3))
        drain([first])
        state = fleet.stats().breakers[0]["state"]
        futs = [fleet.submit(rng.integers(0, 400, size=3)) for _ in range(6)]
        drain(futs)
    st = fleet.stats()
    fleet.close()
    attempts = [first.result().attempts] + [f.result().attempts for f in futs]
    if state != "open" or attempts != [2] + [1] * 6 or st.routed != (1, 7) or st.failed:
        raise AssertionError(f"chaos: breaker {state}, attempts {attempts}, routed "
                             f"{st.routed}, failed {st.failed}")
    log(f"[serve-chaos] replica0 fails every inference: its breaker opened after the first "
        f"request (retried on replica1), the next 6 went to replica1 alone (routed "
        f"{st.routed}), every future resolved")


# ----------------------------------------------------------- multi-rank
# Peacock's hierarchical architecture on one card: one process per rank of a
# (pods, data, model) mesh, torch.distributed over gloo, all ranks on cuda:0
# through ranks_per_device. Ranks that share one card measure the overhead of
# the process model (time slicing between the ranks' contexts, every
# collective through pinned host memory), not scaling.
# [ring]: FULL's shard on a 4×1 ring, 3 dense epochs in each ring form, 3 alias
# epochs after one table build; [word-sharded]: 2×2 (P = 2) against 2×1, 2
# epochs each sampler; [ring card vs cpu]: SMALL's corpus on a 2×2 ring; [pods]:
# 2 pods × a 2×1 ring at V = 4,096 (reduced: two Φ replicas, their refs and
# four ranks' planes must fit one card, and pod 1's checkpoint of its whole Φ
# is written and read back within the run's time limit), 6 epochs, a merge
# every 3: exact and compressed at the first boundary, elastic with pod 1 dead
# and restarted from its own checkpoint at the second.
RING = dict(data=4, epochs=3, alias_epochs=3, reps=10)
WSHARD = dict(data=2, model=2, epochs=2)
RING_SMALL = dict(data=2, model=2, epochs=4)
PODS = dict(pods=2, data=2, vocab=4_096, epochs=6, agg_every=3)
LAUNCH_RANKS = dict(epochs=6, agg_every=2, kill_at=3, ckpt_every=3, sharded_ckpt_every=4)
SEED0 = 11


def rank0_log(layout, msg):
    if layout.rank == 0:
        log(msg)


def sync_ranks(layout=None, group="world"):
    """Wait for the card, then for the ranks of ``group``."""
    torch.cuda.synchronize()
    g, ranks = layout.group(group) if layout is not None else (None, [0, 1])
    if len(ranks) > 1:
        torch.distributed.barrier(group=g)


def zero_counts():
    from repro_torch.kernels.alias import ops as alias_ops
    from repro_torch.kernels.gibbs import ops as gibbs_ops
    gibbs_ops.launches = alias_ops.build_launches = alias_ops.mh_launches = 0


def read_counts():
    from repro_torch.kernels.alias import ops as alias_ops
    from repro_torch.kernels.gibbs import ops as gibbs_ops
    return dict(gibbs_argmax=gibbs_ops.launches, alias_build=alias_ops.build_launches,
                mh_resample=alias_ops.mh_launches)


SHA_CHUNK = 64 << 20         # bytes of a tensor hashed as one piece by ``sha``


def sha(t):
    """A tensor's digest: SHA-256 over the SHA-256 of each block of whole
    rows (its last dimension) of about ``SHA_CHUNK`` bytes, in order; for
    tensors of one row width, equal digests are equal bits, as with one
    SHA-256 of the whole. The blocks come off the card one after another and
    are hashed on 4 threads while the next one copies (hashlib lets go of
    the GIL): a rank's Φ slice is gigabytes."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor
    t = t.detach()
    if t.numel() == 0:
        return hashlib.sha256(b"").hexdigest()
    rows = t.reshape(1, -1) if t.dim() < 2 else t.reshape(-1, t.shape[-1])
    step = max(1, SHA_CHUNK // max(1, rows[:1].numel() * rows.element_size()))
    digest = lambda a: hashlib.sha256(a.view(np.uint8).reshape(-1)).digest()
    with ThreadPoolExecutor(4) as pool:
        parts = [pool.submit(digest, np.ascontiguousarray(rows[i:i + step].cpu().numpy()))
                 for i in range(0, rows.shape[0], step)]
        return hashlib.sha256(b"".join(f.result() for f in parts)).hexdigest()


def ring_config(sc, K, V, M, sampler, P=1, doc_cap=0, **knobs):
    from repro_torch.core.distributed import RingConfig
    cap = sc.word_local.shape[-1]
    return RingConfig(n_topics=K, vocab_size=V, rows_per_shard=sc.rows_per_shard,
                      docs_per_shard=sc.docs_per_shard, cap=cap, package_len=cap, n_rounds=M,
                      model_shards=P, sampler=sampler, n_mh=4, doc_topic_cap=doc_cap, **knobs)


def rank_invariants(layout, st, cfg, n_tokens, label, pod_axis=False):
    """Φ of every rank equals the counts of its rows over every pod's
    travelling z (for pods: right after an exact merge), Σ Φ over the pod's
    ranks is Ψ, and Σ Ψ is the token count. A collective over the world with
    ``pod_axis``, else over the rank's ring."""
    from repro_torch.core import distributed as dist
    from repro_torch.dist import collectives as coll, sharding as shd
    torch.cuda.empty_cache()            # the ranks share the card: give back what is free
    lead, ring = (2 if pod_axis else 1), layout.data * layout.model
    spec = dist.specs(cfg.model_shards)["stack"]
    over, pods = ("world", layout.pods) if pod_axis else ("ring", 1)
    gathered = [coll.all_gather(st[i], layout, over).cpu().numpy() for i in (2, 5)]
    stacks = [tuple(shd.assemble([v.reshape(v.shape[lead - 1:]) for v in g[p * ring:(p + 1) * ring]],
                                 spec, dist.pod_layout(layout)) for g in gathered)
              for p in range(pods)]
    phi, psi = dist.rank_counts(stacks, cfg.n_topics, cfg.rows_per_shard, cfg.model_shards,
                                layout, "cuda")
    same = torch.equal(phi, st[0].reshape(phi.shape))
    del phi
    col = st[0].reshape(-1, cfg.n_topics).sum(dim=0, dtype=torch.int64)
    coll.all_reduce_(col, layout, "ring")
    psi_l = st[1].reshape(-1)
    if not (same and torch.equal(col, psi_l.long()) and torch.equal(psi, psi_l)
            and int(psi_l.sum()) == n_tokens):
        raise AssertionError(f"{label}: rank {layout.rank}: Φ is not the counts of the "
                             f"travelling z, or Σ Φ is not Ψ, or Σ Ψ is not {n_tokens}")


def max_abs_diff(a, b, rows=2048):
    """max |a − b| over two equal-shape int tensors, a block of rows at a time."""
    K = a.shape[-1]
    a2, b2 = a.reshape(-1, K), b.reshape(-1, K)
    return max(int((a2[lo:lo + rows] - b2[lo:lo + rows]).abs().max())
               for lo in range(0, a2.shape[0], rows))


def peak_gib():
    return torch.cuda.max_memory_allocated() / 2**30


def free_card():
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def ring_rank(layout, sc, doc_cap, n_tokens):
    """[ring] on this rank of the 4×1 mesh."""
    from repro_torch.core import distributed as dist, sparse
    from repro_torch.dist import collectives as coll
    from repro_torch.kernels.alias import ops as alias_ops
    from repro_torch.kernels.gibbs import ops as gibbs_ops
    K, V, M = FULL["n_topics"], FULL["vocab"], layout.data * layout.model
    alpha = torch.full((K,), 50.0 / K, device="cuda")
    beta = torch.tensor(0.01, device="cuda")
    out = {}
    forms = (("default", {}), ("optimized", dict(theta_dtype=torch.int8, column_exclusion=True,
                                                  small_theta=True)))
    for form, knobs in forms:
        free_card()
        cfg = ring_config(sc, K, V, M, "dense", **knobs)
        st = dist.rank_arrays([sc], K, layout, device="cuda")
        epoch = dist.build_epoch_body(cfg, layout)
        ll0 = dist.ring_word_log_likelihood(st[0], st[1], beta, sc, layout)
        sync_ranks()
        # ---- the main path: counts from 0, the epochs ----
        zero_counts()
        secs = []
        for e in range(RING["epochs"]):
            t0 = time.perf_counter()
            st = epoch(*st, alpha, beta, SEED0 + e)
            sync_ranks()
            secs.append(time.perf_counter() - t0)
        n = read_counts()
        # ---- end of the main path ----
        rank_invariants(layout, st, cfg, n_tokens, f"ring 4x1 {form}")
        ll = dist.ring_word_log_likelihood(st[0], st[1], beta, sc, layout)
        if not ll > ll0:
            raise AssertionError(f"ring 4x1 {form}: the word LL did not rise ({ll0} -> {ll})")
        res = dict(secs=secs, launches=n["gibbs_argmax"], ll=(ll0, ll), peak=peak_gib())
        if form == "default":
            check = (gibbs_check("cuda", "ring 4x1") if layout.rank == 0
                     else (lambda zk, args: None))
            with held(gibbs_ops, "gibbs_argmax", check, first_only=True) as seen:
                epoch(*st, alpha, beta, 99)
            sync_ranks()
            res["held"] = seen[0]
            rot, red = [], []
            stack_bytes = sum(st[i].numel() * st[i].element_size() for i in (2, 3, 4, 5))
            for _ in range(RING["reps"]):
                sync_ranks()
                t0 = time.perf_counter()
                coll.Shift(layout, "ring", [st[2][0], st[3][0], st[4][0]]).wait()
                coll.shift(layout, "ring", [st[5][0]])
                torch.cuda.synchronize()
                rot.append((time.perf_counter() - t0) * 1e3)
                d = st[1].clone()
                sync_ranks()
                t0 = time.perf_counter()
                coll.all_reduce_(d, layout, "ring")
                torch.cuda.synchronize()
                red.append((time.perf_counter() - t0) * 1e3)
            res.update(rotation_ms=float(np.median(rot)), rotation_bytes=stack_bytes,
                       psi_reduce_ms=float(np.median(red)), psi_bytes=st[1].numel() * 4)
        out[form] = res
        del st
    # ---- alias: one table build, then the epochs ----
    free_card()
    cfg = ring_config(sc, K, V, M, "alias", doc_cap=doc_cap)
    st = dist.rank_arrays([sc], K, layout, device="cuda")
    epoch = dist.build_epoch_body(cfg, layout)
    ll0 = dist.ring_word_log_likelihood(st[0], st[1], beta, sc, layout)
    sync_ranks()
    zero_counts()
    t0 = time.perf_counter()
    tabs = tuple(sparse.make_tables(st[0], st[1], alpha, beta, V))
    sync_ranks()
    build_s = time.perf_counter() - t0
    secs = []
    for e in range(RING["alias_epochs"]):
        t0 = time.perf_counter()
        st = epoch(*st, alpha, beta, SEED0 + e, *tabs)
        sync_ranks()
        secs.append(time.perf_counter() - t0)
    n = read_counts()
    ll = dist.ring_word_log_likelihood(st[0], st[1], beta, sc, layout)
    check = mh_check("ring 4x1 alias") if layout.rank == 0 else (lambda zk, args: None)
    with held(alias_ops, "mh_resample", check, first_only=True) as seen:
        epoch(*st, alpha, beta, 99, *tabs)
    sync_ranks()
    out["alias"] = dict(secs=secs, build_s=build_s, launches=n, ll=(ll0, ll), held=seen[0],
                        peak=peak_gib())
    del tabs                            # four ranks' tables and counts would not fit
    rank_invariants(layout, st, cfg, n_tokens, "ring 4x1 alias")
    del st
    free_card()
    return out


def wshard_rank(layout, sc, doc_cap, reference):
    """[word-sharded] on this rank: 2 epochs of each sampler; the digests of
    Φ's rows in the P = 2 slice order (``reference``: this rank is a 2×1 rank
    and digests its rows j::2 for each slice j), Ψ and the rank's stacks.
    Collectives over the rank's ring only (the reference runs on pod 0 of a
    2 × 2×1 mesh while pod 1 waits)."""
    from repro_torch.core import distributed as dist, sparse
    K, V = FULL["n_topics"], FULL["vocab"]
    P = layout.model if not reference else 1
    alpha = torch.full((K,), 50.0 / K, device="cuda")
    beta = torch.tensor(0.01, device="cuda")
    out = {}
    for sampler in ("dense", "alias"):
        free_card()
        cfg = ring_config(sc, K, V, layout.data, sampler, P=P, doc_cap=doc_cap)
        st = dist.rank_arrays([sc], K, layout, device="cuda")
        epoch = dist.build_epoch_body(cfg, layout)
        sync_ranks(layout, "ring")
        zero_counts()
        tabs = tuple(sparse.make_tables(st[0], st[1], alpha, beta, V)) if sampler == "alias" \
            else ()
        secs = []
        for e in range(WSHARD["epochs"]):
            t0 = time.perf_counter()
            st = epoch(*st, alpha, beta, SEED0 + e, *tabs)
            sync_ranks(layout, "ring")
            secs.append(time.perf_counter() - t0)
        n = read_counts()
        peak = peak_gib()
        del tabs
        rank_invariants(layout, st, cfg, sc.n_real_tokens, f"word-sharded P={P} {sampler}")
        view = st[0][0]
        rows_coarse = sc.rows_coarse or sc.rows_per_shard
        if reference:
            digests = [sha(view[j::WSHARD["model"]]) for j in range(WSHARD["model"])]
        else:
            n_j = len(range(layout.model_index, rows_coarse, P))
            if bool(view[n_j:].any()):
                raise AssertionError(f"word-sharded rank {layout.rank}: a pad row holds counts")
            digests = [sha(view[:n_j])]
        out[sampler] = dict(digests=digests, psi=st[1].cpu().numpy(),
                            stacks=[st[i].cpu().numpy() for i in (2, 4, 5)], secs=secs,
                            launches=n, peak=peak)
        del st, view
    free_card()
    return out


def small_ring_rank(layout, sc, doc_cap):
    """[ring card vs cpu] on this rank of a 2×2 ring: each sampler on the card
    (every dense package held against the plain version on the CPU) and on
    the CPU, from one z0."""
    from repro_torch.core import distributed as dist, sparse
    from repro_torch.kernels.gibbs import ops as gibbs_ops
    K, V, M = SMALL["n_topics"], SMALL["vocab"], layout.data * layout.model
    out = {}
    for sampler in ("dense", "alias"):
        cfg = ring_config(sc, K, V, M, sampler, doc_cap=doc_cap)
        res = {}
        for dev in ("cuda", "cpu"):
            alpha = torch.full((K,), 50.0 / K, device=dev)
            beta = torch.tensor(0.01, device=dev)
            st = dist.rank_arrays([sc], K, layout, device=dev)
            epoch = dist.build_epoch_body(cfg, layout)
            zero_counts()
            tabs = tuple(sparse.make_tables(st[0], st[1], alpha, beta, V)) \
                if sampler == "alias" else ()
            seen = []
            ctx = (held(gibbs_ops, "gibbs_argmax", gibbs_check("cpu", "ring card vs cpu"))
                   if dev == "cuda" and sampler == "dense" else contextlib.nullcontext(seen))
            with ctx as seen:
                for e in range(RING_SMALL["epochs"]):
                    st = epoch(*st, alpha, beta, SEED0 + e, *tabs)
            if dev == "cuda":
                torch.cuda.synchronize()
                res["launches"] = read_counts()
                res["ties"] = sum(x["mismatches"] for x in seen)
            res[dev] = [x.cpu().numpy() for x in st]
        out[sampler] = res
    return out


def pod_checkpoint_tree(layout, st, cfg, alpha):
    """The pod's state in the single-configuration global layout, assembled
    on the pod's first rank (``None`` on the others; a collective over the
    pod's ranks)."""
    from repro_torch.core import distributed as dist
    from repro_torch.dist import sharding as shd
    sp = dist.specs(cfg.model_shards)
    parts = []
    for i, x in enumerate(st):
        v = x[0]                                     # drop the pod dim
        spec = sp["phi"] if i == 0 else sp["psi"] if i == 1 else sp["stack"]
        if spec == ():
            parts.append(v.cpu().numpy())
            continue
        views = dist.gather_views(v, layout, "ring")
        parts.append(None if views is None else shd.assemble(views, spec,
                                                             dist.pod_layout(layout)))
    first = layout.rank % (layout.data * layout.model) == 0
    return {"state": tuple(parts), "alpha": alpha.cpu().numpy()} if first else None


def pods_rank(layout, scs, n_tokens, root):
    """[pods] on this rank of the 2 × (2×1) mesh."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import distributed as dist, hierarchy
    from repro_torch.dist import collectives as coll, sharding as shd
    K, V = FULL["n_topics"], PODS["vocab"]
    free_card()
    cfg = ring_config(scs[0], K, V, layout.data * layout.model, "dense")
    alpha = torch.full((K,), 50.0 / K, device="cuda")
    beta = torch.tensor(0.01, device="cuda")
    st = hierarchy.init_pod_state(scs, K, layout, device="cuda")
    epoch_fn = hierarchy.make_pod_ring_epoch(cfg, layout)
    exact = hierarchy.make_aggregate(layout)
    compressed = hierarchy.make_aggregate(layout, compressed=True)
    elastic = hierarchy.make_elastic_aggregate(layout)
    mgr = CheckpointManager(root, keep=2)
    pod, first = layout.pod_index, layout.rank % (layout.data * layout.model) == 0
    pod_sha = lambda x: [s for s in _all_gather_object(sha(x), layout, "pod")]
    res = dict(epoch_s=[], agg={})

    def timed_epoch(*args):
        t0 = time.perf_counter()
        out = epoch_fn(*args)
        sync_ranks()
        res["epoch_s"].append(time.perf_counter() - t0)
        return out

    def agg(phi, psi, phi_ref, psi_ref, live, seed):
        if (len(res["agg"]) == 0):
            # boundary 1: the exact merge, and the compressed one on a copy
            phi_c, psi_c = phi.clone(), psi.clone()
            amax = torch.tensor(float(max_abs_diff(phi, phi_ref)), device="cuda")
            scale = float(coll.shared_scale(amax, layout, "pod"))
            sync_ranks()
            t0 = time.perf_counter()
            exact(phi, psi, phi_ref, psi_ref, seed=seed)
            sync_ranks()
            t_exact = time.perf_counter() - t0
            t0 = time.perf_counter()
            compressed(phi_c, psi_c, phi_ref, psi_ref, seed=seed)
            sync_ranks()
            t_comp = time.perf_counter() - t0
            err = max_abs_diff(phi_c, phi)
            bound = layout.pods * scale + 0.5
            if err > bound or not torch.equal(psi_c, psi):
                raise AssertionError(f"pods: the compressed merge is {err} from the exact one, "
                                     f"beyond the quantization bound {bound:.3f}")
            del phi_c, psi_c
            digests = pod_sha(phi)
            if len(set(digests)) != 1:
                raise AssertionError("pods: the pods disagree after the exact merge")
            rank_invariants(layout, (phi, psi) + tuple(cur[2:]), cfg, n_tokens,
                            "pods after the exact merge", pod_axis=True)
            # pod 1 checkpoints itself, assembled on its first rank
            t0 = time.perf_counter()
            if pod == 1:
                tree = pod_checkpoint_tree(layout, (phi, psi) + tuple(cur[2:]), cfg, alpha)
                if first:
                    mgr.save(1, tree, meta={"epoch": PODS["agg_every"]}, pod=pod)
                del tree
            torch.distributed.barrier()
            t_ckpt = time.perf_counter() - t0
            res["agg"]["boundary 1"] = dict(
                exact_s=t_exact, compressed_s=t_comp, max_err=err, bound=bound, scale=scale,
                exact_bytes=phi.numel() * 4 + psi.numel() * 4,
                compressed_bytes=phi.numel() + psi.numel() * 4, ckpt_s=t_ckpt)
            return phi, psi
        # boundary 2: pod 1 failed; it restarts from its own checkpoint and
        # its delta is dropped by the elastic merge
        t0 = time.perf_counter()
        if pod == 1:
            # the pod's first rank reads the checkpoint and hands each rank its view
            group, members = layout.group("ring")
            tree = None
            if first:
                like = {"state": tuple(np.zeros(0) for _ in range(6)), "alpha": np.zeros(0)}
                tree, _ = mgr.restart_pod(1, like)
            sp, lay1 = dist.specs(cfg.model_shards), dist.pod_layout(layout)
            for i, spec in ((0, sp["phi"]), (1, sp["psi"]), (5, sp["stack"])):
                buf = torch.empty(cur[i][0].shape, dtype=cur[i][0].dtype)
                parts = None if tree is None else [
                    torch.from_numpy(np.ascontiguousarray(shd.local_view(
                        np.asarray(tree["state"][i]), spec, lay1, rank=r % len(members))))
                    for r in members]
                torch.distributed.scatter(buf, parts, src=members[0], group=group)
                cur[i][0].copy_(buf)
            del tree
            # it saved the merged state of boundary 1, which is this window's ref
            if not (torch.equal(phi, phi_ref) and torch.equal(psi, psi_ref)):
                raise AssertionError("pods: pod 1's restarted state is not what it saved")
        torch.distributed.barrier()
        t_restart = time.perf_counter() - t0
        before = phi.clone() if pod == 0 else None
        sync_ranks()
        t0 = time.perf_counter()
        elastic(phi, psi, phi_ref, psi_ref, live=live, seed=seed)
        sync_ranks()
        t_el = time.perf_counter() - t0
        # pod 1's delta dropped: pod 0 keeps its state and pod 1 gets it
        kept = bool(torch.equal(phi, before)) if pod == 0 else True
        del before
        if elastic.last_n_live != 1 or not all(_all_gather_object(kept, layout, "world")) \
                or len(set(pod_sha(phi))) != 1:
            raise AssertionError(f"pods: the elastic merge with pod 1 dead left n_live "
                                 f"{elastic.last_n_live}, or the pods off pod 0's state")
        res["agg"]["boundary 2"] = dict(elastic_s=t_el, restart_s=t_restart,
                                        n_live=elastic.last_n_live)
        return phi, psi

    cur = list(st)          # the epochs update these tensors in place
    sync_ranks()
    # ---- the main path: counts from 0, run_hierarchical ----
    zero_counts()
    out = hierarchy.run_hierarchical(
        timed_epoch, agg, st, alpha, beta, PODS["epochs"], PODS["agg_every"], seed0=SEED0,
        liveness=lambda ep: [1, 1] if ep < PODS["agg_every"] else [1, 0])
    n = read_counts()
    # ---- end of the main path ----
    rank_invariants(layout, out, cfg, n_tokens, "pods after the elastic merge", pod_axis=True)
    res.update(launches=n, peak=peak_gib())
    del out, st, cur
    free_card()
    return res


def _all_gather_object(obj, layout, name):
    group, ranks = layout.group(name)
    got = [None] * len(ranks)
    torch.distributed.all_gather_object(got, obj, group=group)
    return got


def world_a(layout, sc4, sc_p2, sc_p1, sc_small, scs_pods, doc_caps, tokens, root):
    """One world of 4 ranks on the card for [ring], [word-sharded] (2×2, and
    its 2×1 reference on pod 0 of the pods' mesh), [ring card vs cpu] and
    [pods], each mesh over the same ranks."""
    from repro_torch.launch import mesh
    t = {}
    t0 = time.perf_counter()
    out = {"ring": ring_rank(layout, sc4, doc_caps["full"], tokens["full"])}
    t["ring"] = time.perf_counter() - t0
    rank0_log(layout, f"[ranks] ring 4x1 done in {t['ring']:.1f} s")
    lay22 = mesh.relayout(layout, 1, WSHARD["data"], WSHARD["model"])
    t0 = time.perf_counter()
    out["wshard"] = wshard_rank(lay22, sc_p2, doc_caps["full"], reference=False)
    t["wshard"] = time.perf_counter() - t0
    rank0_log(layout, f"[ranks] word-sharded 2x2 done in {t['wshard']:.1f} s")
    t0 = time.perf_counter()
    out["small"] = small_ring_rank(lay22, sc_small, doc_caps["small"])
    t["small"] = time.perf_counter() - t0
    rank0_log(layout, f"[ranks] ring card vs cpu done in {t['small']:.1f} s")
    lay_pods = mesh.relayout(layout, PODS["pods"], PODS["data"], 1)
    t0 = time.perf_counter()
    if lay_pods.pod_index == 0:         # the 2x1 reference on pod 0's ring
        out["wshard_ref"] = wshard_rank(lay_pods, sc_p1, doc_caps["full"], reference=True)
    torch.distributed.barrier()
    t["wshard_ref"] = time.perf_counter() - t0
    rank0_log(layout, f"[ranks] word-sharded 2x1 reference done in {t['wshard_ref']:.1f} s")
    t0 = time.perf_counter()
    out["pods"] = pods_rank(lay_pods, scs_pods, tokens["pods"], root)
    t["pods"] = time.perf_counter() - t0
    out["seconds"] = t
    return out


def ranks_phase(corpus):
    """[ring], [word-sharded], [ring card vs cpu] and [pods]: the multi-rank
    paths at full width on the card, in one spawned world of 4 ranks."""
    import shutil
    from repro_torch.core import sparse
    from repro_torch.data import corpus as corpus_mod, synthetic
    from repro_torch.launch import mesh
    K = FULL["n_topics"]
    t0 = time.perf_counter()
    sc4 = corpus_mod.shard_corpus(corpus, 4, 4, K, seed=1)
    sc_p2 = corpus_mod.shard_corpus(corpus, 2, 2, K, seed=1, n_model_shards=2)
    sc_p1 = corpus_mod.shard_corpus(corpus, 2, 2, K, seed=1)
    small, _ = synthetic.lda_corpus(seed=0, n_docs=SMALL["n_docs"], n_topics=SMALL["gen_topics"],
                                    vocab_size=SMALL["vocab"], doc_len_mean=9)
    sc_small = corpus_mod.shard_corpus(small, 4, 4, SMALL["n_topics"], seed=1)
    pcorpus, _ = synthetic.lda_corpus(seed=0, n_docs=FULL["n_docs"], n_topics=FULL["gen_topics"],
                                      vocab_size=PODS["vocab"], query_like=True)
    scs = corpus_mod.shard_corpus_pods(pcorpus, PODS["pods"], PODS["data"], PODS["data"], K,
                                       seed=1)
    doc_caps = dict(full=sparse.suggest_cap(corpus.doc_lengths(), K),
                    small=sparse.suggest_cap(small.doc_lengths(), SMALL["n_topics"]))
    tokens = dict(full=corpus.n_tokens, pods=pcorpus.n_tokens)
    root = os.path.join(ROOT, "build", "chip_smoke_pods")
    shutil.rmtree(root, ignore_errors=True)
    # the ranks share the card: segments that grow keep each rank's cache small
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    log(f"[ranks] sharded on the host in {time.perf_counter() - t0:.1f} s: ring 4x1 cap "
        f"{sc4.word_local.shape[-1]} rows {sc4.rows_per_shard}; word-sharded 2x2 cap "
        f"{sc_p2.word_local.shape[-1]} rows {sc_p2.rows_per_shard} (coarse {sc_p2.rows_coarse}); "
        f"pods corpus V={PODS['vocab']}: {pcorpus.n_docs} docs, {pcorpus.n_tokens} tokens, cap "
        f"{scs[0].word_local.shape[-1]} rows {scs[0].rows_per_shard}; free disk under build/ "
        f"{shutil.disk_usage(ROOT).free / 2**30:.1f} GiB")
    t0 = time.perf_counter()
    a = mesh.spawn(world_a, data=4, device="cuda", ranks_per_device=4, backend="gloo",
                   args=(sc4, sc_p2, sc_p1, sc_small, scs, doc_caps, tokens, root))
    t_a = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    card = card_line()
    secs = a[0]["seconds"]
    log(f"[ranks] world of 4 ranks on one card: {t_a:.1f} s (ring {secs['ring']:.1f}, "
        f"word-sharded {secs['wshard']:.1f}, card vs cpu {secs['small']:.1f}, 2x1 reference "
        f"{secs['wshard_ref']:.1f}, pods {secs['pods']:.1f}); card {card}")
    return ranks_report(a, [r["wshard_ref"] for r in a[:2]], corpus, card)


def _sum_counts(results, key):
    out = {}
    for r in results:
        for k, v in key(r).items():
            out[k] = out.get(k, 0) + v
    return out


def ranks_report(a, b, corpus, card):
    """Check and print what the worlds returned; returns the launches by path."""
    T = corpus.n_tokens
    ring = [r["ring"] for r in a]
    for form in ("default", "optimized"):
        secs = np.max([r[form]["secs"] for r in ring], axis=0)
        n = sum(r[form]["launches"] for r in ring)
        want = 4 * RING["epochs"] * RING["data"]
        if n != want:
            raise AssertionError(f"ring 4x1 {form}: gibbs_argmax launched {n}, expected {want}")
        log(f"[ring] 4x1, {form} form ({RING['epochs']} epochs, K={FULL['n_topics']} "
            f"V={FULL['vocab']}, {T} tokens): epoch s {[round(float(s), 4) for s in secs]}, "
            f"tokens/s {[round(T / float(s), 1) for s in secs]}; word LL "
            f"{ring[0][form]['ll'][0]:.6e} -> {ring[0][form]['ll'][1]:.6e}; launches "
            f"gibbs_argmax={n} (expected {want}); peak GiB per rank "
            f"{[round(r[form]['peak'], 2) for r in ring]} (sum "
            f"{sum(r[form]['peak'] for r in ring):.2f}); card {card}")
    r0 = ring[0]["default"]
    log(f"[ring] 4x1 default, rank 0, first package of an epoch: gibbs_argmax against its plain "
        f"version on the card: {r0['held']}; differing draws are near-ties (≤ 4 ulp)")
    log(f"[ring] rotation (wl, dl, uid, then z; one hop, through pinned host memory): "
        f"{r0['rotation_ms']:.3f} ms a round (median of {RING['reps']}, rank 0; ranks "
        f"{[round(r['default']['rotation_ms'], 3) for r in ring]}), {r0['rotation_bytes']} "
        f"bytes a rank; Ψ all_reduce ({r0['psi_bytes']} bytes) {r0['psi_reduce_ms']:.3f} ms "
        f"(ranks {[round(r['default']['psi_reduce_ms'], 3) for r in ring]}); card {card}")
    al = [r["ring"]["alias"] for r in a]
    n = _sum_counts(al, lambda r: r["launches"])
    want = dict(mh_resample=4 * RING["alias_epochs"] * RING["data"], alias_build=8)
    if n["mh_resample"] != want["mh_resample"] or n["alias_build"] != want["alias_build"]:
        raise AssertionError(f"ring 4x1 alias: launches {n}, expected {want}")
    secs = np.max([r["secs"] for r in al], axis=0)
    log(f"[ring] 4x1 alias ({RING['alias_epochs']} epochs after one table build of "
        f"{max(r['build_s'] for r in al):.3f} s): epoch s {[round(float(s), 4) for s in secs]}, "
        f"tokens/s {[round(T / float(s), 1) for s in secs]}; word LL {al[0]['ll'][0]:.6e} -> "
        f"{al[0]['ll'][1]:.6e}; launches {n}; mh_resample held on rank 0: {al[0]['held']}; "
        f"peak GiB per rank {[round(r['peak'], 2) for r in al]} (sum "
        f"{sum(r['peak'] for r in al):.2f}); card {card}")
    # [word-sharded]: 2x2 against the 2x1 reference
    launches = dict(ring_4x1_gibbs=sum(r["ring"]["default"]["launches"] for r in a),
                    ring_4x1_optimized=sum(r["ring"]["optimized"]["launches"] for r in a),
                    ring_4x1_alias=n)
    for sampler in ("dense", "alias"):
        got = [r["wshard"][sampler] for r in a]
        ref = [r[sampler] for r in b]
        for rank, g in enumerate(got):
            d, j = rank // WSHARD["model"], rank % WSHARD["model"]
            if g["digests"][0] != ref[d]["digests"][j]:
                raise AssertionError(f"word-sharded {sampler}: rank {rank}'s Φ slice differs "
                                     f"from the 2x1 ring's rows {j}::2 of shard {d}")
            if not np.array_equal(g["psi"], ref[d]["psi"]):
                raise AssertionError(f"word-sharded {sampler}: Ψ differs from the 2x1 ring's")
        zs = []
        for side in (got, ref):
            z = np.zeros(T, np.int32)
            for r in side:
                wl, uid, zz = r["stacks"]
                z[uid[wl >= 0]] = zz[wl >= 0]
            zs.append(z)
        if not np.array_equal(*zs):
            raise AssertionError(f"word-sharded {sampler}: z differs from the 2x1 ring's")
        kern = "gibbs_argmax" if sampler == "dense" else "mh_resample"
        n22 = _sum_counts(got, lambda r: r["launches"])
        n21 = _sum_counts(ref, lambda r: r["launches"])
        want = 4 * WSHARD["epochs"] * WSHARD["data"]
        if n22[kern] != want or n21[kern] != 2 * WSHARD["epochs"] * WSHARD["data"]:
            raise AssertionError(f"word-sharded {sampler}: launches 2x2 {n22}, 2x1 {n21}")
        launches[f"word_sharded_2x2_{sampler}"] = n22
        launches[f"word_sharded_2x1_{sampler}"] = n21
        s22 = np.max([g["secs"] for g in got], axis=0)
        s21 = np.max([r["secs"] for r in ref], axis=0)
        log(f"[word-sharded] {sampler}: 2x2 (P=2) equals 2x1 bit for bit after "
            f"{WSHARD['epochs']} epochs (Φ slices by SHA-256 against the 2x1 rows j::2, Ψ, z "
            f"by uid); epoch s 2x2 {[round(float(s), 4) for s in s22]} (tokens/s "
            f"{[round(T / float(s), 1) for s in s22]}), 2x1 {[round(float(s), 4) for s in s21]} "
            f"(tokens/s {[round(T / float(s), 1) for s in s21]}); launches 2x2 {n22}, 2x1 {n21}; "
            f"peak GiB per rank 2x2 {[round(g['peak'], 2) for g in got]} (sum "
            f"{sum(g['peak'] for g in got):.2f}), 2x1 {[round(r['peak'], 2) for r in ref]} (sum "
            f"{sum(r['peak'] for r in ref):.2f}); card {card}")
    # [ring card vs cpu]
    for sampler in ("dense", "alias"):
        res = [r["small"][sampler] for r in a]
        diff = {name: sum(int((r["cuda"][i] != r["cpu"][i]).sum()) for r in res)
                for name, i in (("phi", 0), ("psi", 1), ("z", 5))}
        ties = sum(r["ties"] for r in res)
        if sampler == "alias" and any(diff.values()):
            raise AssertionError(f"ring card vs cpu, alias: card and CPU differ {diff}")
        if sampler == "dense" and any(diff.values()) and not ties:
            raise AssertionError(f"ring card vs cpu, dense: card and CPU differ {diff} with no "
                                 f"differing draw")
        n = _sum_counts(res, lambda r: r["launches"])
        launches[f"ring_card_vs_cpu_{sampler}"] = n
        log(f"[ring card vs cpu] {sampler}: 2x2 ring, K={SMALL['n_topics']} V={SMALL['vocab']}, "
            f"{RING_SMALL['epochs']} epochs on the card and on the CPU: entries that differ "
            f"{diff}; draws differing from the plain version on the CPU {ties} (near-ties); "
            f"launches on the card {n}")
    # [pods]
    pods = [r["pods"] for r in a]
    n = _sum_counts(pods, lambda r: r["launches"])
    want = 4 * PODS["epochs"] * PODS["data"]
    if n["gibbs_argmax"] != want:
        raise AssertionError(f"pods: gibbs_argmax launched {n}, expected {want}")
    launches["pods"] = n
    b1 = [p["agg"]["boundary 1"] for p in pods]
    b2 = [p["agg"]["boundary 2"] for p in pods]
    secs = np.max([p["epoch_s"] for p in pods], axis=0)
    log(f"[pods] 2 pods x 2x1 ring, K={FULL['n_topics']} V={PODS['vocab']} (reduced from "
        f"{FULL['vocab']}), {PODS['epochs']} epochs, a merge every {PODS['agg_every']}: epoch s "
        f"{[round(float(s), 4) for s in secs]}; launches {n}; card {card}")
    log(f"[pods] boundary 1: exact merge {max(x['exact_s'] for x in b1) * 1e3:.1f} ms "
        f"({b1[0]['exact_bytes']} bytes a rank through host memory and gloo), compressed "
        f"{max(x['compressed_s'] for x in b1) * 1e3:.1f} ms ({b1[0]['compressed_bytes']} payload "
        f"bytes a rank: int8 ΔΦ all-gathered, summed in int16; Ψ exact); compressed vs exact "
        f"max |Δ| per rank {[x['max_err'] for x in b1]} within the bound "
        f"{[round(x['bound'], 3) for x in b1]} (2·scale + 0.5); pods agree; pod 1's "
        f"checkpoint {max(x['ckpt_s'] for x in b1):.1f} s; card {card}")
    log(f"[pods] boundary 2: pod 1 dead, restart_pod(1) from its own checkpoint "
        f"{max(x['restart_s'] for x in b2):.1f} s (its Φ equal to what it saved), elastic merge "
        f"{max(x['elastic_s'] for x in b2) * 1e3:.1f} ms, last_n_live "
        f"{b2[0]['n_live']}, the pods agree on pod 0's state; peak GiB per rank "
        f"{[round(p['peak'], 2) for p in pods]} (sum {sum(p['peak'] for p in pods):.2f}); "
        f"card {card}")
    return launches


def launch_small_model(results, P):
    """(Φ [V, K], Ψ, z by token) of launch.train's 2-rank data ring (P = 1)
    or 2×P word-sharded ranks, from the ranks' views."""
    from repro_torch.core import distributed as dist
    from repro_torch.data import corpus as corpus_mod, synthetic
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.sharding import RankLayout
    corpus, _ = synthetic.lda_corpus(seed=0, n_docs=SMALL["n_docs"], n_topics=SMALL["gen_topics"],
                                     vocab_size=SMALL["vocab"], doc_len_mean=8)
    sc = corpus_mod.shard_corpus(corpus, 2, 2, SMALL["n_topics"], seed=1, n_model_shards=P)
    sp, layout = dist.specs(P), RankLayout(1, 2, P)
    views = [r["state"] for r in results]
    phi = shd.assemble([v[0] for v in views], sp["phi"], layout)
    wl, uid, z = (shd.assemble([v[i] for v in views], sp["stack"], layout) for i in (2, 4, 5))
    zt = np.zeros(corpus.n_tokens, np.int32)
    zt[uid[wl >= 0]] = z[wl >= 0]
    return dist.gather_phi(torch.from_numpy(phi), sc).numpy(), views[0][1], zt


def launch_ranks_phase():
    """[launch.train multi-rank]: ``repro_torch.launch.train.main`` starting
    its own ranks on the card (gloo, ranks_per_device): SMALL's geometry on 2
    pods × a 2×1 ring — an uninterrupted run that publishes, a run killed
    after epoch 3 (a mid-window checkpoint) and resumed, which must equal it
    rank by rank and publish the same model; then a ``--sharded-model``
    (P = 2) run that checkpoints at epoch 4, and that checkpoint resumed at
    P = 1 (resharded): its model (Φ by word, Ψ, z by token) must equal the
    P = 2 run's final one. The three chains (uninterrupted; killed, then
    resumed; P = 2, then P = 1) are worlds of their own and start together."""
    import shutil
    from repro_torch.checkpoint import snapshots
    from repro_torch.launch import train
    S = LAUNCH_RANKS
    root = os.path.join(ROOT, "build", "chip_smoke_ranks")
    shutil.rmtree(root, ignore_errors=True)

    def run(ck, *extra, every=S["ckpt_every"]):
        argv = ["--device", "cuda", "--backend", "gloo", "--docs", str(SMALL["n_docs"]),
                "--vocab", str(SMALL["vocab"]), "--topics", str(SMALL["n_topics"]),
                "--true-topics", str(SMALL["gen_topics"]), "--epochs", str(S["epochs"]),
                "--agg-every", str(S["agg_every"]), "--alpha-opt-from", "2",
                "--ckpt-every", str(every), "--bench-out", "",
                "--ckpt-dir", os.path.join(root, ck), *extra]
        t0 = time.perf_counter()
        try:
            out = train.main(argv), 0
        except SystemExit as exc:
            out = None, exc.code
        return out + (time.perf_counter() - t0,)

    def same(a, b, label):
        for ra, rb in zip(a, b):
            for i, (x, y) in enumerate(zip(ra["state"], rb["state"])):
                if x.dtype != y.dtype or not np.array_equal(x, y):
                    raise AssertionError(f"{label}: rank {ra['rank']}'s state leaf {i} differs")
            if not np.array_equal(ra["alpha"], rb["alpha"]):
                raise AssertionError(f"{label}: rank {ra['rank']}'s α differs")

    counts = lambda results: _sum_counts(results, lambda r: r["launches"])
    pods = ("--pods", "2", "--data-shards", "2", "--ranks-per-device", "4")
    snap = {k: os.path.join(root, f"snap-{k}") for k in ("gold", "resumed")}
    every = S["sharded_ckpt_every"]
    chains = [Beside(run, "gold", *pods, "--publish-dir", snap["gold"]),
              Beside(lambda: (run("killed", *pods, "--kill-at", str(S["kill_at"])),
                              run("killed", *pods, "--resume", "--publish-dir",
                                  snap["resumed"]))),
              Beside(lambda: (run("sharded", "--data-shards", "2", "--model-shards", "2",
                                  "--sharded-model", "--ranks-per-device", "4", every=every),
                              run("sharded", "--data-shards", "2", "--ranks-per-device", "2",
                                  "--resume", every=every)))]
    for c in chains:                    # every world ends before a failure is raised
        c.join()
    (gold, _, t_gold), ((_, code, t_kill), (res, _, t_res)), \
        ((p2, _, t_p2), (p1, _, t_p1)) = [c.result() for c in chains]
    n = dict(uninterrupted=counts(gold), resumed=counts(res))
    want = dict(uninterrupted=4 * S["epochs"] * 2, resumed=4 * (S["epochs"] - S["kill_at"]) * 2)
    if code != 17 or any(n[k]["gibbs_argmax"] != want[k] for k in want):
        raise AssertionError(f"launch.train pods: kill exit {code}, launches {n}, want {want}")
    same(gold, res, "launch.train pods, resumed vs uninterrupted")
    models = {k: snapshots.load_snapshot(p, device="cuda") for k, p in snap.items()}
    if not (torch.equal(models["gold"][0].pvk, models["resumed"][0].pvk)
            and models["gold"][1]["epoch"] == models["resumed"][1]["epoch"] == S["epochs"]):
        raise AssertionError("launch.train pods: the resumed run published another model")
    log(f"[launch.train multi-rank] --pods 2 --data-shards 2 --ranks-per-device 4: killed "
        f"after epoch {S['kill_at']} (exit 17, a checkpoint between boundaries) and resumed: "
        f"every rank's state and α equal the uninterrupted run's bit for bit, both published "
        f"v_{models['gold'][1]['version']:06d} models equal; launches {n}; seconds "
        f"uninterrupted {t_gold:.1f}, killed {t_kill:.1f}, resumed {t_res:.1f}")
    got = {P: launch_small_model(res, P) for P, res in ((2, p2), (1, p1))}
    for i, name in enumerate(("phi by word", "psi", "z by token")):
        if not np.array_equal(got[2][i], got[1][i]):
            raise AssertionError(f"launch.train: the P = 2 checkpoint resumed at P = 1 ends with "
                                 f"another {name} than the P = 2 run")
    n.update(sharded_p2=counts(p2), sharded_resumed_p1=counts(p1))
    log(f"[launch.train multi-rank] --sharded-model (P = 2, {t_p2:.1f} s) checkpointed at epoch "
        f"{every}, resumed at P = 1 (resharded, {t_p1:.1f} s): the final Φ by word, Ψ and z by "
        f"token equal the P = 2 run's bit for bit; launches {n['sharded_p2']} / "
        f"{n['sharded_resumed_p1']}")
    shutil.rmtree(root, ignore_errors=True)
    return n


# ------------------------------------------------- the streamed ring of ranks
# the streamed cell's corpus on a 4×1 ring in 10 segments (packages of at most
# 2,500: two a sub-block), then word-sharded 2×2 (P = 2) against 2×1 in 20
# segments (the 2×1 ranks' one-package planes stay near 15 GiB)
STREAM_RANKS = dict(ring=4, segments=10, max_package=2_500, epochs=3, alpha_from=1,
                    alias_epochs=3, wshard_segments=20, wshard_epochs=2, reps=10)
# SMALL's corpus on a 2×2 ring in 3 segments, and launch.train's streamed worlds
STREAM_RANKS_SMALL = dict(segments=3, epochs=4, kill_at=2, kill_at_segment=1)
# lookup_sharded: dlrm-mlperf's table row-sharded 4 ways, the serve_p99 batch and one of 16,384
LOOKUP = dict(batches=(512, 16_384), reps=20, seed=0)


def stream_trainer(layout, root, sampler, n_epochs, callbacks=(), **kw):
    """A streamed ``Trainer`` of this rank over the directory ``root``."""
    from repro_torch.training import Trainer, TrainerConfig
    cfg = TrainerConfig(n_topics=FULL["n_topics"], vocab_size=FULL["vocab"], corpus_dir=root,
                        sampler=sampler, n_epochs=n_epochs, agg_every=STREAM["agg_every"],
                        n_mh=STREAM["n_mh"], device="cuda", data_shards=layout.data,
                        model_shards=layout.model, **kw)
    tr = Trainer(cfg, callbacks=list(callbacks), layout=layout)
    tr.log = lambda m: None
    return tr


def stream_rank_invariants(layout, tr, label):
    """Φ rows of this rank equal the counts of the global z store over every
    segment (``rank_counts``), Σ Φ over the ring is Ψ, and Σ Ψ is the token
    count. A collective over the ring."""
    from repro_torch.core import distributed as dist
    from repro_torch.dist import collectives as coll
    torch.cuda.empty_cache()
    z, src, K = tr.global_z(), tr.source, tr.config.n_topics
    scs = [src.segment(g) for g in range(src.n_segments)]
    phi, psi = dist.rank_counts([(sc.word_local, z[np.asarray(sc.uid)]) for sc in scs], K,
                                tr.sc0.rows_per_shard, tr.config.n_model_shards, layout, "cuda")
    view, psi_l = tr.state[0].reshape(phi.shape), tr.state[1]
    same = torch.equal(phi, view)
    del phi
    col = view.sum(dim=0, dtype=torch.int64)
    coll.all_reduce_(col, layout, "ring")
    if not (same and torch.equal(psi, psi_l) and torch.equal(col, psi_l.long())
            and int(psi_l.sum()) == src.n_tokens):
        raise AssertionError(f"{label}: rank {layout.rank}: Φ is not the counts of the global z "
                             f"store, or Σ Φ is not Ψ, or Σ Ψ is not {src.n_tokens}")
    return z


def stream_rank_stats(tr, first=0):
    """This rank's per-epoch stream numbers from epoch ``first`` on: epoch
    seconds, and the means of LoadShard, the consumer's wait and SaveShard
    (ms a segment)."""
    m, n = tr.metrics, tr.source.n_segments
    rows = []
    for e, ep_s in enumerate(m["epoch_s"][first:], start=first):
        sl = slice(e * n, (e + 1) * n)
        rows.append(dict(epoch_s=ep_s, **{f"{k[:-2]}_ms": 1e3 * float(np.mean(m[k][sl]))
                                         for k in ("load_shard_s", "load_wait_s",
                                                   "save_shard_s")}))
    return rows


def stream_held_epoch(tr, layout, kernel, tables=False):
    """One uncounted epoch body over this rank's block of the first segment,
    with ``kernel``'s wrapper held against its plain version on rank 0 (the
    first call); every rank runs it (collectives). It moves the counts, so
    it comes last."""
    from repro_torch.data.stream import SegmentStream
    from repro_torch.kernels.alias import ops as alias_ops
    from repro_torch.kernels.gibbs import ops as gibbs_ops
    seg = next(iter(SegmentStream(tr.source, tr._z.copy(), prefetch=False, device=tr.device,
                                  layout=layout).epoch(0)))
    mod, check = ((gibbs_ops, gibbs_check("cuda", "streamed ring"))
                  if kernel == "gibbs_argmax" else (alias_ops, mh_check("streamed ring alias")))
    if layout.rank != 0:
        check = lambda zk, args: None       # noqa: E731
    aux = tr._epoch_tables() if tables else ()
    with held(mod, kernel, check, first_only=True) as seen:
        tr._epoch_fn(*tr.state, seg.wl, seg.dl, seg.uid, seg.z, tr.alpha, tr.beta, 4000, *aux)
    sync_ranks()
    return seen[0]


def stream_ring_rank(layout, root, L):
    """[stream-ranks] 4×1 on this rank: the dense Trainer from the directory
    (3 epochs, α from the second; the main path), a profiled epoch (rank 0),
    the rotation and Ψ reduce on a segment's block, prefetch on vs off, then
    the alias Trainer (one table build, 3 epochs)."""
    from repro_torch.data.stream import SegmentStream
    from repro_torch.dist import collectives as coll
    from repro_torch.training import AlphaOptimizer, Metrics
    S, out = STREAM_RANKS, {}
    free_card()
    say = (lambda m: log(f"[stream-ranks] 4x1 dense {m}")) if layout.rank == 0 \
        else (lambda m: None)
    tr = stream_trainer(layout, root, "dense", S["epochs"],
                        [AlphaOptimizer(), Metrics(printer=say), epoch_peak()],
                        alpha_opt_from=S["alpha_from"], package_len=L)
    tr.setup()
    sync_ranks()
    # ---- the main path: counts from 0, the streamed ring Trainer's fit ----
    zero_counts()
    t0 = time.perf_counter()
    tr.fit()
    sync_ranks()
    fit_s = time.perf_counter() - t0
    n = read_counts()
    # ---- end of the main path ----
    lls = tr.metrics["ll"]
    if not all(np.isfinite(lls)) or not lls[-1] > lls[0]:
        raise AssertionError(f"streamed 4x1 ring: the word LL did not rise: {lls}")
    alpha = tr.alpha.cpu().numpy()
    if not (np.isfinite(alpha).all() and (alpha > 0).all()) or abs(alpha.sum() - 50.0) < 1e-3:
        raise AssertionError("streamed 4x1 ring: α is non-finite, non-positive or unmoved")
    stream_rank_invariants(layout, tr, "streamed 4x1 dense")
    res = dict(launches=n, fit_s=fit_s, ll=lls, rows=stream_rank_stats(tr),
               peak=max(tr.metrics["peak_gib"]), alpha_sum=float(alpha.sum()),
               by_rank=tr.metrics["stream_by_rank"])
    # ---- one more epoch through fit (no callbacks), profiled on rank 0 ----
    tr.callbacks, before = [], len(tr.metrics["epoch_s"])
    tr.config = tr.config.replace(n_epochs=S["epochs"] + 1)
    if layout.rank == 0:
        device_breakdown("streamed 4x1 ring epoch, rank 0", tr.fit, top=10)
    else:
        tr.fit()
    sync_ranks()
    res["profiled"] = stream_rank_stats(tr, first=before)
    # ---- the rotation and the Ψ all_reduce on one segment's block ----
    seg = next(iter(SegmentStream(tr.source, tr._z.copy(), prefetch=False, device=tr.device,
                                  layout=layout).epoch(0)))
    rot, red = [], []
    for _ in range(S["reps"]):
        sync_ranks()
        t0 = time.perf_counter()
        coll.Shift(layout, "ring", [seg.wl[0], seg.dl[0], seg.uid[0]]).wait()
        coll.shift(layout, "ring", [seg.z[0]])
        torch.cuda.synchronize()
        rot.append((time.perf_counter() - t0) * 1e3)
        d = tr.state[1].clone()
        sync_ranks()
        t0 = time.perf_counter()
        coll.all_reduce_(d, layout, "ring")
        torch.cuda.synchronize()
        red.append((time.perf_counter() - t0) * 1e3)
    res.update(rotation_ms=float(np.median(rot)), psi_reduce_ms=float(np.median(red)),
               rotation_bytes=sum(t.numel() * t.element_size()
                                  for t in (seg.wl, seg.dl, seg.uid, seg.z)),
               psi_bytes=tr.state[1].numel() * 4)
    del seg
    res["held"] = stream_held_epoch(tr, layout, "gibbs_argmax")
    out["dense"] = res
    tr.state = None
    del tr
    # ---- prefetch on and off, one epoch each from one start ----
    free_card()
    pre = {}
    for prefetch in (True, False):
        t = stream_trainer(layout, root, "dense", 1, prefetch=prefetch, alpha_opt_from=99,
                           package_len=L)
        t.fit()
        sync_ranks()
        pre[prefetch] = dict(phi=sha(t.state[0]), psi=t.state[1].cpu().numpy(), z=t.global_z(),
                             rows=stream_rank_stats(t))
        t.state = None
        del t
        free_card()
    same = dict(phi=pre[True]["phi"] == pre[False]["phi"],
                psi=bool(np.array_equal(pre[True]["psi"], pre[False]["psi"])),
                z=bool(np.array_equal(pre[True]["z"], pre[False]["z"])))
    if not all(same.values()):
        raise AssertionError(f"streamed 4x1 ring, rank {layout.rank}: prefetch on and off "
                             f"differ: equal {same}")
    out["prefetch"] = {p: v["rows"] for p, v in pre.items()}
    # ---- the alias Trainer: one table build a rank, then the epochs ----
    say = (lambda m: log(f"[stream-ranks] 4x1 alias {m}")) if layout.rank == 0 \
        else (lambda m: None)
    ta = stream_trainer(layout, root, "alias", S["alias_epochs"], [Metrics(printer=say),
                                                                   epoch_peak()],
                        alpha_opt_from=99)
    ta.setup()
    sync_ranks()
    zero_counts()
    t0 = time.perf_counter()
    ta.fit()
    sync_ranks()
    fit_s = time.perf_counter() - t0
    n = read_counts()
    peak = max(ta.metrics["peak_gib"])
    ta._tables = None                 # four ranks' tables and the count check would not fit
    stream_rank_invariants(layout, ta, "streamed 4x1 alias")
    ta._rebuild_tables()              # for the held epoch only (not counted)
    ta._tables_built_at = ta.epoch
    held_mh = stream_held_epoch(ta, layout, "mh_resample", tables=True)
    out["alias"] = dict(launches=n, fit_s=fit_s, ll=ta.metrics["ll"], rows=stream_rank_stats(ta),
                        peak=peak, held=held_mh)
    ta.state = ta._tables = None
    del ta
    free_card()
    return out


def stream_wshard_rank(layout, root, reference):
    """[stream-ranks] word-sharded: 2 dense epochs from the P = 2 directory
    on a 2×2 mesh, or (``reference``) from the 2×1 directory on a 2-rank
    ring; returns the digests of Φ's rows in the P = 2 slice order, Ψ and
    the global z store."""
    S = STREAM_RANKS
    free_card()
    tr = stream_trainer(layout, root, "dense", S["wshard_epochs"], [epoch_peak()],
                        alpha_opt_from=99, n_model_shards=1 if reference else layout.model)
    tr.setup()
    sync_ranks(layout, "ring")
    zero_counts()
    tr.fit()
    sync_ranks(layout, "ring")
    n = read_counts()
    stream_rank_invariants(layout, tr, f"streamed word-sharded {'2x1' if reference else '2x2'}")
    view, P = tr.state[0][0], 2
    if reference:
        digests = [sha(view[j::P]) for j in range(P)]
    else:
        rows_coarse = tr.sc0.rows_coarse or tr.sc0.rows_per_shard
        n_j = len(range(layout.model_index, rows_coarse, P))
        if bool(view[n_j:].any()):
            raise AssertionError(f"streamed word-sharded rank {layout.rank}: a pad row holds "
                                 f"counts")
        digests = [sha(view[:n_j])]
    out = dict(digests=digests, psi=tr.state[1].cpu().numpy(), z=tr.global_z(), launches=n,
               rows=stream_rank_stats(tr), peak=max(tr.metrics["peak_gib"]))
    tr.state = None
    del tr, view
    free_card()
    return out


def pod0_ring_layout(lay_pods):
    """Pod 0's ring of a (2, D, 1) mesh as a one-pod (1, D, 1) layout over
    the same process groups (its ranks are 0 … D−1, the ring's own numbers),
    so a single-pod session runs on pod 0 while pod 1 waits."""
    from repro_torch.dist.sharding import RankLayout
    g = lay_pods.groups
    return RankLayout(pods=1, data=lay_pods.data, model=1, rank=lay_pods.rank,
                      backend=lay_pods.backend, device=lay_pods.device,
                      ranks_per_device=lay_pods.ranks_per_device,
                      groups={"world": g["ring"], "ring": g["ring"], "data": g["data"],
                              "model": g["model"], "pod": (None, [lay_pods.rank])})


def stream_small_rank(layout, small):
    """[stream-ranks card vs cpu]: SMALL's corpus in 3 segments on this rank
    of a 2×2 ring, each sampler on the card (every dense package held
    against the plain version on the CPU) and on the CPU."""
    import dataclasses
    from repro_torch.data import sources
    from repro_torch.kernels.gibbs import ops as gibbs_ops
    from repro_torch.training import Trainer, TrainerConfig
    K, S = SMALL["n_topics"], STREAM_RANKS_SMALL
    out = {}
    for sampler in ("dense", "alias"):
        res = {}
        for dev in ("cuda", "cpu"):
            lay = layout if dev == "cuda" else dataclasses.replace(layout, device="cpu")
            src = sources.InMemorySource(small, S["segments"], 4, 4, K, seed=1)
            cfg = TrainerConfig(n_topics=K, vocab_size=SMALL["vocab"], sampler=sampler,
                                n_epochs=S["epochs"], agg_every=2, alpha_opt_from=99,
                                data_shards=2, model_shards=2, device=dev)
            tr = Trainer(cfg, source=src, layout=lay)
            tr.log = lambda m: None
            zero_counts()
            ctx = (held(gibbs_ops, "gibbs_argmax", gibbs_check("cpu", "streamed ring card vs cpu"))
                   if dev == "cuda" and sampler == "dense" else contextlib.nullcontext([]))
            with ctx as seen:
                tr.fit()
            if dev == "cuda":
                torch.cuda.synchronize()
                res["launches"] = read_counts()
                res["ties"] = sum(x["mismatches"] for x in seen)
            res[dev] = [tr.state[0].cpu().numpy(), tr.state[1].cpu().numpy(), tr.global_z()]
        out[sampler] = res
    return out


def lookup_rank(layout):
    """[lookup_sharded] on this rank of a (1, 1, 4) mesh: its quarter of
    dlrm-mlperf's 187,767,552 × 128 bf16 table, drawn on the card; each
    batch's rows (the ``embedding_bag`` kernel's read of the quarter, summed
    over "model") equal the rank's local gather where it owns the id, every
    id is hit by exactly one rank; ms a batch and of its all_reduce. Returns
    the numbers and the quarter (``dlrm_ranks`` trains on it)."""
    from repro_torch.configs import recsys_archs as ra
    from repro_torch.dist import collectives as coll, sharding as shd
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.models import recsys
    free_card()
    bag0 = ops.launches
    spec = ra.DLRM.embedding
    lo, hi = shd.row_slice(spec.padded_rows, layout, "model")
    g = torch.Generator(device="cuda")
    g.manual_seed(LOOKUP["seed"] * 131 + layout.rank)
    shard = torch.empty((hi - lo, spec.dim), dtype=torch.bfloat16, device="cuda")
    t0 = time.perf_counter()
    for a in range(0, hi - lo, 1 << 22):
        b = min(hi - lo, a + (1 << 22))
        shard[a:b] = torch.randn((b - a, spec.dim), generator=g, device="cuda")
    sync_ranks()
    out = dict(rows=hi - lo, gib=shard.numel() * 2 / 2**30, draw_s=time.perf_counter() - t0,
               batches={})
    offs = torch.from_numpy(spec.offsets).long().cuda()[None, :]
    sizes = np.array(spec.vocab_sizes)
    for B in LOOKUP["batches"]:
        rng = np.random.default_rng(LOOKUP["seed"] + B)
        ids = torch.from_numpy((rng.random((B, spec.n_fields)) * sizes).astype(np.int32)).cuda()
        rows = recsys.lookup_sharded(shard, spec, ids, layout)
        flat = ids.long() + offs
        mine = (flat >= lo) & (flat < hi)
        local = shard.index_select(0, (flat[mine] - lo))
        same = torch.equal(rows[mine].view(torch.int16), local.view(torch.int16))
        hits = coll.all_reduce_(mine.to(torch.int32), layout, "model")
        if not same or not bool((hits == 1).all()):
            raise AssertionError(f"lookup_sharded B={B}, rank {layout.rank}: owned rows differ "
                                 f"from the local gather ({not same}) or an id is not hit "
                                 f"exactly once")
        secs, red = [], []
        for _ in range(LOOKUP["reps"]):
            sync_ranks()
            t0 = time.perf_counter()
            recsys.lookup_sharded(shard, spec, ids, layout)
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t0) * 1e3)
            x = rows.clone()
            sync_ranks()
            t0 = time.perf_counter()
            coll.all_reduce_(x, layout, "model")
            torch.cuda.synchronize()
            red.append((time.perf_counter() - t0) * 1e3)
        out["batches"][B] = dict(ms=float(np.median(secs)), p99_ms=float(np.percentile(secs, 99)),
                                 reduce_ms=float(np.median(red)),
                                 reduce_bytes=rows.numel() * rows.element_size(),
                                 owned=int(mine.sum()), dtype=str(rows.dtype))
        del rows, x
    out["peak"] = peak_gib()
    out["launches"] = ops.launches - bag0
    free_card()
    return out, shard


# The recsys and GNN steps across ranks (ROADMAP 13b, 13f), in stream_world's
# world of 4 ranks: dlrm-mlperf at (1, 1, 4) on lookup_rank's quarters of its
# table, then at (1, 2, 2) xdeepfm, din and autoint train_batch and
# graphsage-reddit's four cells, each against its one-rank step on rank 0.
# Against the one-rank step (``held_against_one_rank``), limits set from the
# sound readings of a card run of these phases (PERF.md §6): the
# largest |Δ| of a dense parameter after the last step, dense_tol (read up
# to 2.61e-4, minibatch_lg; a sign-flipped update parts a weight by 2·lr =
# 2e-3); AdamW's m and v after step 1, ‖Δ‖₂ / ‖value‖₂ per tensor,
# moment_rtol (there m = (1 − β1)·g and v = (1 − β2)·g², the gradient summed
# in another order: read 4e-7 to 6e-6, and 4.3e-4 for ogb_products, whose
# sums over 61.9M edges part by ~ε·√E; a scaled gradient, which AdamW's
# update does not see, parts m by the scale); each table's change p − p_before
# after step 1 and after the last, Σ|Δ change| / Σ|change|, table_rtol (read
# 0, and 6.3e-7 for xdeepfm).
# bulk_parts: dlrm's serve_bulk batch goes through the serve cell in 4 calls of
# 65,536 rows: at (1, 1, 4) each rank runs the whole dense path of the batch, and
# four ranks' activations of 262,144 rows (~10 GB each) beside their 11.19 GiB
# quarters would pass the card's 80 GB
# cut: xdeepfm's train batch, 16,384 (8,192 a rank): its CIN's outer products
# take 41.14 GiB at 32,768 on one rank (PERF.md §6), and four ranks at
# 16,384 each, or rank 0's one-rank step at 32,768 beside the others, pass the card
RANKS = dict(seed=31, steps=3, untouched=65_536, serve_reps=5, bulk_parts=4,
             cut={"xdeepfm": 16_384},
             gnn_steps={"ogb_products": 2}, loss_rtol=1e-5, dense_tol=1e-3,
             moment_rtol=2e-3, table_rtol=1e-4)


class CollectiveClock:
    """Within the block, host ms (from a synchronize) of the port's
    collectives (``all_reduce_``, ``all_gather``, ``reduce_scatter`` of
    ``dist.collectives``: every sum, gather and reduce-scatter of the
    recsys and GNN steps goes through them)."""

    def __enter__(self):
        from repro_torch.dist import collectives as coll
        self.coll, self.real, self.ms = coll, {}, 0.0
        for name in ("all_reduce_", "all_gather", "reduce_scatter"):
            self.real[name] = getattr(coll, name)
            setattr(coll, name, self._timed(self.real[name]))
        return self

    def _timed(self, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.ms += (time.perf_counter() - t0) * 1e3
            return out
        return call

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.coll, name, fn)


@contextlib.contextmanager
def held_bag():
    """Every launch of the ``embedding_bag`` kernel inside the block held
    against its plain version on the same inputs: the same values for bags
    of one (a shard's read: the row, or zero at weight 0), else within
    ``BAG_TOL``. Yields the list of the launches' id shapes."""
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_padded_ref
    real, calls = ops.embedding_bag_cuda, []

    def launch(table, ids, weights=None, combiner="sum"):
        out = real(table, ids, weights, combiner)
        plain = embedding_bag_padded_ref(table, ids, weights, combiner)
        tol = 0.0 if ids.shape[1] == 1 else BAG_TOL[table.dtype]
        if not torch.allclose(out.float(), plain.float(), rtol=tol, atol=tol):
            raise AssertionError(f"embedding_bag on the path ({tuple(ids.shape)} ids, D "
                                 f"{table.shape[1]}, {table.dtype}): differs from its plain "
                                 f"version by {float((out.float() - plain.float()).abs().max())}")
        calls.append(tuple(ids.shape))
        return out

    ops.embedding_bag_cuda = launch
    try:
        yield calls
    finally:
        ops.embedding_bag_cuda = real


def rank_views(arg, spec, layout):
    """This rank's block of the global ``arg`` under ``spec`` (dicts and
    lists elementwise), as tensors of its own."""
    from repro_torch.dist import sharding as shd
    if isinstance(arg, dict):
        return {k: rank_views(arg[k], spec[k], layout) for k in arg}
    if isinstance(arg, (list, tuple)):
        return [rank_views(a, s, layout) for a, s in zip(arg, spec)]
    return shd.local_view(arg, spec, layout).clone()


def same_on_ranks(layout, group, tree, label):
    """Raise unless ``tree`` has the same bits on every rank of ``group``."""
    if len(layout.group(group)[1]) == 1:
        return
    prints = _all_gather_object(fingerprint(tree), layout, group)
    if any(p != prints[0] for p in prints):
        raise AssertionError(f"{label}: rank {layout.rank}: the replicas over {group!r} differ")


def is_table(name):
    return name.endswith("table") or name == "linear_w"


def tree_paths(tree, pre=""):
    """(path, leaf) of a nested dict in sorted key order ("layers/wq")."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_paths(tree[k], f"{pre}/{k}" if pre else k)]
    return [(pre, tree)]


def tree_clone(tree):
    return {k: tree_clone(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


def replica_group(spec):
    """The group whose ranks hold the same block under ``spec`` (one pod):
    "world" for a replicated leaf, "dp" for one split over "model" only,
    "model" for one split over "data" only; None where no rank shares it."""
    from repro_torch.dist.sharding import _axes
    axes = {a for entry in spec for a in _axes(entry)} & {"data", "model"}
    return {frozenset(): "world", frozenset({"model"}): "dp",
            frozenset({"data"}): "model"}.get(frozenset(axes))


def same_by_spec(layout, tree, specs, label):
    """``same_on_ranks`` for every leaf of ``tree`` over the group that
    replicates its block under ``specs`` (a tree of the same structure)."""
    groups = {}
    for (path, x), (_, spec) in zip(tree_paths(tree), tree_paths(specs)):
        g = replica_group(spec)
        if g is not None:
            groups.setdefault(g, {})[path] = x
    for g in ("world", "dp", "model"):
        if g in groups:
            same_on_ranks(layout, g, groups[g], f"{label} ({g} replicas)")


def gather_to_rank0(t, spec, layout):
    """On rank 0 the global tensor of which ``t`` is this rank's block under
    ``spec`` (``collectives.all_assemble``: every rank assembles it and the
    others drop it, so called leaf by leaf each rank holds one whole leaf at
    most); None on the other ranks. A replicated leaf is rank 0's own."""
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.sharding import _axes
    if not any(_axes(entry) for entry in spec):
        return t if layout.rank == 0 else None
    whole = coll.all_assemble(t.detach().contiguous(), spec, layout)
    return whole if layout.rank == 0 else None


def cell_steps(layout, label, cell, args, steps, first=None):
    """``steps`` calls of a train cell's ``fn`` on this rank's ``args``
    (params and state carried): the first under ``count_collectives`` (the
    step's collectives and bytes, no per-op count) with every kernel launch
    held against its plain version, the rest timed (host clock to a
    synchronize) with the collectives' clock (one step: that one is timed,
    counted and held); after each, the loss and every replica of a
    parameter or moment block the same bits (``same_by_spec``: a replicated
    leaf over "world", a table shard or a vocab slice over "dp", an FSDP
    block over "model"). ``first``, a dict, gets copies of the params and
    state after step 1. Returns (params, state), the losses and the numbers."""
    from repro_torch.dist import analysis
    from repro_torch.kernels.embedding_bag import ops
    if steps < 1:
        raise ValueError("cell_steps runs 1 step or more")
    args, losses, times, coll_ms = list(args), [], [], []
    free_card()
    bag0, bwd0 = ops.launches, ops.bwd_launches
    for i in range(steps):
        sync_ranks(layout)
        t0 = time.perf_counter()
        if i == 0:
            with held_bag() as bags, held_bwd() as bwds, CollectiveClock() as clock:
                cost, out = analysis.count_collectives(cell.fn, *args)
        else:
            with CollectiveClock() as clock:
                out = cell.fn(*args)
        torch.cuda.synchronize()
        if i or steps == 1:
            times.append((time.perf_counter() - t0) * 1e3)
            coll_ms.append(clock.ms)
        args[0], args[1] = out[0], out[1]
        if i == 0 and first is not None:
            first.update(params=tree_clone(out[0]),
                         state={p: tree_clone(out[1][p]) for p in ("m", "v")})
        losses.append(float(out[2]))
        same_by_spec(layout, {"loss": out[2], "params": out[0], "state": out[1]},
                     {"loss": (), "params": cell.arg_specs[0], "state": cell.arg_specs[1]},
                     label)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: losses {losses}")
    return args[:2], losses, dict(
        step_ms=float(np.median(times)), coll_ms=float(np.median(coll_ms)),
        timed={1: "step 1, counted and held", 2: "step 2"}.get(steps, f"steps 2-{steps}"),
        coll_calls=cost.collectives, coll_bytes=cost.collective_bytes, peak=peak_gib(),
        bag=ops.launches - bag0, bwd=ops.bwd_launches - bwd0, held_bag=len(bags),
        held_bwd=len(bwds), losses=losses)


def dlrm_ranks(layout, shard):
    """[recsys-ranks] dlrm-mlperf at (1, 1, 4) at full width on this rank's
    quarter of the table (``reduced``: none): the train cell's step 3 times
    (B = 65,536 on every rank), sampled untouched rows unchanged bit for
    bit; a serve_p99 batch (held, then timed) and a serve_bulk batch, the
    same logits on every rank; retrieval over 10⁶ candidates split four
    ways, equal to rank 0's one-rank ``retrieval_scores`` bit for bit."""
    import dataclasses
    from repro_torch.configs import recsys_archs as ra
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.models import recsys as rec
    spec, out = ra.DLRM.embedding, {}
    lo, hi = shd.row_slice(spec.padded_rows, layout, "model")
    g = torch.Generator(device="cuda").manual_seed(RANKS["seed"])   # the same on every rank
    # the dense parameters by init_params' law, drawn beside a stand-in table of 256 rows
    stub = dataclasses.replace(ra.DLRM, embedding=rec.EmbeddingSpec((1,) * spec.n_fields,
                                                                    spec.dim))
    params = {**rec.init_params(stub, g, "cuda"), "table": shard}
    cell = ra.specs()["dlrm-mlperf"].cell("train_batch", layout)
    B = RECSYS_SHAPES["train_batch"]["batch"]
    labels = torch.randint(0, 2, (B,), generator=g, device="cuda").to(torch.float32)
    inputs = ra._dlrm_inputs(B, g, "cuda")
    dense = {k: v for k, v in params.items() if k != "table"}
    opt = {"step": torch.zeros((), dtype=torch.int32, device="cuda"),
           "m": {k: torch.zeros_like(v) for k, v in dense.items()},
           "v": {k: torch.zeros_like(v) for k, v in dense.items()}}
    flat = (inputs[1].long() + torch.from_numpy(spec.offsets).long().cuda()[None, :]).reshape(-1)
    mine = flat[(flat >= lo) & (flat < hi)] - lo
    hit = torch.zeros(hi - lo, dtype=torch.bool, device="cuda")
    hit[mine] = True
    free_rows = (~hit).nonzero()[:, 0]
    mine_g = torch.Generator(device="cuda").manual_seed(RANKS["seed"] + 1 + layout.rank)
    pick = free_rows[torch.randperm(free_rows.numel(), generator=mine_g, device="cuda")
                     [:RANKS["untouched"]]]
    moved = mine[:RANKS["untouched"]]
    before, touched = shard[pick].clone(), shard[moved].clone()
    del flat, hit, free_rows
    (params, _), _, out["train"] = cell_steps(layout, "dlrm-mlperf train_batch", cell,
                                              (params, opt, labels, *inputs), RANKS["steps"])
    if not same_bits(shard[pick], before) or torch.equal(shard[moved], touched):
        raise AssertionError(f"dlrm-mlperf at (1, 1, 4), rank {layout.rank}: an untouched row "
                             f"changed, or no touched row moved")
    out["train"].update(model_coll_bytes=cell.model_coll_bytes, owned=int(mine.numel()),
                        untouched=int(pick.numel()), batch=B)
    del labels, inputs, before, touched, mine
    for shape in ("serve_p99", "serve_bulk"):
        free_card()
        c = ra.specs()["dlrm-mlperf"].cell(shape, layout)
        x = ra._dlrm_inputs(RECSYS_SHAPES[shape]["batch"], g, "cuda")
        parts = RANKS["bulk_parts"] if shape == "serve_bulk" else 1
        n = x[0].shape[0] // parts
        serve = lambda: torch.cat([c.fn(params, *(a[i * n:(i + 1) * n] for a in x))
                                   for i in range(parts)])
        bag0, times = ops.launches, []
        with torch.no_grad():
            if shape == "serve_p99":
                with held_bag() as bags:
                    logits = serve()
            for _ in range(RANKS["serve_reps"] if shape == "serve_p99" else 1):
                sync_ranks(layout)
                with CollectiveClock() as clock:
                    t0 = time.perf_counter()
                    logits = serve()
                    torch.cuda.synchronize()
                times.append(((time.perf_counter() - t0) * 1e3, clock.ms))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"dlrm-mlperf {shape} at (1, 1, 4): logits not finite")
        same_on_ranks(layout, "world", logits, f"dlrm-mlperf {shape}")
        out[shape] = dict(ms=float(np.median([t[0] for t in times])),
                          coll_ms=float(np.median([t[1] for t in times])),
                          peak=peak_gib(), bag=ops.launches - bag0, batch=logits.shape[0],
                          parts=parts,
                          held=len(bags) if shape == "serve_p99" else 0,
                          model_coll_bytes=c.model_coll_bytes)
        del x, logits
    free_card()
    c = ra.specs()["dlrm-mlperf"].cell("retrieval_cand", layout)
    q, cand = c.make_args(g, "cuda")
    local = rank_views(cand, c.arg_specs[1], layout)
    sync_ranks(layout)
    with CollectiveClock() as clock:
        t0 = time.perf_counter()
        s, i = c.fn(q, local)
        torch.cuda.synchronize()
    out["retrieval"] = dict(ms=(time.perf_counter() - t0) * 1e3, coll_ms=clock.ms,
                            n=cand.shape[0], per_rank=local.shape[0])
    same_on_ranks(layout, "world", (s, i), "retrieval_cand")
    if layout.rank == 0:
        ws, wi = rec.retrieval_scores(q, cand, top_k=100)
        if not (same_bits(s, ws) and torch.equal(i, wi)):
            raise AssertionError("retrieval_cand at (1, 1, 4): the merged top-k differs from "
                                 "the one-rank retrieval_scores")
    del q, cand, local, params
    free_card()
    return out


def held_against_one_rank(layout, label, cell, one, args, steps, rep):
    """Rank 0: ``one``'s (the one-rank cell's) ``steps`` steps from the
    global ``args``, against the ranks' (``rep``: params and state after
    step 1 and after the last; tables gathered over "model" by every rank
    first, every other sharded leaf, an LM's, assembled on rank 0 by
    ``gather_to_rank0``): the losses, AdamW's m and v after step 1, each
    dense parameter after the last, and each table's change after both,
    within ``RANKS``' limits. ``args`` is used on rank 0 only."""
    from repro_torch.dist import collectives as coll
    params, first = rep.pop("params"), rep.pop("first")
    gather = lambda ps: {k: coll.all_gather(v.contiguous(), layout, "model").flatten(0, 1)
                         for k, v in ps.items() if is_table(k)}
    tables, tables1 = gather(params), gather(first["params"])
    whole = lambda tree, specs: {
        k: gather_to_rank0(x, spec, layout)
        for (k, x), (_, spec) in zip(tree_paths(tree), tree_paths(specs)) if not is_table(k)}
    t0 = time.perf_counter()
    last = whole(params, cell.arg_specs[0])
    moments = {part: whole(first["state"][part], cell.arg_specs[1][part]) for part in ("m", "v")}
    rep["gather_s"] = time.perf_counter() - t0
    del params
    free_card()                       # every rank gives back its cache before rank 0's steps
    sync_ranks(layout)
    t0 = time.perf_counter()
    if layout.rank == 0:
        ref, losses = list(args), []
        before = {k: v.clone() for k, v in ref[0].items() if is_table(k)}
        worst = {"dense": 0.0, "moment": 0.0, "table": 0.0}

        def hold(kind, name, value, limit):
            worst[kind] = max(worst[kind], value)
            if not value <= limit:
                raise AssertionError(f"{label}: {name} parts from one rank's by {value:.3g} "
                                     f"({kind}, limit {limit:g})")

        def hold_tables(got, when):
            for k, b in before.items():
                moved = ref[0][k].float() - b.float()
                size = float(moved.abs().sum())
                if size == 0.0:
                    raise AssertionError(f"{label}: one rank's step left {k} unchanged")
                off = float((got[k].float() - b.float() - moved).abs().sum())
                hold("table", f"{k}'s change {when}", off / size, RANKS["table_rtol"])

        for i in range(steps):
            ref[0], ref[1], loss = one.fn(*ref)
            losses.append(float(loss))
            if i == 0:
                for part in ("m", "v"):
                    for k, want in tree_paths(ref[1][part]):
                        norm = torch.linalg.vector_norm
                        off = float(norm(moments[part][k] - want))
                        hold("moment", f"{part}/{k} after step 1",
                             off / max(float(norm(want)), 1e-30), RANKS["moment_rtol"])
                hold_tables(tables1, "after step 1")
        rl = np.array(rep["losses"])
        if not np.allclose(rl, losses, rtol=RANKS["loss_rtol"], atol=0):
            raise AssertionError(f"{label}: losses {rep['losses']} against one rank's {losses}")
        hold_tables(tables, f"after step {steps}")
        for k, want in tree_paths(ref[0]):
            if not is_table(k):
                hold("dense", k, float((last[k] - want).abs().max()), RANKS["dense_tol"])
        rep.update(one_rank_losses=losses,
                   max_loss_rel=float(np.max(np.abs(rl - losses) / np.abs(losses))),
                   max_table=worst["table"], max_dense=worst["dense"],
                   max_moment=worst["moment"])
        del ref, before
    del tables, tables1, first, last, moments
    sync_ranks(layout)
    rep["one_rank_s"] = time.perf_counter() - t0


def recsys_ranks_22(layout):
    """[recsys-ranks] xdeepfm, din and autoint train_batch at (1, 2, 2) at
    full width (xdeepfm at B = 16,384, ``reduced``: the batch,
    ``RANKS["cut"]``), 3 steps from one global draw, against rank 0's
    one-rank steps."""
    from repro_torch.configs import recsys_archs as ra
    out = {}
    for arch in ("xdeepfm", "din", "autoint"):
        cell = ra.specs()[arch].cell("train_batch", layout)
        g = torch.Generator(device="cuda").manual_seed(RANKS["seed"] + 1)
        args = list(cell.make_args(g, "cuda"))
        cut = RANKS["cut"].get(arch)
        if cut:
            args = args[:2] + [a[:cut] for a in args[2:]]
        local = rank_views(args, cell.arg_specs, layout)
        first = {}
        (params, _), _, rep = cell_steps(layout, f"{arch} train_batch", cell, local,
                                         RANKS["steps"], first)
        del local
        rep.update(params=params, first=first, batch=args[2].shape[0],
                   model_coll_bytes=cell.model_coll_bytes)
        held_against_one_rank(layout, f"{arch} train_batch at (1, 2, 2)", cell,
                              ra.specs()[arch].cell("train_batch"), args, RANKS["steps"], rep)
        out[arch] = rep
        del args, params, first
        free_card()
    return out


def gnn_ranks(layout):
    """[gnn-ranks] graphsage-reddit's four cells at (1, 2, 2) on drawn inputs
    at full width (``reduced``: none; ogb_products 2 steps, the rest 3),
    against rank 0's one-rank steps."""
    from repro_torch.configs import gnn_archs as ga
    out = {}
    for kind in ga.GNN_SHAPES:
        cell = ga.spec().cell(kind, layout)
        g = torch.Generator(device="cuda").manual_seed(RANKS["seed"] + 2)
        args = list(cell.make_args(g, "cuda"))
        local = rank_views(args, cell.arg_specs, layout)
        steps = RANKS["gnn_steps"].get(kind, RANKS["steps"])
        first = {}
        (params, _), _, rep = cell_steps(layout, f"graphsage-reddit {kind}", cell, local, steps,
                                         first)
        del local
        rep.update(params=params, first=first, model_coll_bytes=cell.model_coll_bytes)
        held_against_one_rank(layout, f"graphsage-reddit {kind} at (1, 2, 2)", cell,
                              ga.spec().cell(kind), args, steps, rep)
        out[kind] = rep
        del args, params, first
        free_card()
    return out


# [lm-ranks]: the LM steps across ranks in stream_world's 4 ranks.
# qwen3-0.6b at full width at (1, 2, 2): train_4k on a global batch of 4, one
# microbatch of 2 sequences a data replica, in the config's bf16 (2 steps:
# step 1 counted and held, step 2 timed), then one step computing in f32
# against rank 0's one-rank step in 2 microbatches of 2 (the same mean, all
# labels valid); prefill_32k's last chunk and 4 decode_32k steps at B = 2 in
# bf16, the decodes at positions in both cache slices (at 16,382-16,383 the
# second slice holds no valid position); then the f32 check: a prefill chunk
# across the two slices' boundary (its first half's rows find no valid
# position in the second slice), a decode after it (both slices hold written
# rows) and one at the last position, against one rank's steps, logits and
# the cache rows around the boundary; qwen2-moe-a2.7b ("ffn") and phi3.5-moe
# ("expert", 4 of its 16 experts a rank) at 2 layers at (1, 1, 4): decode in
# f32 at capacity factor E/k at B = 4, at the end of the first rank's slice
# (the other three slices past it) and of the last
LM_RANKS = dict(seed=35, train_batch=4, train_steps=2, serve_batch=2,
                decodes=(16_382, 16_383, 32_766, 32_767),
                moe_batch=4, moe_layers=2,
                moe_decodes=(8_191, 32_767))


def lm_rank_params(cfg, layout, seed, dtype, keep_full=True):
    """(the global parameters on rank 0 with ``keep_full``, else None; this
    rank's views; the generator after the draw): every rank draws the same
    tree from ``seed``, keeping only its views leaf by leaf (rank 0 the
    whole tree too, with ``keep_full``)."""
    import functools
    from repro_torch.dist import sharding as shd
    from repro_torch.models import transformer as tf
    specs = shd.lm_param_specs(cfg)
    spec_of = lambda path: functools.reduce(lambda t, k: t[k], path, specs)
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout.rank == 0 and keep_full:
        full = tf.init_params(cfg, g, "cuda", dtype)
        return full, rank_views(full, specs, layout), g
    return None, tf.init_params(cfg, g, "cuda", dtype,
                                view=lambda p, x: shd.local_view(x, spec_of(p), layout).clone()), g


def lm_ranks_train(layout):
    """[lm-ranks] qwen3-0.6b train_4k at (1, 2, 2): the main path in the
    config's bf16, ``LM_RANKS['train_steps']`` steps through ``cell_steps``
    (step 1 counted and held, the last timed); then one step computing in
    f32 from the same parameters and tokens through ``cell_steps`` and
    ``held_against_one_rank``: ``RANKS``' limits are f32 ones, and in bf16 a
    token's embedding gradient alone parts by ~0.8% between the two sums'
    roundings (on the CPU, at small widths)."""
    import dataclasses
    from repro_torch.configs import base, lm_archs as la
    from repro_torch.models import transformer as tf
    B = LM_RANKS["train_batch"]
    S = base.LM_SHAPES["train_4k"]["seq_len"]
    state = lambda p: {"step": torch.zeros((), dtype=torch.int32, device="cuda"),
                       "m": tf.tree_map(torch.zeros_like, p), "v": tf.tree_map(torch.zeros_like, p)}
    out = {}
    for dtype in (la.QWEN3_0_6B.dtype, torch.float32):
        main = dtype == la.QWEN3_0_6B.dtype
        cfg = dataclasses.replace(la.QWEN3_0_6B, dtype=dtype)
        cell = base.build_lm_cell(cfg, "train_4k", layout, micro_per_device=2, batch=B)
        free_card()
        # every rank keeps its views only while the steps run; rank 0 draws the
        # whole tree again from the seed for its one-rank step after them
        _, mine, g = lm_rank_params(cfg, layout, LM_RANKS["seed"], torch.float32,
                                    keep_full=False)
        tokens = torch.randint(0, cfg.vocab_size, (2, B, S), generator=g, device="cuda",
                               dtype=torch.int32)
        bspec = cell.arg_specs[2]
        local = [mine, state(mine), rank_views(tokens[0], bspec, layout),
                 rank_views(tokens[1], bspec, layout)]
        del mine
        label = f"qwen3-0.6b train_4k in {str(dtype).replace('torch.', '')}"
        first = None if main else {}
        steps = LM_RANKS["train_steps"] if main else 1
        (params, _), _, rep = cell_steps(layout, label, cell, local, steps, first)
        del local
        rep.update(batch=B, model_coll_bytes=cell.model_coll_bytes, note=cell.note)
        if main:
            out.update(rep)
            del params, tokens
            free_card()
            continue
        one = base.build_lm_cell(cfg, "train_4k", None, micro_per_device=2, batch=B)
        rep.update(params=params, first=first, one_note=one.note)
        del params, first
        args = None
        if layout.rank == 0:
            full = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(LM_RANKS["seed"]),
                                  "cuda", torch.float32)
            args = [full, state(full), tokens[0], tokens[1]]
            del full
        held_against_one_rank(layout, "qwen3-0.6b train_4k at (1, 2, 2) in f32", cell, one, args,
                              1, rep)
        out["check"] = rep
        del args, tokens
        free_card()
    return out


def lm_serve_steps(layout, cells, params, cache, plan):
    """The serving main path on this rank: each (cell, tokens [global], cache_len)
    of ``plan`` through ``cell.fn`` on the rank's views, the cache carried;
    the first call of each cell under ``count_collectives`` with every
    row-gradient launch held; every call timed (host ms to a synchronize, with the
    collectives' clock; a counted call is marked). Returns (each step's
    logits, the timed steps, the counted steps' collectives, the held
    launches)."""
    from repro_torch.dist import analysis
    logits_out, timed, counted, held = [], [], {}, 0
    for name, toks, cl in plan:
        cell = cells[name]
        mine = rank_views(toks, cell.arg_specs[1], layout)
        cl = torch.tensor(cl, dtype=torch.int32, device="cuda")
        sync_ranks(layout)
        t0 = time.perf_counter()
        first = name not in counted
        if first:
            with held_bwd() as bwds, CollectiveClock() as clock:
                cost, (_, logits, cache) = analysis.count_collectives(cell.fn, params, mine,
                                                                      cache, cl)
            counted[name] = (cost.collectives, cost.collective_bytes)
            held += len(bwds)
        else:
            with CollectiveClock() as clock:
                _, logits, cache = cell.fn(params, mine, cache, cl)
        torch.cuda.synchronize()
        timed.append(dict(step=name, ms=(time.perf_counter() - t0) * 1e3, coll_ms=clock.ms,
                          counted=first))
        logits_out.append(logits.clone())
    return logits_out, timed, counted, held


def lm_held_serving(layout, label, cfg, ones, full, cache_shape, plan, logits, tol, routes=None,
                    rows=None):
    """Rank 0: the one-rank cells ``ones`` through the same ``plan`` on the
    global parameters and a cache of zeros, each step's logits against the
    ranks' (assembled on rank 0), within ``tol`` for every row; a row may
    part only from its first router flip on, where the one-rank router's
    top-k gap is below ``LM['tie_eps']`` (an MoE, ``routes``). ``rows``
    (first position, {"k", "v"} blocks of the ranks' cache window under
    the cache's spec, from ``boundary_rows``): the window, assembled on
    rank 0, against the one-rank cache's positions there, within ``tol``."""
    from repro_torch.dist import sharding as shd
    from repro_torch.models import moe
    got = [gather_to_rank0(x, (shd.dp_axes(), "model"), layout) for x in logits]
    if rows is not None:
        at, blocks = rows
        spec = shd.lm_cache_spec()
        rows = {k: gather_to_rank0(v, spec, layout) for k, v in blocks.items()}
        del blocks
    out = None
    if layout.rank == 0:
        cache = {k: torch.zeros(cache_shape, dtype=cfg.dtype, device="cuda") for k in "kv"}
        want = []
        with routes_of(moe) as ref_routes:
            for name, toks, cl in plan:
                _, w, cache = ones[name].fn(full, toks, cache, cl)
                want.append(w)
        cache_diff = None
        if rows is not None:
            rtol, atol = tol
            cache_diff = 0.0
            for k, a in rows.items():
                w = cache[k][:, :, at:at + a.shape[2]]
                d = (a - w).abs()
                cache_diff = max(cache_diff, float(d.max()))
                if not bool((d <= atol + rtol * w.abs()).all()):
                    raise AssertionError(f"{label}: the cache's {k} rows at [{at}, "
                                         f"{at + a.shape[2]}) part from one rank's by "
                                         f"{float(d.max()):.4g} (|Δ| ≤ {atol} + {rtol}·|value|)")
            del rows
        del cache
        excused, flips = set(), {}
        if routes is not None:
            k = cfg.moe.top_k
            for j, ((p1, e1), (_, e2)) in enumerate(zip(ref_routes, routes)):
                for b in range(e1.shape[0]):
                    if b in excused or torch.equal(torch.sort(e1[b]).values,
                                                   torch.sort(e2[b]).values):
                        continue
                    p = torch.sort(p1[b], descending=True).values
                    gap = float(p[k - 1] - p[k])
                    if not gap < LM["tie_eps"]:
                        raise AssertionError(f"{label}: a router flip at call {j}, row {b}, "
                                             f"that is no near-tie (gap {gap:.3g})")
                    excused.add(b)
                    flips[b] = dict(call=j, gap=gap)
        rtol, atol = tol
        worst, agree, n_rows = 0.0, [], 0
        for i, (a, w) in enumerate(zip(got, want)):
            d = (a - w).abs()
            ok = (d <= atol + rtol * w.abs()).all(-1)
            for b in range(ok.shape[0]):
                if b in excused and flips[b]["call"] // cfg.n_layers <= i:
                    continue
                n_rows += 1
                worst = max(worst, float(d[b].max()))
                if not bool(ok[b]):
                    raise AssertionError(f"{label}: step {i} row {b}: logits part from the "
                                         f"one-rank step's by {float(d[b].max()):.4g} "
                                         f"(|Δ| ≤ {atol} + {rtol}·|logit|)")
            agree.append(float((a.argmax(-1) == w.argmax(-1)).float().mean()))
        out = dict(max_logit_diff=worst, argmax_agree=agree, rows_held=n_rows, flips=flips,
                   max_cache_diff=cache_diff)
        del want
    del got
    sync_ranks(layout)
    return out


def boundary_rows(cache, layout, w):
    """The rank's rows of the cache window [S/M − w, S/M + w) around the
    boundary of the first two "model" slices (model index 0: its last w
    positions, 1: its first w), as this rank's blocks of the window
    [L, B, 2w, KV, dh] under the cache's spec (M = 2)."""
    S_loc = cache["k"].shape[2]
    part = slice(S_loc - w, S_loc) if layout.model_index == 0 else slice(0, w)
    return {k: cache[k][:, :, part].clone() for k in "kv"}


def lm_ranks_serve(layout):
    """[lm-ranks] qwen3-0.6b prefill_32k's last chunk and 4 decode_32k steps
    at (1, 2, 2), B = 2, in bf16 (the main path: counted, held, timed);
    then the check in f32 (as ``lm_serve`` checks an MoE: in bf16 the ranks'
    sums round apart from one rank's, 0.11 on a logit at full depth on an
    H100): a prefill chunk at cache_len S/2 − C/2, across the boundary of
    the two slices (the rows of its first half find no valid position in
    the second slice and enter the combine with weight 0), a decode at S/2
    + C/2 (both slices hold written rows, so each slice's output is
    rescaled) and one at the last position, against rank 0's one-rank
    steps: every row's logits and the cache rows around the boundary
    (the chunk's and the first decode's) within ``LM['tol']['float32']``."""
    import dataclasses
    from repro_torch.configs import base, lm_archs as la
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels.embedding_bag import ops
    cfg, B = la.QWEN3_0_6B, LM_RANKS["serve_batch"]
    S = base.LM_SHAPES["prefill_32k"]["seq_len"]
    C = min(4096, S)                                   # the prefill cell's chunk
    if layout.model != 2:
        raise ValueError("the serving check's window spans two model slices")
    S_loc, w = S // 2, C // 2 + 1
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)
    out = dict(batch=B)
    for dtype in (cfg.dtype, torch.float32):
        c = dataclasses.replace(cfg, dtype=dtype)
        cells = {s_: base.build_lm_cell(c, s_, layout, batch=B)
                 for s_ in ("prefill_32k", "decode_32k")}
        main = dtype == cfg.dtype
        free_card()
        full, mine, g = lm_rank_params(c, layout, LM_RANKS["seed"] + 1, dtype, keep_full=not main)
        ri = lambda *sh: torch.randint(0, c.vocab_size, sh, generator=g, device="cuda",
                                       dtype=torch.int32)
        if main:
            plan = [("prefill_32k", ri(B, C), S - C)]
            plan += [("decode_32k", ri(B, 1), cl) for cl in LM_RANKS["decodes"]]
        else:
            plan = [("prefill_32k", ri(B, C), S_loc - C // 2),
                    ("decode_32k", ri(B, 1), S_loc + C // 2), ("decode_32k", ri(B, 1), S - 1)]
        local = shd.block_shape(shape, cells["prefill_32k"].arg_specs[2]["k"], layout)
        cache = {k: torch.zeros(local, dtype=dtype, device="cuda") for k in "kv"}
        bag0, bwd0 = ops.launches, ops.bwd_launches
        logits, timed, counted, held = lm_serve_steps(layout, cells, mine, cache, plan)
        if not all(bool(torch.isfinite(x).all()) for x in logits):
            raise AssertionError(f"qwen3-0.6b serving across ranks in {dtype}: non-finite logits")
        if main:
            out.update(timed=timed, counted=counted, held=held, bag=ops.launches - bag0,
                       bwd=ops.bwd_launches - bwd0, peak=peak_gib(),
                       model_coll_bytes={s_: x.model_coll_bytes for s_, x in cells.items()})
        rows = None if main else (S_loc - w, boundary_rows(cache, layout, w))
        del cache, mine
        free_card()
        if not main:
            ones = {s_: base.build_lm_cell(c, s_, None, batch=B)
                    for s_ in ("prefill_32k", "decode_32k")}
            out["check"] = lm_held_serving(layout, "qwen3-0.6b serving at (1, 2, 2) in f32", c,
                                           ones, full, shape, plan, logits, LM["tol"]["float32"],
                                           rows=rows)
            out["check_plan"] = [(name, cl) for name, _, cl in plan]
        del full, logits, rows
        free_card()
    return out


def lm_ranks_moe(layout, cfg, name):
    """[lm-ranks] ``cfg`` at ``LM_RANKS['moe_layers']`` layers at (1, 1, 4):
    decode_32k steps in f32 at capacity factor E/k (no pair drops) at B = 4
    (``LM_RANKS['moe_decodes']``), against rank 0's one-rank steps."""
    import dataclasses
    from repro_torch.configs import base
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.models import moe
    m = cfg.moe
    cfg = dataclasses.replace(cfg, n_layers=LM_RANKS["moe_layers"], dtype=torch.float32,
                              moe=dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k))
    B, S = LM_RANKS["moe_batch"], base.LM_SHAPES["decode_32k"]["seq_len"]
    cells = {"decode_32k": base.build_lm_cell(cfg, "decode_32k", layout, batch=B)}
    ones = {"decode_32k": base.build_lm_cell(cfg, "decode_32k", None, batch=B)}
    free_card()
    full, mine, g = lm_rank_params(cfg, layout, LM_RANKS["seed"] + 2, torch.float32)
    plan = [("decode_32k", torch.randint(0, cfg.vocab_size, (B, 1), generator=g, device="cuda",
                                         dtype=torch.int32), cl)
            for cl in LM_RANKS["moe_decodes"]]
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)
    local = shd.block_shape(shape, cells["decode_32k"].arg_specs[2]["k"], layout)
    cache = {k: torch.zeros(local, dtype=cfg.dtype, device="cuda") for k in "kv"}
    bag0, bwd0 = ops.launches, ops.bwd_launches
    with routes_of(moe) as routes:
        logits, timed, counted, held = lm_serve_steps(layout, cells, mine, cache, plan)
    bwd = ops.bwd_launches - bwd0
    peak = peak_gib()
    del cache, mine
    free_card()
    rep = lm_held_serving(layout, f"{name} decode at (1, 1, 4)", cfg, ones, full, shape, plan,
                          logits, LM["tol"]["float32"], routes)
    del full, logits, routes
    free_card()
    return dict(timed=timed, counted=counted, held=held, bag=ops.launches - bag0, bwd=bwd,
                peak=peak, check=rep, batch=B, n_params=cfg.n_params,
                placement=(f"{m.n_experts // layout.model} of {m.n_experts} experts a rank"
                           if m.moe_shard == "expert" else
                           f"{m.d_ff_expert // layout.model} of each expert's {m.d_ff_expert} "
                           "d_ff columns a rank"),
                model_coll_bytes={"decode_32k": cells["decode_32k"].model_coll_bytes})


def lm_ranks(layout):
    """[lm-ranks]: qwen3-0.6b train and serving at (1, 2, 2), the two MoE
    decodes at (1, 1, 4), on this rank of stream_world's 4."""
    from repro_torch.configs import lm_archs as la
    from repro_torch.launch import mesh
    lay22, lay14 = mesh.relayout(layout, 1, 2, 2), mesh.relayout(layout, 1, 1, 4)
    out, t = {}, {}
    for key, fn in (("qwen3-0.6b train_4k", lambda: lm_ranks_train(lay22)),
                    ("qwen3-0.6b serving", lambda: lm_ranks_serve(lay22)),
                    ("qwen2-moe-a2.7b decode", lambda: lm_ranks_moe(lay14, la.QWEN2_MOE,
                                                                    "qwen2-moe-a2.7b")),
                    ("phi3.5-moe decode", lambda: lm_ranks_moe(lay14, la.PHI35_MOE,
                                                               "phi3.5-moe-42b-a6.6b"))):
        t0 = time.perf_counter()
        out[key] = fn()
        t[key] = time.perf_counter() - t0
        rank0_log(layout, f"[lm-ranks] {key} done in {t[key]:.1f} s")
    out["seconds"] = t
    return out


def lm_ranks_report(res, card, launches):
    """Check and print [lm-ranks]; adds the row-gradient launches by path
    (summed over the ranks) to ``launches["bwd"]``."""
    W = len(res)
    bwd = launches["bwd"]
    secs = res[0]["lm"]["seconds"]
    tr = [r["lm"]["qwen3-0.6b train_4k"] for r in res]
    ck = [x["check"] for x in tr]
    r0, c0 = tr[0], ck[0]
    bwd["ranks_lm_qwen3_train"] = sum(x["bwd"] for x in tr)
    if bwd["ranks_lm_qwen3_train"] == 0:
        raise AssertionError("[lm-ranks] qwen3-0.6b train launched no row-gradient kernel")
    n = len(r0["losses"])
    log(f"[lm-ranks] qwen3-0.6b train_4k at (1, 2, 2) at full width (reduced: one microbatch "
        f"of 2 sequences a data replica: global batch {r0['batch']} of 256; {r0['note']}) in "
        f"bf16: {n} step{'s' if n > 1 else ''}, step {r0['step_ms']:.1f} ms ({r0['timed']}; "
        f"ranks {[round(x['step_ms'], 1) for x in tr]}), losses "
        f"{[round(x, 6) for x in r0['losses']]}; replicas the same bits; step 1 held: "
        f"{sum(x['held_bwd'] for x in tr)} embedding_bag_bwd launches equal to their plain "
        f"versions; launches {bwd['ranks_lm_qwen3_train']}; peak GiB a rank "
        f"{[round(x['peak'], 2) for x in tr]}; {coll_text(r0, W)}; card {card}")
    log(f"[lm-ranks] qwen3-0.6b train_4k at (1, 2, 2) computing in f32, from the same "
        f"parameters and tokens: 1 step, step {c0['step_ms']:.1f} ms ({c0['timed']}; ranks "
        f"{[round(x['step_ms'], 1) for x in ck]}), loss {round(c0['losses'][0], 6)}; against "
        f"the one-rank step ({c0['one_note']}): losses rtol {RANKS['loss_rtol']:g} (max "
        f"{c0['max_loss_rel']:.2g}), parameters |Δ| ≤ {RANKS['dense_tol']:g} (max "
        f"{c0['max_dense']:.3g}), AdamW m and v after step 1 ‖Δ‖ / ‖value‖ ≤ "
        f"{RANKS['moment_rtol']:g} (max {c0['max_moment']:.3g}); replicas the same bits; "
        f"{sum(x['held_bwd'] for x in ck)} held embedding_bag_bwd launches equal to their "
        f"plain versions; peak GiB a rank {[round(x['peak'], 2) for x in ck]}; "
        f"{coll_text(c0, W)}; {secs['qwen3-0.6b train_4k']:.1f} s for both ("
        f"{c0['gather_s']:.1f} s the blocks to rank 0, {c0['one_rank_s']:.1f} s the one-rank "
        f"step and the holds); card {card}")
    for key, tag, mesh_s in (("qwen3-0.6b serving", "ranks_lm_qwen3_serve", "(1, 2, 2)"),
                             ("qwen2-moe-a2.7b decode", "ranks_lm_qwen2_moe_decode",
                              "(1, 1, 4)"),
                             ("phi3.5-moe decode", "ranks_lm_phi35_moe_decode", "(1, 1, 4)")):
        reps = [r["lm"][key] for r in res]
        r0 = reps[0]
        bwd[tag] = sum(x["bwd"] for x in reps)
        if "moe" in key and bwd[tag] == 0:
            raise AssertionError(f"[lm-ranks] {key}: no row-gradient launch")
        steps = {}
        for x in r0["timed"]:
            steps.setdefault(x["step"], []).append(x)
        timing = "; ".join(
            f"{s} {[round(x['ms'], 2) for x in xs]} ms a step, the first counted and held "
            f"(collectives {[round(x['coll_ms'], 2) for x in xs]} ms; counted step: "
            + ", ".join(f"{k} {int(v)}" for k, v in sorted(r0['counted'][s][0].items()))
            + f" calls, {sum(r0['counted'][s][1].values()):,.0f} bytes a rank; JAX's formula "
            f"{r0['model_coll_bytes'][s]:,.0f} over the ranks)" for s, xs in steps.items())
        c = r0["check"]
        cut = (f"at {LM_RANKS['moe_layers']} layers, f32, capacity factor E/k, B = "
               f"{r0['batch']}, {r0['placement']}; reduced: depth, batch "
               f"{r0['batch']} of 128" if "moe" in key else
               f"in bf16 at B = {r0['batch']}; reduced: batch {r0['batch']} of 32 / 128")
        plan = ("" if "check_plan" not in r0 else " (" + ", ".join(
            f"{name} at cache_len {cl:,}" for name, cl in r0["check_plan"]) + ")")
        log(f"[lm-ranks] {key} at {mesh_s} at full width {cut}: {timing}; checked in f32{plan} "
            f"against the one-rank steps: every held row's logits within {LM['tol']['float32']} "
            f"(max |Δ| {c['max_logit_diff']:.4g}, {c['rows_held']} rows), argmax agrees "
            f"{[round(a, 4) for a in c['argmax_agree']]}"
            + (f", the cache rows around the slices' boundary within the same (max |Δ| "
               f"{c['max_cache_diff']:.4g})" if c.get("max_cache_diff") is not None else "")
            + (f", router flips (near-ties, excused) {c['flips'] or 'none'}" if "moe" in key
               else "")
            + f"; {sum(x['held'] for x in reps)} held embedding_bag_bwd launches equal to their "
            f"plain versions, launches {bwd[tag]}; peak GiB a rank "
            f"{[round(x['peak'], 2) for x in reps]}; {secs[key]:.1f} s; card {card}")


# [lda-serve-ranks]: peacock-lda's serve_rt across stream_world's 4 ranks at
# K = 100,000 (not cut) and V = 32,768 (cut from 210,000, as every LDA cell:
# rank 0's one-rank reference holds the whole 13.1 GB P̂), B = 1,024 queries
# of 1-8 tokens, 2 trials × 5 hill steps, seed 17 (JAX's cell); P̂ and the R
# cache row-sharded over the ring of 4 (a rank's quarter is the same at
# (1, 1, 4) and at (1, 2, 2)), pkd's columns split over "model"
LDA_SERVE = dict(seed=29, meshes=((1, 1, 4), (1, 2, 2)), steps=3)


def timed_step(layout, fn, *args):
    """(``fn(*args)``, host ms to a synchronize, its collectives' ms), the
    ranks of ``layout`` meeting first (``layout`` None: one rank)."""
    if layout is None:
        torch.cuda.synchronize()
    else:
        sync_ranks(layout)
    t0 = time.perf_counter()
    with CollectiveClock() as clock:
        out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, clock.ms


def lda_serve_ranks(layout):
    """[lda-serve-ranks] on this rank of stream_world's 4: the global
    arguments drawn by ``serve_cell``'s ``make_args`` on one rank after
    another (rank 0 first: its one-rank steps on them, timed, are the
    reference; each rank keeps its quarter of P̂ and the R cache, 3.3 GB,
    and lets go of the rest), then at each mesh of ``LDA_SERVE`` one step
    counted (``count_collectives``) and ``LDA_SERVE["steps"]`` timed with
    the collectives' clock; every rank's pkd columns, gathered over "world",
    against the reference bit for bit on rank 0."""
    from repro_torch.configs import peacock_lda as pl
    from repro_torch.dist import analysis, collectives as coll, sharding as shd
    from repro_torch.launch import mesh
    V, K, n = FULL["vocab"], FULL["n_topics"], LDA_SERVE["steps"]
    lays = [mesh.relayout(layout, *shape) for shape in LDA_SERVE["meshes"]]
    if len({shd.flat_ring_index(lay) for lay in lays}) != 1:
        raise AssertionError("[lda-serve-ranks] the meshes give this rank other ring blocks")
    one = pl.serve_cell(V, K)
    free_card()
    sync_ranks(layout)
    t0 = time.perf_counter()
    ref, one_ms, local = None, [], None
    for r in range(layout.world_size):
        if layout.rank == r:
            t1 = time.perf_counter()
            g = torch.Generator(device="cuda").manual_seed(LDA_SERVE["seed"])
            args = one.make_args(g, "cuda")
            torch.cuda.synchronize()
            own_draw_s = time.perf_counter() - t1
            if r == 0:
                for _ in range(n):
                    pkd, ms, _ = timed_step(None, one.fn, *args)
                    if ref is not None and not torch.equal(pkd, ref):
                        raise AssertionError("[lda-serve-ranks] two one-rank steps differ")
                    ref, one_ms = pkd, one_ms + [ms]
            local = rank_views(args, one.arg_specs, lays[0])
            del args
            free_card()
        sync_ranks(layout)
    out = dict(draw_s=time.perf_counter() - t0, own_draw_s=own_draw_s, one_ms=one_ms,
               meshes={})
    if ref is not None:
        sums = ref.double().sum(dim=1)
        if tuple(ref.shape) != (1024, K) or not bool(torch.isfinite(ref).all()) or \
                float((sums - 1).abs().max()) > 1e-4:
            raise AssertionError(f"[lda-serve-ranks] the one-rank pkd: shape {tuple(ref.shape)}, "
                                 f"row sums {float(sums.min())} … {float(sums.max())}")
        out["queries"] = int((local[4] >= 0).sum())
    for lay in lays:
        cell = pl.serve_cell(V, K, lay)
        free_card()
        sync_ranks(layout)
        cost, first = analysis.count_collectives(cell.fn, *local)
        times, coll_ms = [], []
        for _ in range(n):
            pkd, ms, c_ms = timed_step(layout, cell.fn, *local)
            times.append(ms)
            coll_ms.append(c_ms)
        peak = peak_gib()
        if not torch.equal(pkd, first):
            raise AssertionError(f"[lda-serve-ranks] {lay.shape}: rank {layout.rank}'s steps "
                                 "differ")
        parts = coll.all_gather(pkd, lay, "world")
        if layout.rank == 0:
            for r in range(layout.world_size):
                lo, hi = shd.row_slice(K, lay.at(r), "model")
                if not torch.equal(parts[r], ref[:, lo:hi]):
                    err = float((parts[r] - ref[:, lo:hi]).abs().max())
                    raise AssertionError(f"[lda-serve-ranks] {lay.shape}: rank {r}'s pkd columns "
                                         f"[{lo}, {hi}) differ from the one-rank step's (max "
                                         f"|Δ| {err:.3g})")
        out["meshes"][lay.shape] = dict(
            step_ms=float(np.median(times)), coll_ms=float(np.median(coll_ms)), times=times,
            coll_calls=cost.collectives, coll_bytes=cost.collective_bytes,
            model_coll_bytes=cell.model_coll_bytes, peak=peak, columns=tuple(pkd.shape))
        del parts, pkd, first
    del local, ref
    free_card()
    return out


def lda_serve_report(res, card):
    """Check and print [lda-serve-ranks]: each mesh's step, its collectives
    against the port's formula (JAX's ``model_coll_bytes`` and the two
    [B, Ld] reads of the R topics and of P̂ at them)."""
    B, Ld = 1024, 8
    rs = [r["lda_serve"] for r in res]
    r0 = rs[0]
    log(f"[lda-serve-ranks] peacock-lda serve_rt: K = {FULL['n_topics']:,}, V = "
        f"{FULL['vocab']:,} (reduced: V, from 210,000), B = {B:,} queries ({r0['queries']:,} "
        f"tokens of 1-{Ld} a query, −1 padded), 2 trials × 5 hill steps; the arguments drawn "
        f"on each rank in turn, a quarter of P̂ kept ({max(r['draw_s'] for r in rs):.1f} s with "
        f"rank 0's one-rank steps; a rank's draw {[round(r['own_draw_s'], 2) for r in rs]} s); "
        f"one-rank step {float(np.median(r0['one_ms'])):.2f} ms "
        f"(median of {len(r0['one_ms'])}: {[round(x, 2) for x in r0['one_ms']]}); card {card}")
    for shape in LDA_SERVE["meshes"]:
        ms = [r["meshes"][shape] for r in rs]
        m0 = ms[0]
        want = m0["model_coll_bytes"] + 8.0 * B * Ld
        for i, m in enumerate(ms):
            if m["coll_calls"] != {"psum": 12.0} or m["coll_bytes"] != {"psum": want}:
                raise AssertionError(f"[lda-serve-ranks] {shape}: rank {i}'s collectives "
                                     f"{m['coll_calls']} {m['coll_bytes']}, expected 12 sums of "
                                     f"{want:,.0f} bytes")
        log(f"[lda-serve-ranks] {shape}: P̂ and the R cache row-sharded over the ring of 4, "
            f"pkd {m0['columns']} a rank: step {m0['step_ms']:.2f} ms (median of "
            f"{len(m0['times'])}, rank 0; ranks {[round(m['step_ms'], 2) for m in ms]}), its "
            f"collectives {m0['coll_ms']:.2f} ms ({m0['coll_ms'] / m0['step_ms']:.0%}; ranks "
            f"{[round(m['coll_ms'], 2) for m in ms]}): 12 sums over 'ring', "
            f"{want:,.0f} bytes a rank (JAX's model_coll_bytes {m0['model_coll_bytes']:,.0f} + "
            f"the two [B, Ld] reads {8 * B * Ld:,}); every rank's pkd columns equal the one-rank "
            f"step's bit for bit; peak GiB a rank {[round(m['peak'], 2) for m in ms]}; card "
            f"{card}")


def card_collectives_rank(layout):
    """[coll-card] On this rank of 4 that share the card: the collectives
    through workspaces on the card against gloo through host memory (the
    same groups, seen as ranks of a card each): int64 sums and maxes, f32
    and bf16 maxes and every gather the same bits, f32 sums within 10⁻⁶
    relative, bf16 sums within one bf16 rounding of the sum, and every sum
    the same bits on every rank of its group, over "world" and (1, 2, 2)'s
    "model" and "data" (over "world" also at a size across a workspace's
    half); then the host ms of a 32 MiB f32 sum and a 6 MiB gather over
    "world" each way."""
    import dataclasses
    from repro_torch.dist import collectives as coll
    from repro_torch.launch import mesh
    lay22 = mesh.relayout(layout, 1, 2, 2)
    g = torch.Generator(device="cuda").manual_seed(RANKS["seed"] + 9 + layout.rank)
    n_checks = 0
    for lay, name in ((layout, "world"), (lay22, "model"), (lay22, "data")):
        host = dataclasses.replace(lay, ranks_per_device=1)
        for dtype in (torch.int64, torch.float32, torch.bfloat16):
            for n in (1, 1031) + ((coll.CARD_CHUNK // 4 + 13,) if name == "world" else ()):
                x = (torch.randint(-1000, 1000, (n,), generator=g, device="cuda") if
                     dtype == torch.int64 else torch.randn(n, generator=g, device="cuda")).to(dtype)
                for op in ("sum", "max"):
                    got = coll.all_reduce_(x.clone(), lay, name, op)
                    want = coll.all_reduce_(x.clone(), host, name, op)
                    if op == "max" or dtype == torch.int64:
                        ok = torch.equal(got, want)
                    else:
                        ref = coll.all_reduce_(x.double(), host, name)   # the sum in f64
                        err = (got.double() - ref).abs()
                        lim = (1e-6 * ref.abs().clamp_min(1.0) if dtype == torch.float32 else
                               2.0 ** -8 * ref.abs() + 1e-6)
                        ok = bool((err <= lim).all())
                    if op == "sum":
                        same_on_ranks(lay, name, {"x": got}, f"[coll-card] {name} {dtype} sum")
                    if not ok:
                        raise AssertionError(f"[coll-card] {op} of {n} {dtype} over {name!r}: the "
                                             f"card's workspaces differ from the host path")
                    n_checks += 1
                if not torch.equal(coll.all_gather(x, lay, name), coll.all_gather(x, host, name)):
                    raise AssertionError(f"[coll-card] all_gather of {n} {dtype} over {name!r}: "
                                         f"the card's workspaces differ from the host path")
                n_checks += 1
    host = dataclasses.replace(layout, ranks_per_device=1)
    x = torch.randn(1 << 23, generator=g, device="cuda")
    w = torch.randn(1 << 19, 3, generator=g, device="cuda")
    ms = {}
    for which, lay, reps in (("card", layout, 20), ("host", host, 3)):
        for kind, fn in (("sum", lambda L: coll.all_reduce_(x.clone(), L, "world")),
                         ("gather", lambda L: coll.all_gather(w, L, "world"))):
            sync_ranks(layout)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(lay)
            torch.cuda.synchronize()
            ms[f"{which}_{kind}"] = (time.perf_counter() - t0) * 1e3 / reps
    del x, w
    free_card()
    return dict(checks=n_checks, ms=ms)


def card_coll_report(res, card):
    """Print [coll-card] (``card_collectives_rank``'s numbers, rank 0's and
    the slowest rank's)."""
    c = [r["coll_card"] for r in res]
    ms = {k: (c[0]["ms"][k], max(x["ms"][k] for x in c)) for k in c[0]["ms"]}
    log(f"[coll-card] 4 ranks on one card, collectives through workspaces on the card held "
        f"against gloo through host memory: {sum(x['checks'] for x in c)} checks passed (sums, "
        f"maxes and gathers of int64, f32 and bf16 over 'world' and (1, 2, 2)'s 'model' and "
        f"'data'; every sum the same bits on its group's ranks); a 32 MiB f32 sum over 4 ranks "
        f"{ms['card_sum'][0]:.3f} ms on the card (slowest rank {ms['card_sum'][1]:.3f}) against "
        f"{ms['host_sum'][0]:.3f} ({ms['host_sum'][1]:.3f}) through host memory; a 6 MiB "
        f"gather {ms['card_gather'][0]:.3f} ({ms['card_gather'][1]:.3f}) against "
        f"{ms['host_gather'][0]:.3f} ({ms['host_gather'][1]:.3f}); card {card}")


def stream_world(layout, dirs, L, small):
    """One world of 4 ranks on the card: [coll-card], [stream-ranks] 4×1 (dense, prefetch
    on/off, alias), word-sharded 2×2 against 2×1 (pod 0 of a 2 × 2×1 mesh),
    SMALL's streamed 2×2 ring card vs CPU, then [lookup_sharded] and
    [recsys-ranks] dlrm-mlperf at (1, 1, 4), [recsys-ranks] xdeepfm, din and
    autoint and [gnn-ranks] graphsage-reddit at (1, 2, 2), [lm-ranks],
    [lda-serve-ranks]."""
    from repro_torch.launch import mesh
    t, out = {}, {}
    t0 = time.perf_counter()
    out["coll_card"] = card_collectives_rank(layout)
    t["coll_card"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["ring"] = stream_ring_rank(layout, dirs["4x1"], L)
    t["ring"] = time.perf_counter() - t0
    rank0_log(layout, f"[stream-ranks] 4x1 done in {t['ring']:.1f} s")
    lay22 = mesh.relayout(layout, 1, 2, 2)
    t0 = time.perf_counter()
    out["wshard"] = stream_wshard_rank(lay22, dirs["2x2_p2"], reference=False)
    t["wshard"] = time.perf_counter() - t0
    lay_pods = mesh.relayout(layout, 2, 2, 1)
    t0 = time.perf_counter()
    if lay_pods.pod_index == 0:
        out["wshard_ref"] = stream_wshard_rank(pod0_ring_layout(lay_pods), dirs["2x1"],
                                               reference=True)
    torch.distributed.barrier()
    t["wshard_ref"] = time.perf_counter() - t0
    rank0_log(layout, f"[stream-ranks] word-sharded 2x2 {t['wshard']:.1f} s, 2x1 "
                      f"{t['wshard_ref']:.1f} s")
    t0 = time.perf_counter()
    out["small"] = stream_small_rank(lay22, small)
    t["small"] = time.perf_counter() - t0
    lay14 = mesh.relayout(layout, 1, 1, 4)
    t0 = time.perf_counter()
    out["lookup"], shard = lookup_rank(lay14)
    t["lookup"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["dlrm"] = dlrm_ranks(lay14, shard)
    del shard
    t["recsys_dlrm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["recsys_22"] = recsys_ranks_22(lay22)
    t["recsys_22"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["gnn_22"] = gnn_ranks(lay22)
    t["gnn_22"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["lm"] = lm_ranks(layout)
    t["lm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["lda_serve"] = lda_serve_ranks(layout)
    t["lda_serve"] = time.perf_counter() - t0
    rank0_log(layout, f"[lda-serve-ranks] done in {t['lda_serve']:.1f} s")
    out["seconds"] = t
    return out


def stream_ranks_phase(base):
    """[stream-ranks], [stream-ranks card vs cpu] and [lookup_sharded]: the
    streamed ring of several ranks at full width (the streamed cell's corpus
    from save_segments directories) and the row-sharded lookup at full
    width, in one spawned world of 4 ranks on the card."""
    import shutil
    from repro_torch.data import sources, synthetic
    from repro_torch.launch import mesh
    K, S = FULL["n_topics"], STREAM_RANKS
    root = os.path.join(ROOT, "build", "chip_smoke_stream_ranks")
    shutil.rmtree(root, ignore_errors=True)
    corpus = tile_corpus(base, STREAM["tiles"])
    dirs, caps = {}, {}
    t0 = time.perf_counter()
    for name, M, P, n_seg in (("4x1", 4, 1, S["segments"]), ("2x2_p2", 2, 2, S["wshard_segments"]),
                              ("2x1", 2, 1, S["wshard_segments"])):
        dirs[name] = os.path.join(root, name)
        sources.save_segments(sources.InMemorySource(corpus, n_seg, M, M, K, seed=1,
                                                     n_model_shards=P), dirs[name])
        caps[name] = sources.open_segments(dirs[name]).cap
    save_s = time.perf_counter() - t0
    T = corpus.n_tokens
    del corpus
    L = package_len_for(caps["4x1"], S["max_package"])
    small, _ = synthetic.lda_corpus(seed=0, n_docs=SMALL["n_docs"], n_topics=SMALL["gen_topics"],
                                    vocab_size=SMALL["vocab"], doc_len_mean=9)
    log(f"[stream-ranks] {T} tokens saved as {S['segments']} segments for a 4x1 ring (cap "
        f"{caps['4x1']}, package_len {L}) and {S['wshard_segments']} for 2x2 P=2 (cap "
        f"{caps['2x2_p2']}) and 2x1 (cap {caps['2x1']}) in {save_s:.1f} s")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    t0 = time.perf_counter()
    res = mesh.spawn(stream_world, data=4, device="cuda", ranks_per_device=4, backend="gloo",
                     args=(dirs, L, small))
    t_w = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    card = card_line()
    secs = res[0]["seconds"]
    log(f"[stream-ranks] world of 4 ranks on one card: {t_w:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + f"); card {card}")
    return stream_ranks_report(res, T, caps, L, card)


def stream_ranks_report(res, T, caps, L, card):
    """Check and print what the streamed world returned; returns the
    launches by path."""
    S = STREAM_RANKS
    launches = {}
    ring = [r["ring"]["dense"] for r in res]
    n = _sum_counts(ring, lambda r: r["launches"])
    want = S["epochs"] * S["segments"] * S["ring"] * (caps["4x1"] // L) * S["ring"]
    if n["gibbs_argmax"] != want:
        raise AssertionError(f"streamed 4x1 dense: gibbs_argmax launched {n}, expected {want}")
    launches["stream_ring_4x1_dense"] = n
    for e in range(S["epochs"]):
        ep_s = max(r["rows"][e]["epoch_s"] for r in ring)
        log(f"[stream-ranks] 4x1 dense epoch {e}: {T / ep_s:.1f} tokens/s (slowest rank's "
            f"epoch_s {ep_s:.4f}); per rank LoadShard / wait / SaveShard ms a segment "
            + "; ".join(f"r{i} {r['rows'][e]['load_shard_ms']:.2f} / {r['rows'][e]['load_wait_ms']:.2f}"
                        f" / {r['rows'][e]['save_shard_ms']:.2f}" for i, r in enumerate(ring)))
    r0 = ring[0]
    log(f"[stream-ranks] 4x1 dense ({S['epochs']} epochs, α from epoch {S['alpha_from']}, "
        f"{S['segments']} segments, packages of {L}): launches {n} (expected {want}); word LL "
        f"{[f'{x:.6e}' for x in r0['ll']]}; α sum {r0['alpha_sum']:.4f}; fit s per rank "
        f"{[round(r['fit_s'], 2) for r in ring]}; peak GiB per rank "
        f"{[round(r['peak'], 2) for r in ring]} (sum {sum(r['peak'] for r in ring):.2f}); stream "
        f"ms a segment by rank over the fit (LoadShard / wait / SaveShard) "
        + "; ".join(f"{x['load_shard_ms']:.2f} / {x['load_wait_ms']:.2f} / {x['save_shard_ms']:.2f}"
                    for x in r0["by_rank"]) + f"; card {card}")
    log(f"[stream-ranks] rotation of a segment's block (wl, dl, uid, then z; one hop through "
        f"pinned host memory): {r0['rotation_ms']:.3f} ms a round (ranks "
        f"{[round(r['rotation_ms'], 3) for r in ring]}), {r0['rotation_bytes']} bytes a rank; Ψ "
        f"all_reduce ({r0['psi_bytes']} bytes) {r0['psi_reduce_ms']:.3f} ms (ranks "
        f"{[round(r['psi_reduce_ms'], 3) for r in ring]}); rounds an epoch "
        f"{S['segments'] * S['ring']}")
    log(f"[stream-ranks] 4x1 dense profiled epoch: "
        f"{T / max(r['profiled'][0]['epoch_s'] for r in ring):.1f} tokens/s; rank 0's first "
        f"package held against the plain version on the card: {r0['held']}")
    pre = [r["ring"]["prefetch"] for r in res]
    for p in (True, False):
        ep_s = max(x[p][0]["epoch_s"] for x in pre)
        log(f"[stream-ranks] 4x1 dense one epoch, prefetch {'on' if p else 'off'}: "
            f"{T / ep_s:.1f} tokens/s; per rank wait ms a segment "
            f"{[round(x[p][0]['load_wait_ms'], 2) for x in pre]}; Φ, Ψ and z equal between "
            f"the two on every rank")
    al = [r["ring"]["alias"] for r in res]
    n = _sum_counts(al, lambda r: r["launches"])
    want = dict(mh_resample=S["alias_epochs"] * S["segments"] * S["ring"] * S["ring"],
                alias_build=2 * S["ring"])
    if any(n[k] != v for k, v in want.items()):
        raise AssertionError(f"streamed 4x1 alias: launches {n}, expected {want}")
    launches["stream_ring_4x1_alias"] = n
    log(f"[stream-ranks] 4x1 alias ({S['alias_epochs']} epochs after one table build a rank): "
        f"tokens/s per epoch {[round(T / max(r['rows'][e]['epoch_s'] for r in al), 1) for e in range(S['alias_epochs'])]}; "
        f"fit s {[round(r['fit_s'], 2) for r in al]}; launches {n}; word LL "
        f"{[f'{x:.6e}' for x in al[0]['ll']]}; mh_resample held on rank 0: {al[0]['held']}; peak "
        f"GiB per rank {[round(r['peak'], 2) for r in al]} (sum "
        f"{sum(r['peak'] for r in al):.2f}); card {card}")
    got, ref = [r["wshard"] for r in res], [r["wshard_ref"] for r in res[:2]]
    for rank, g in enumerate(got):
        d, j = rank // 2, rank % 2
        if g["digests"][0] != ref[d]["digests"][j]:
            raise AssertionError(f"streamed word-sharded: rank {rank}'s Φ slice differs from the "
                                 f"2x1 ring's rows {j}::2 of shard {d}")
        if not (np.array_equal(g["psi"], ref[d]["psi"]) and np.array_equal(g["z"], ref[0]["z"])):
            raise AssertionError("streamed word-sharded: Ψ or the global z differ from the 2x1 "
                                 "ring's")
    n22 = _sum_counts(got, lambda r: r["launches"])
    n21 = _sum_counts(ref, lambda r: r["launches"])
    want22 = S["wshard_epochs"] * S["wshard_segments"] * 2 * 4
    if n22["gibbs_argmax"] != want22 or n21["gibbs_argmax"] != want22 // 2:
        raise AssertionError(f"streamed word-sharded: launches 2x2 {n22}, 2x1 {n21}")
    launches.update(stream_word_sharded_2x2=n22, stream_word_sharded_2x1=n21)
    tps = lambda side: [round(T / max(r["rows"][e]["epoch_s"] for r in side), 1)  # noqa: E731
                        for e in range(S["wshard_epochs"])]
    log(f"[stream-ranks] word-sharded 2x2 (P=2) equals 2x1 bit for bit after "
        f"{S['wshard_epochs']} epochs from {S['wshard_segments']} segments (Φ slices by SHA-256, "
        f"Ψ, the global z): tokens/s 2x2 {tps(got)}, 2x1 {tps(ref)}; launches 2x2 {n22}, 2x1 "
        f"{n21}; peak GiB per rank 2x2 {[round(g['peak'], 2) for g in got]}, 2x1 "
        f"{[round(r['peak'], 2) for r in ref]}; card {card}")
    for sampler in ("dense", "alias"):
        sm = [r["small"][sampler] for r in res]
        diff = {name: sum(int((np.asarray(r["cuda"][i]) != np.asarray(r["cpu"][i])).sum())
                          for r in sm) for name, i in (("phi", 0), ("psi", 1), ("z", 2))}
        ties = sum(r["ties"] for r in sm)
        if any(diff.values()) and (sampler == "alias" or not ties):
            raise AssertionError(f"streamed ring card vs cpu, {sampler}: differ {diff} "
                                 f"(near-ties {ties})")
        launches[f"stream_ring_card_vs_cpu_{sampler}"] = n = _sum_counts(sm, lambda r: r["launches"])
        log(f"[stream-ranks card vs cpu] {sampler}: 2x2 ring, K={SMALL['n_topics']} "
            f"V={SMALL['vocab']}, {STREAM_RANKS_SMALL['segments']} segments, "
            f"{STREAM_RANKS_SMALL['epochs']} epochs on the card and on the CPU: entries that "
            f"differ {diff}; held draws differing from the plain version on the CPU {ties} "
            f"(near-ties); launches on the card {n}")
    lk = [r["lookup"] for r in res]
    for B, b in lk[0]["batches"].items():
        log(f"[lookup_sharded] dlrm-mlperf {sum(x['rows'] for x in lk)} rows x 128 bf16 row-sharded 4 ways "
            f"({lk[0]['rows']} rows, {lk[0]['gib']:.2f} GiB a rank, drawn in "
            f"{max(x['draw_s'] for x in lk):.1f} s), B={B} x 26: owned rows equal the local "
            f"gather bit for bit, every id hit once; {b['ms']:.3f} ms a batch (p99 "
            f"{b['p99_ms']:.3f}; ranks {[round(x['batches'][B]['ms'], 3) for x in lk]}), its "
            f"all_reduce ({b['reduce_bytes']} bytes, {b['dtype']}) {b['reduce_ms']:.3f} ms; ids "
            f"owned per rank {[x['batches'][B]['owned'] for x in lk]}; peak GiB per rank "
            f"{[round(x['peak'], 2) for x in lk]}; card {card}")
    launches["bag"] = dict(lookup_sharded=sum(x["launches"] for x in lk))
    launches["bwd"] = {}
    card_coll_report(res, card)
    recsys_gnn_report(res, card, launches)
    lm_ranks_report(res, card, launches)
    lda_serve_report(res, card)
    return launches


def coll_text(rep, world):
    """A path's collectives for a log line: rank 0's calls and payload bytes
    a step (``count_cost``), the four ranks' total beside JAX's formula."""
    calls = ", ".join(f"{k} {int(v)}" for k, v in sorted(rep["coll_calls"].items()))
    mine = sum(rep["coll_bytes"].values())
    jax = rep["model_coll_bytes"]
    return (f"collectives a step: {calls} calls, {mine:,.0f} bytes a rank ({mine * world:,.0f} "
            f"over {world} ranks; JAX's formula model_coll_bytes {jax:,.0f}, "
            f"{jax / (mine * world):.2f}x the port's), {rep['coll_ms']:.1f} ms")


def recsys_gnn_report(res, card, launches):
    """Check and print [recsys-ranks] and [gnn-ranks]; adds the kernels'
    launches by path (summed over the ranks) to ``launches["bag"]`` and
    ``launches["bwd"]``."""
    W = len(res)
    bag, bwd = launches["bag"], launches["bwd"]
    for key, name in (("train", "dlrm-mlperf train_batch"),):
        reps = [r["dlrm"][key] for r in res]
        r0 = reps[0]
        bag["ranks_dlrm_train"] = sum(x["bag"] for x in reps)
        bwd["ranks_dlrm_train"] = sum(x["bwd"] for x in reps)
        log(f"[recsys-ranks] {name} at (1, 1, 4) on the row-sharded table (reduced: none; "
            f"B = {r0['batch']:,} on every rank): {RANKS['steps']} steps, median step "
            f"{r0['step_ms']:.1f} ms ({r0['timed']}; ranks "
            f"{[round(x['step_ms'], 1) for x in reps]}), losses {[round(x, 6) for x in r0['losses']]}, "
            f"the same bits on every rank with every dense parameter and moment; "
            f"{r0['untouched']:,} sampled untouched rows a rank unchanged bit for bit, touched "
            f"rows moved; ids owned per rank {[x['owned'] for x in reps]}; step 1 held: "
            f"{sum(x['held_bag'] for x in reps)} embedding_bag and "
            f"{sum(x['held_bwd'] for x in reps)} embedding_bag_bwd launches equal to their "
            f"plain versions; launches {bag['ranks_dlrm_train']} / {bwd['ranks_dlrm_train']}; "
            f"peak GiB a rank {[round(x['peak'], 2) for x in reps]}; {coll_text(r0, W)}; "
            f"card {card}")
    for shape in ("serve_p99", "serve_bulk"):
        reps = [r["dlrm"][shape] for r in res]
        bag[f"ranks_dlrm_{shape}"] = sum(x["bag"] for x in reps)
        log(f"[recsys-ranks] dlrm-mlperf {shape} at (1, 1, 4): B = {reps[0]['batch']:,}"
            + (f" (reduced: {reps[0]['parts']} calls of {reps[0]['batch'] // reps[0]['parts']:,} "
               f"rows, RANKS['bulk_parts'])" if reps[0]["parts"] > 1 else "") + ", "
            f"{reps[0]['ms']:.2f} ms a batch (ranks {[round(x['ms'], 2) for x in reps]}; "
            f"its sum over 'model' {reps[0]['coll_ms']:.2f} ms), the same logits on every rank"
            + (f", {sum(x['held'] for x in reps)} held launches equal to the plain version"
               if shape == "serve_p99" else "")
            + f"; JAX's formula {reps[0]['model_coll_bytes']:,.0f} bytes; peak GiB a rank "
            f"{[round(x['peak'], 2) for x in reps]}; card {card}")
    rt = [r["dlrm"]["retrieval"] for r in res]
    log(f"[recsys-ranks] dlrm-mlperf retrieval_cand at (1, 1, 4): {rt[0]['n']:,} candidates, "
        f"{rt[0]['per_rank']:,} a rank; merged top-100 equals the one-rank retrieval_scores "
        f"bit for bit; {rt[0]['ms']:.2f} ms (its gathers {rt[0]['coll_ms']:.2f} ms); card {card}")
    for family, key, tag in (("recsys", "recsys_22", "[recsys-ranks]"),
                             ("gnn", "gnn_22", "[gnn-ranks]")):
        for name in res[0][key]:
            reps = [r[key][name] for r in res]
            r0 = reps[0]
            path = f"ranks_{'gnn_' if family == 'gnn' else ''}{name}"
            bag[path] = sum(x["bag"] for x in reps)
            bwd[path] = sum(x["bwd"] for x in reps)
            tol = (f"each table's change after steps 1 and {len(r0['losses'])} Σ|Δ| / "
                   f"Σ|change| ≤ {RANKS['table_rtol']:g} (max {r0['max_table']:.3g}), "
                   if family == "recsys" else "")
            log(f"{tag} {name} at (1, 2, 2)"
                + (f" (reduced: B = {r0['batch']:,})" if name in RANKS["cut"] else "")
                + f": {len(r0['losses'])} steps, step {r0['step_ms']:.1f} ms ({r0['timed']}; "
                f"ranks {[round(x['step_ms'], 1) for x in reps]}), losses "
                f"{[round(x, 6) for x in r0['losses']]}; against the one-rank step: losses "
                f"rtol {RANKS['loss_rtol']:g} (max {r0['max_loss_rel']:.2g}), {tol}dense "
                f"|Δ| ≤ {RANKS['dense_tol']:g} (max {r0['max_dense']:.3g}), AdamW m and v "
                f"after step 1 ‖Δ‖ / ‖value‖ ≤ {RANKS['moment_rtol']:g} (max "
                f"{r0['max_moment']:.3g}); replicas the same "
                f"bits; step 1 held: {sum(x['held_bag'] for x in reps)} embedding_bag and "
                f"{sum(x['held_bwd'] for x in reps)} embedding_bag_bwd launches equal to "
                f"their plain versions; launches {bag[path]} / {bwd[path]}; peak GiB a rank "
                f"{[round(x['peak'], 2) for x in reps]}; {coll_text(r0, W)}; card {card}")


def stream_launch_fault_main(layout, argv):
    """A ``launch.train`` rank; on rank 1 only, its process's first read of
    segment 0 fails (a ``FaultPlane``; retried there)."""
    from repro_torch.launch import train
    from repro_torch.reliability import faults
    if layout.rank != 1:
        return train._rank_main(layout, argv)
    plane = faults.FaultPlane().fail("disk.segment_read", key="0", nth=1)
    with faults.injected(plane):
        out = train._rank_main(layout, argv)
    out["injected"] = plane.injected("disk.segment_read")
    return out


def stream_launch_ranks_phase():
    """[launch.train streamed ranks]: ``launch.train.main`` starting its own
    4 ranks on the card (``--data-shards 2 --model-shards 2
    --ranks-per-device 4``) on SMALL's geometry in 3 segments, α from epoch
    2: an uninterrupted run from memory; from a ``--corpus-dir``, killed
    after segment 1 of epoch 2 (exit 17) and resumed with rank 1's first
    read of segment 0 failing (retried on rank 1). The resumed run must
    equal the uninterrupted one (every rank's views, α and the global z) bit
    for bit. The uninterrupted world and the killed one start together."""
    import shutil
    from repro_torch.data import sources
    from repro_torch.launch import mesh, train
    S = STREAM_RANKS_SMALL
    root = os.path.join(ROOT, "build", "chip_smoke_stream_launch")
    shutil.rmtree(root, ignore_errors=True)
    shape = ("--data-shards", "2", "--model-shards", "2", "--ranks-per-device", "4")

    def argv(ck, *extra):
        return ["--device", "cuda", "--backend", "gloo", "--docs", str(SMALL["n_docs"]),
                "--vocab", str(SMALL["vocab"]), "--topics", str(SMALL["n_topics"]),
                "--true-topics", str(SMALL["gen_topics"]), "--epochs", str(S["epochs"]),
                "--alpha-opt-from", "2", "--ckpt-every", "2", "--bench-out", "",
                "--ckpt-dir", os.path.join(root, ck), *shape, *extra]

    def run(*a):
        t0 = time.perf_counter()
        try:
            out = train.main(argv(*a)), 0
        except SystemExit as exc:
            out = None, exc.code
        return out + (time.perf_counter() - t0,)

    def same(a, b, label):
        for ra_, rb in zip(a, b):
            for i, (x, y) in enumerate(zip(ra_["state"], rb["state"])):
                if x.dtype != y.dtype or not np.array_equal(x, y):
                    raise AssertionError(f"{label}: rank {ra_['rank']}'s state leaf {i} differs")
            if not (np.array_equal(ra_["alpha"], rb["alpha"]) and np.array_equal(ra_["z"], rb["z"])):
                raise AssertionError(f"{label}: rank {ra_['rank']}'s α or global z differs")

    counts = lambda results: _sum_counts(results, lambda r: r["launches"])  # noqa: E731
    seg = ("--n-segments", str(S["segments"]))
    kill = ("--ckpt-segments", "1", "--kill-at", str(S["kill_at"]), "--kill-at-segment",
            str(S["kill_at_segment"]))
    cfg = train.config_from_args(train.build_parser().parse_args(argv("x", *seg)))
    d = os.path.join(root, "segments")
    sources.save_segments(sources.SyntheticSource(
        n_docs=cfg.n_docs, vocab_size=cfg.vocab_size, true_topics=cfg.true_topics,
        doc_len_mean=cfg.doc_len_mean, gen_seed=cfg.seed, n_segments=S["segments"],
        n_data_shards=4, n_vocab_shards=4, n_topics=cfg.n_topics, seed=cfg.shard_seed), d)
    secs = {}

    def killed_then_resumed():
        _, code, secs["killed --corpus-dir"] = run("dir", "--corpus-dir", d, *kill)
        t0 = time.perf_counter()
        out = mesh.spawn(stream_launch_fault_main, data=2, model=2, device="cuda",
                         ranks_per_device=4, backend="gloo",
                         args=(argv("dir", "--corpus-dir", d, "--resume"),))
        secs["resumed --corpus-dir, fault"] = time.perf_counter() - t0
        return code, out

    # the uninterrupted world and the killed one start together
    chains = [Beside(run, "gold", *seg), Beside(killed_then_resumed)]
    for c in chains:                    # every world ends before a failure is raised
        c.join()
    (gold, _, secs["uninterrupted"]), (code_dir, faulted) = [c.result() for c in chains]
    n = dict(uninterrupted=counts(gold), resumed_corpus_dir_fault=counts(faulted))
    n_seg, per = S["segments"], 4 * 4                   # 4 ranks × 4 rounds a segment
    done = (S["kill_at"] - 1) * n_seg + S["kill_at_segment"]
    want = dict(uninterrupted=S["epochs"] * n_seg * per,
                resumed_corpus_dir_fault=(S["epochs"] * n_seg - done) * per)
    if code_dir != 17 or any(n[k]["gibbs_argmax"] != v for k, v in want.items()):
        raise AssertionError(f"launch.train streamed ranks: kill exit {code_dir}, "
                             f"launches {n}, want gibbs_argmax {want}")
    if faulted[1].get("injected") != 1:
        raise AssertionError("launch.train streamed ranks: rank 1's fault plane did not fire once")
    same(gold, faulted, "launch.train streamed ranks, --corpus-dir resumed under a fault vs "
                        "uninterrupted from memory")
    log(f"[launch.train streamed ranks] --data-shards 2 --model-shards 2 --ranks-per-device 4, "
        f"{n_seg} segments, {S['epochs']} epochs, α from epoch 2: from a --corpus-dir, killed "
        f"after segment {S['kill_at_segment']} of epoch {S['kill_at']} (exit 17) and resumed "
        f"with rank 1's first read of segment 0 failing (retried there): every rank's views, α "
        f"and the global z equal the uninterrupted run's from memory bit for bit; launches {n}; "
        f"seconds " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    shutil.rmtree(root, ignore_errors=True)
    return n


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False   # Eq. 5 product stays f32
    card = card_line()
    log(f"[setup] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build_logs = kernels.build()
    log(f"[setup] built {sorted(build_logs)} in {time.perf_counter() - t0:.2f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[setup] {name}: {line.strip()}")

    since = [time.perf_counter()]

    def mark(label):
        """Log the seconds since the last mark (the phases' share of the run)."""
        now = time.perf_counter()
        log(f"[time] {label}: {now - since[0]:.1f} s")
        since[0] = now

    kernel = kernel_phase()
    alias_build, mh_small_err, sweep = alias_kernel_phase()
    bag_small_err = bag_kernel_phase()
    mark("kernel phases (the full-K alias sweep waits)")
    preflight_phase()
    corpus, truth = full_corpus(with_truth=True)
    launches, gibbs_epoch_stats = full_width_phase(corpus)
    alias_launches, mh, cell_build = alias_phase(corpus)
    mark("dense and alias cells")
    alias_build.update(cell_build)
    mh["max_abs_err"] = max(mh["max_abs_err"], mh_small_err)
    gc.collect()
    torch.cuda.empty_cache()
    trainer_launches, ll_launches = trainer_phase(corpus, gibbs_epoch_stats)
    mark("trainer cell")
    gc.collect()
    torch.cuda.empty_cache()
    quality = quality_phase(corpus, truth)
    mark("quality (Fig. 1/7/8 at full width, guardrails, Table 1 sweep)")
    gc.collect()
    torch.cuda.empty_cache()
    stream = stream_phase(corpus)
    mark("stream cell")
    small_phase()
    alias_small_phase()
    small_launches = trainer_small_phase()
    stream_small = stream_small_phase()
    mark("small loops")
    gc.collect()                       # the ranks take the card
    torch.cuda.empty_cache()
    ranks = ranks_phase(corpus)
    mark("ranks (ring, word-sharded, card vs cpu, pods)")
    # launch.train's ranks (SMALL's geometry) leave the card nearly idle: the
    # full-K alias sweep runs beside both phases on a thread of this process
    beside = Beside(full_k_sweep, sweep)
    try:
        ranks_small = launch_ranks_phase()
        mark("launch.train multi-rank (the full-K alias sweep beside it)")
        stream_launch = stream_launch_ranks_phase()
        mark("launch.train streamed ranks (the full-K alias sweep beside it)")
    finally:
        beside.join()
    plain_ms, sweep_err = beside.result()
    del sweep
    alias_build.update(plain_ms=plain_ms, max_abs_err=max(alias_build["max_abs_err"], sweep_err))
    mark("the full-K alias sweep (the wait after the launch.train phases)")
    gc.collect()
    torch.cuda.empty_cache()
    stream_ranks = stream_ranks_phase(corpus)
    mark("stream ranks (4x1, word-sharded, card vs cpu, lookup_sharded, recsys and GNN "
         "across ranks)")
    # `launches` is each kernel's count on its first path (gibbs_epoch, the
    # alias cell), as in earlier runs; launches_by_path gives every path
    small = lambda sampler, k: {r: c[k] for r, c in small_launches[sampler].items()}
    stream_small_of = lambda sampler, k: {r: c[k] for r, c in stream_small[sampler].items()}
    gibbs_paths = dict(gibbs_epoch=launches, trainer=trainer_launches,
                       trainer_ll_dense=ll_launches["dense"]["gibbs_argmax"],
                       launch_train_small=small("dense", "gibbs_argmax"),
                       stream_trainer=stream["gibbs"],
                       stream_ll_dense=stream["ll"]["dense"]["gibbs_argmax"],
                       stream_launch_train_small=stream_small_of("dense", "gibbs_argmax"),
                       ring_4x1=ranks["ring_4x1_gibbs"],
                       ring_4x1_optimized=ranks["ring_4x1_optimized"],
                       word_sharded_2x2=ranks["word_sharded_2x2_dense"]["gibbs_argmax"],
                       word_sharded_2x1=ranks["word_sharded_2x1_dense"]["gibbs_argmax"],
                       ring_card_vs_cpu=ranks["ring_card_vs_cpu_dense"]["gibbs_argmax"],
                       pods=ranks["pods"]["gibbs_argmax"],
                       launch_train_ranks={k: v["gibbs_argmax"] for k, v in ranks_small.items()},
                       stream_ring_4x1=stream_ranks["stream_ring_4x1_dense"]["gibbs_argmax"],
                       stream_word_sharded_2x2=stream_ranks["stream_word_sharded_2x2"]["gibbs_argmax"],
                       stream_word_sharded_2x1=stream_ranks["stream_word_sharded_2x1"]["gibbs_argmax"],
                       stream_ring_card_vs_cpu=stream_ranks["stream_ring_card_vs_cpu_dense"]["gibbs_argmax"],
                       stream_launch_train_ranks={k: v["gibbs_argmax"]
                                                  for k, v in stream_launch.items()})
    alias_paths = {k: dict(alias_cell=alias_launches[k],
                           trainer_ll_alias=ll_launches["alias"][k],
                           launch_train_small=small("alias", k),
                           stream_trainer_alias=stream["alias"][k],
                           stream_ll_alias=stream["ll"]["alias"][k],
                           stream_launch_train_small=stream_small_of("alias", k),
                           ring_4x1_alias=ranks["ring_4x1_alias"][k],
                           word_sharded_2x2=ranks["word_sharded_2x2_alias"][k],
                           word_sharded_2x1=ranks["word_sharded_2x1_alias"][k],
                           ring_card_vs_cpu=ranks["ring_card_vs_cpu_alias"][k],
                           stream_ring_4x1_alias=stream_ranks["stream_ring_4x1_alias"][k],
                           stream_ring_card_vs_cpu=stream_ranks["stream_ring_card_vs_cpu_alias"][k])
                   for k in ("alias_build", "mh_resample")}
    gc.collect()                       # the LDA phases' tensors go before the 48 GB table
    torch.cuda.empty_cache()
    recsys = list(recsys_phase())
    bag_launches, bag_full_err, bag = recsys[:3]
    mark("recsys")
    bwd, train = recsys_train_phase(recsys.pop())    # its only reference to the 48 GB table
    mark("recsys_train")
    gc.collect()                       # the recsys tables go before the GNN and LM phases
    torch.cuda.empty_cache()
    gnn, gnn_scatter = gnn_phase()
    mark("gnn")
    lm = lm_phase()
    mark("lm")
    # the gates run on the host (at the lowest priority) beside the dry run,
    # whose work is on the card
    gates = start_preflight_gates()
    try:
        dry_launches, dry_by_family = dryrun_phase(train["dlrm-mlperf"]["step_ms"])
        mark("dryrun (the preflight gates beside it)")
    except BaseException:
        gates.kill()
        gates.wait()
        raise
    finish_preflight_gates(gates)
    mark("preflight gates (the wait after the dry run)")
    example_launches = examples_phase()
    mark("examples")
    recsys_small_phase()
    mark("recsys small")
    gc.collect()                       # the recsys table goes before the serving models
    torch.cuda.empty_cache()
    serve_build, capacity = serve_engine_phase()
    serve_launches = serve_open_loop_phase(capacity)
    serve_publish = serve_publish_phase()
    serve_chaos_phase()
    mark("serving")
    gibbs_paths.update(launch_serve=serve_launches, serve_engine_build=serve_build,
                       serve_publish_train=serve_publish)
    for name, counts in example_launches.items():
        for k, paths in [("gibbs_argmax", gibbs_paths), ("alias_build", alias_paths["alias_build"]),
                         ("mh_resample", alias_paths["mh_resample"])]:
            paths[f"example_{name}"] = counts[k]
    for k, paths in [("gibbs_argmax", gibbs_paths), ("alias_build", alias_paths["alias_build"]),
                     ("mh_resample", alias_paths["mh_resample"])]:
        paths.update({p: counts[k] for p, counts in quality.items()})

    log(json.dumps({"kernels": [
        dict(name="gibbs_argmax", route="cuda", source="src/repro_torch/csrc/gibbs_argmax.cu",
             replaces="src/repro/kernels/gibbs/kernel.py:92",
             launches=launches, launches_by_path=gibbs_paths,
             max_abs_err=kernel["max_abs_err"], ms=kernel["ms"], plain_ms=kernel["plain_ms"],
             bound_ms=kernel["bound_ms"], bound_by=kernel["bound_by"], library_ms=None),
        dict(name="alias_build", route="cuda", source="src/repro_torch/csrc/alias_build.cu",
             replaces="src/repro/kernels/alias/kernel.py:125",
             launches=alias_launches["alias_build"],
             launches_by_path=alias_paths["alias_build"], library_ms=None, **alias_build),
        dict(name="mh_resample", route="cuda", source="src/repro_torch/csrc/mh_resample.cu",
             replaces="src/repro/kernels/alias/kernel.py:249",
             launches=alias_launches["mh_resample"],
             launches_by_path=alias_paths["mh_resample"], library_ms=None, **mh),
        dict(name="embedding_bag", route="cuda", source="src/repro_torch/csrc/embedding_bag.cu",
             replaces="src/repro/kernels/embedding_bag/kernel.py:81", launches=bag_launches,
             launches_by_path=dict(recsys=bag_launches,
                                   **{f"recsys_train_{a}": r["launches"]
                                      for a, r in train.items()},
                                   dryrun_one_rank=dry_launches["embedding_bag"],
                                   **{f"dryrun_one_rank_{f}": n["embedding_bag"]
                                      for f, n in dry_by_family.items()},
                                   **{f"gnn_{c}": r["bag"] for c, r in gnn.items()},
                                   **{p: n["embedding_bag"] for p, n in quality.items()},
                                   **stream_ranks["bag"]),
             max_abs_err=max(bag_small_err, bag_full_err), multi_hot=bag["multi_hot"],
             **bag["lookup"]),
        dict(name="embedding_bag_bwd", route="cuda",
             source="src/repro_torch/csrc/embedding_bag_bwd.cu",
             replaces="none: port-only, JAX's table gradient is XLA's scatter-add "
                      "(src/repro/configs/base.py:449)",
             launches=train["dlrm-mlperf"]["bwd_launches"],
             launches_by_path={**{f"recsys_train_{a}": r["bwd_launches"]
                                  for a, r in train.items()},
                               **{f"gnn_{c}": r["bwd"] for c, r in gnn.items()},
                               **{f"lm_{c}": r["bwd"] for c, r in lm.items()},
                               **stream_ranks["bwd"],
                               "dryrun_one_rank": dry_launches["embedding_bag_bwd"],
                               **{f"dryrun_one_rank_{f}": n["embedding_bag_bwd"]
                                  for f, n in dry_by_family.items()},
                               **{f"example_{name}": counts["embedding_bag_bwd"]
                                  for name, counts in example_launches.items()
                                  if counts.get("embedding_bag_bwd")}},
             gather_segment_sum=gnn_scatter,
             at_lm_launches={f"{c}: {k}": r[k] for c, r in lm.items()
                             for k in ("wide", "run") if k in r},
             held_on_path={**{f"gnn_{c}": r["held"] for c, r in gnn.items()},
                           **{f"lm_{c}": r["held"] for c, r in lm.items()}},
             **bwd)]}))
    log(f"card: {card_line()}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
