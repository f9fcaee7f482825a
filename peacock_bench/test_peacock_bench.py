"""CPU tests of the port's benchmark: the generators repeat by seed, the
yardstick's counts on hand-worked shapes, cells, configurations, traffic
and metrics found by name as new files, no forbidden module in a run, the
reference agreeing with the port at tiny sizes, and the control and every
planted fault judged not correct. One test needs the card and skips here.

    python -m pytest peacock_bench
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import faults
import gen
import harness
import peaks

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CELLS = ("tiny.train", "tiny-alias.train", "tiny.serve", "tiny.serve-zipf")


# ---------------------------------------------------------------- generators --

def test_corpus_repeats_by_seed_and_keeps_its_size():
    a = gen.lda_corpus([7, 1], 300, 12, 500, 4.5)
    b = gen.lda_corpus([7, 1], 300, 12, 500, 4.5)
    c = gen.lda_corpus([8, 1], 300, 12, 500, 4.5)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == c[0].shape and not np.array_equal(a[0], c[0])
    # the same word counts and document lengths under another labelling
    assert np.array_equal(np.sort(np.bincount(a[0], minlength=500)),
                          np.sort(np.bincount(c[0], minlength=500)))
    assert np.array_equal(np.sort(np.bincount(a[1])), np.sort(np.bincount(c[1])))
    words, docs = a
    assert np.all(np.diff(docs) >= 0) and words.min() >= 0 and words.max() < 500
    assert np.bincount(docs).min() >= gen.MIN_LEN


def test_queries_arrivals_and_picks_repeat_by_seed():
    rng = np.random.default_rng(0)
    words, weights = gen.zipf_topics(rng, 30, 400)
    q1 = gen.queries([3, 3], 200, words, weights, 400, 4.5, 0.05, 1.0)
    q2 = gen.queries([3, 3], 200, words, weights, 400, 4.5, 0.05, 1.0)
    assert all(np.array_equal(x, y) for x, y in zip(q1, q2))
    assert len({q.tobytes() for q in q1}) == 200                 # all distinct
    assert max(len(q) for q in q1) <= 64 and min(len(q) for q in q1) >= gen.MIN_LEN
    assert sorted(len(q) for q in q1) == sorted(
        len(q) for q in gen.queries([4, 3], 200, words, weights, 400, 4.5, 0.05, 1.0))
    t = gen.arrivals([3, 2], 50.0, 4.0)
    assert t.size == 200 and np.all(np.diff(t) >= 0) and t[-1] < 4.0
    assert np.array_equal(t, gen.arrivals([3, 2], 50.0, 4.0))
    assert np.array_equal(gen.zipf_picks([3, 4], 50, 9), gen.zipf_picks([3, 4], 50, 9))


def test_serving_counts_repeat_by_seed():
    import torch

    p1, w1, _ = gen.serving_counts(5, 16, 200, 300, "cpu")
    p2, w2, _ = gen.serving_counts(5, 16, 200, 300, "cpu")
    assert torch.equal(p1, p2) and np.array_equal(w1, w2)
    assert p1.shape == (200, 16) and int(p1.min()) >= 0 and int(p1.sum()) > 0


# --------------------------------------------------------------------- counts --

def test_counts_on_hand_worked_shapes():
    # φ, θ and the ψ plane 3 · 4 · 2·3 B, α 4·3, uids 8·2, z 4·2
    assert peaks.gibbs_bytes(2, 3) == 72 + 12 + 16 + 8
    assert peaks.gibbs_bytes(2, 3, psi_plane=False) == 48 + 12 + 12 + 16 + 8
    assert peaks.gibbs_ops(2, 3) == 180
    assert peaks.build_bytes(2, 3) == 80 and peaks.build_ops(2, 3) == 120
    assert peaks.mh_ops(1, 2, 1) == 4 + (56 + 12 + 30)
    assert peaks.mh_fixed_bytes(1, 2, 3, 4) == 24 + 48 + 64
    assert peaks.dense_epoch_bytes(1, 1, 2) == 4 * 2 * 3 + 8
    assert peaks.serve_gemm_flops(1, 2, 3) == 12
    assert peaks.eq4_ops(1, 2, 1, 1) == 32
    assert peaks.bound(3.35e12, 0.0) == (1.0, "bytes")
    assert peaks.bound(0.0, 67e12) == (1.0, "operations")


# -------------------------------------------------------------- found by name --

def test_a_cell_config_traffic_and_metric_added_as_files_are_found(tiny_bench, tmp_path):
    bench_dir = tiny_bench.BENCH
    with open(os.path.join(bench_dir, "metrics", "tokens_seen.py"), "w") as f:
        f.write("def read(record):\n    return record.get('tokens')\n")
    bench = json.load(open(os.path.join(tiny_bench.ROOT, "BENCHMARK.json")))
    bench["workloads"].append({"name": "tiny.train", "config": "tiny-peacock-lda",
                               "traffic": "tiny-train", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "tokens_seen", "unit": "tokens", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "train_tokens_per_s", "workloads": ["tiny.train"]})
    names = [m["name"] for m in tiny_bench.cell_metrics(bench, "tiny.train", "per_layer")]
    assert "tokens_seen" in names and "serve_batch_ms" not in names
    res = tiny_bench.run_cell("tiny.train", 3, 0.3, False, 0.0, device="cpu")
    assert tiny_bench.load_module("metrics", "tokens_seen").read(res["record"]) > 0
    assert tiny_bench.load_module("metrics", "ring_epoch_ms").read(res["record"]) > 0


def test_run_takes_the_contract_flags_and_no_others():
    import run

    a = run.parse(["--workload", "c", "--seed", "3000000001", "--seconds", "10",
                   "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("c", 3000000001, 10.0, 1)
    with pytest.raises(SystemExit):
        run.parse(["--workload", "c", "--seed", "1", "--seconds", "10", "--rate", "5"])


def test_forbidden_names_are_compared_whole(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike.core", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike", sys)
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    assert "repro" in harness.forbidden_modules()


def test_a_run_loads_no_jax_nor_the_jax_package(tiny_bench):
    code = ("import sys; sys.path[:0] = [%r, %r]; import harness; "
            "harness.run_cell('tiny.serve', 2, 0.3, False, 0.0, device='cpu'); "
            "harness.run_cell('tiny.train', 2, 0.3, False, 0.0, device='cpu'); "
            "print(harness.forbidden_modules())") % (tiny_bench.BENCH, os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# ---------------------------------------------------- reference, control, faults --

@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_agrees_with_the_port(tiny_bench, cell):
    res = tiny_bench.run_cell(cell, 11, 0.5, False, 0.0, device="cpu")
    assert res["failed"] == 0
    assert tiny_bench.judge(res["checks"]), res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny_bench, cell):
    res = tiny_bench.run_cell(cell, 12, 0.5, False, 0.0, device="cpu", mode="control")
    assert not tiny_bench.judge(res["checks"]), res["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS[:2] for f in faults.TRAIN
                                        if c == "tiny-alias.train" or f != "stale_tables"]
                         + [(c, f) for c in CELLS[2:] for f in faults.SERVE])
def test_a_planted_fault_is_not_correct(tiny_bench, cell, fault):
    res = tiny_bench.run_cell(cell, 13, 0.5, False, 0.0, device="cpu", mode=f"fault:{fault}")
    assert not tiny_bench.judge(res["checks"]), res["checks"]


# ------------------------------------------------------------------- the card --

@pytest.mark.kernels
def test_a_cell_on_the_card_prints_the_contract_line():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "peacock_bench/run.py", "--workload",
                          "peacock-lda.train", "--seed", "5", "--seconds", "2", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["device"]["busy_s"] > 0 and "gibbs_argmax_roofline" in line["metrics"]
