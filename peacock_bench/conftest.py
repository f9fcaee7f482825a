"""Test set-up of the benchmark's own tests (``python -m pytest peacock_bench``):
the harness's folder and the port's ``src`` on the path, one CPU thread for
torch, and a copy of the harness with tiny configurations added as new
files, which every CPU test runs its cells from."""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# the tiny cells: each real cell's configuration cut to a CPU-sized corpus
# and model, its traffic slowed, and the real cell's limits kept
TINY = {
    "tiny.train": ("peacock-lda.train", {"n_topics": 24, "vocab_size": 300, "n_docs": 400,
                                         "gen_topics": 12}),
    "tiny-alias.train": ("peacock-lda-alias.train", {"n_topics": 24, "vocab_size": 300,
                                                     "n_docs": 800, "gen_topics": 12}),
    "tiny.serve": ("peacock-lda.serve", {"n_topics": 24, "vocab_size": 300}),
    "tiny.serve-zipf": ("peacock-lda.serve-zipf", {"n_topics": 24, "vocab_size": 300}),
}


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    """A copy of the benchmark's folder (and of BENCHMARK.json) with the tiny
    cells added as files of their own: its ``harness`` module, imported from
    the copy."""
    import torch

    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("bench")
    dst = root / "peacock_bench"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    for cell, (real, sizes) in TINY.items():
        w = _load(dst / "workloads" / f"{real}.json")
        cfg = _load(dst / "configs" / f"{w['config']}.json")
        cfg.update(sizes, name=f"tiny-{w['config']}")
        if "serve" in cfg:
            cfg["serve"].update(tokens_per_topic=200, max_batch=16)
        _dump(cfg, dst / "configs" / f"tiny-{w['config']}.json")
        traffic = _load(dst / "traffic" / f"{w['traffic']}.json")
        if traffic["driver"] == "open_loop":
            traffic["params"].update(rate=100, sample=20, sample_longest=5)
            if "zipf_pool" in traffic["params"]:
                traffic["params"].update(zipf_pool=40, cache_mb=0.01)
        _dump(traffic, dst / "traffic" / f"tiny-{w['traffic']}.json")
        w.update(config=f"tiny-{w['config']}", traffic=f"tiny-{w['traffic']}")
        _dump(w, dst / "workloads" / f"{cell}.json")
    import importlib.util
    spec = importlib.util.spec_from_file_location("tiny_harness", dst / "harness.py")
    harness = importlib.util.module_from_spec(spec)
    sys.modules["tiny_harness"] = harness
    spec.loader.exec_module(harness)
    return harness
