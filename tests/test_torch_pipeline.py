"""Port conformance of ``repro_torch.core.pipeline`` (Table 1's analytic
model, pure Python) against ``repro.core.pipeline``, and of the Table 1
bench twin (``repro_torch.benchmarks.bench_pipeline``).

The model is the same float arithmetic on both sides, held to 1e-12; the
package sweep on the port's ring of one device runs at JAX's bench size.
"""
import dataclasses

import numpy as np
import pytest

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro.core import pipeline as jpipe
from repro_torch.benchmarks import bench_pipeline
from repro_torch.core import pipeline as tpipe

pytestmark = pytest.mark.port

MODELS = [dict(), dict(buffer_bytes=50e6, knee=0.3), dict(bandwidth=1e7, overhead_s=4e-5)]


@pytest.mark.parametrize("knobs", MODELS, ids=["paper", "small_buffer", "fast_wire"])
def test_time_seconds_and_table_match(knobs):
    jm, tm = jpipe.PipelineModel(**knobs), tpipe.PipelineModel(**knobs)
    rng = np.random.default_rng(0)
    lengths = list(rng.uniform(1e2, 5e8, 200)) + [lkb * 1e3 for lkb in jpipe.PAPER_TABLE_1]
    for L in lengths:
        assert abs(tm.time_seconds(L) - jm.time_seconds(L)) <= 1e-12 * jm.time_seconds(L)
    grid = [1, 3, 10, 250, 1000, 7000, 200000]
    for a, b in zip(tm.table(grid), jm.table(grid)):
        np.testing.assert_allclose(a, b, rtol=1e-12)


@pytest.mark.parametrize("knobs", MODELS, ids=["paper", "small_buffer", "fast_wire"])
def test_validate_and_optimal_package_match(knobs):
    jm, tm = jpipe.PipelineModel(**knobs), tpipe.PipelineModel(**knobs)
    assert tpipe.PAPER_TABLE_1 == jpipe.PAPER_TABLE_1
    j, t = jpipe.validate_against_paper(jm), tpipe.validate_against_paper(tm)
    assert list(t) == list(j)
    for lkb in j:
        np.testing.assert_allclose(t[lkb], j[lkb], rtol=1e-12)
    assert tpipe.optimal_package(tm) == jpipe.optimal_package(jm)
    grid = [2, 30, 400, 9000, 150000]
    assert tpipe.optimal_package(tm, grid) == jpipe.optimal_package(jm, grid)


def test_model_is_frozen():
    with pytest.raises(dataclasses.FrozenInstanceError):
        tpipe.PipelineModel().knee = 1.0


def test_table1_fit_quality():
    """``tests/test_features_pipeline.py::test_table1_fit_quality`` on the port."""
    rows = tpipe.validate_against_paper()
    errs = {lkb: abs(m - p) for lkb, (m, p) in rows.items()}
    assert errs[1] < 0.2 and errs[200000] < 0.2 and errs[1000] < 0.2
    assert max(errs.values()) < 2.0
    assert bench_pipeline.table1_model() == [
        (lkb, round(m, 1), p) for lkb, (m, p) in jpipe.validate_against_paper().items()]


def test_curve_is_u_shaped():
    m = tpipe.PipelineModel()
    t = [m.time_seconds(lkb * 1e3) for lkb in [1, 100, 1000, 20000, 200000]]
    assert t[0] > t[2] and t[-1] > t[2]
    opt = tpipe.optimal_package()
    assert 10 < opt < 200000


def test_buffer_constraint_respected():
    m = tpipe.PipelineModel()
    assert m.time_seconds(m.buffer_bytes) > m.time_seconds(m.buffer_bytes / 2)


def test_package_len_for():
    assert bench_pipeline.package_len_for(18_944, 10_000) == 9_472
    assert bench_pipeline.package_len_for(18_944, 18_944) == 18_944
    assert bench_pipeline.package_len_for(37, 10) == 1


def test_measured_package_sweep_runs_the_ring(monkeypatch):
    """JAX's sweep on the port's ring of one device, on the CPU: the
    lengths JAX would sweep (8, 64, 512 and the cap, where they divide it),
    every epoch timed, and one draw a package."""
    from repro_torch.kernels.gibbs import ops
    calls, draw = [], ops.gibbs_argmax
    monkeypatch.setattr(ops, "gibbs_argmax", lambda *a: calls.append(1) or draw(*a))
    sweep, n_tokens = bench_pipeline.measured_package_sweep(epochs=1, device="cpu")
    lengths = [pkg for pkg, _ in sweep]
    cap = lengths[-1]
    assert cap % 512 == 0 and lengths == [L for L in (8, 64, 512, cap) if cap % L == 0]
    assert all(len(s) == 1 and s[0] > 0 for _, s in sweep)
    assert len(calls) == sum(2 * cap // L for L in lengths)       # warm-up + 1 epoch
    sweep, _ = bench_pipeline.measured_package_sweep(epochs=1, most=(700, 2_000),
                                                     device="cpu")
    assert [pkg for pkg, _ in sweep] == sorted({bench_pipeline.package_len_for(cap, 700),
                                                bench_pipeline.package_len_for(cap, 2_000),
                                                cap})
