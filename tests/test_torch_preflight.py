"""The port's launch gate (``repro_torch.analysis``) against the JAX package's
(``repro.analysis``) on the CPU.

* the report renders the same findings to the same text and JSON as JAX's;
* the §10 rotation formula is JAX's, and the port's ring issues exactly that
  many ppermutes at (M, P) = (2, 1) and (4, 1) for both samplers; at (2, 2)
  it ships the (P − 1) × 2 model hops a round as one all_gather of the
  stacked (doc, z) planes, so its ppermutes plus 2 (P − 1) a gather equal
  the formula and JAX's own traced count;
* each pass catches a seeded fault, and the gate then exits 1: a ring that
  skips a shift or all-gathers a Φ slice, a float ``index_add_`` or a
  ``torch.rand`` in an epoch, a plan over sm_90's shared memory or an int32
  argument overflow, an unfrozen config, a stray device probe, a kernel
  without its oracle or marked test, a port module importing jax or repro,
  a thread class breaking its lock contract;
* the CLI and the three launchers' gates, none of which builds a Trainer or
  starts a rank of the session before its verdict.

The gloo worlds of the sharding checks are spawned once a module (the
``cli`` and ``train_gate`` fixtures and one ``build_session``).
"""
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

import _torch_ranks
from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro.analysis import report as jreport, shardcheck as jshard
from repro_torch import kernels
from repro_torch.analysis import (determinism, preflight, report, repolint, shardcheck,
                                  smem)
from repro_torch.dist import analysis as tanalysis, collectives as coll
from repro_torch.kernels import LaunchPlan
from repro_torch.kernels.alias import kernel as ak
from repro_torch.kernels.embedding_bag import kernel as ek
from repro_torch.launch import dryrun as tdryrun, mesh, serve as tserve, train as ttrain

pytestmark = [pytest.mark.port, pytest.mark.preflight]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PASSES = ["sharding", "smem", "determinism", "concurrency", "lint"]
ONE = preflight.SessionSpec(data_shards=1, model_shards=1, sampler="dense")


def _errors(findings, check=None):
    return [f for f in findings if f.severity == "error" and (check is None or f.check == check)]


def _report_errors(rep):
    return [f for r in rep.results for f in r.findings if f.severity == "error"]


# ------------------------------------------------------------------ report --


def test_report_renders_like_jax():
    def build(mod):
        r = mod.PreflightReport(session={"n_topics": 12, "sampler": "alias"})
        r.add(mod.PassResult("a", [mod.info("a.ok", "fine", location="x:1", n=3)], 0.123))
        r.add(mod.PassResult("b", [mod.warning("b.meh", "hmm"),
                                   mod.error("b.bad", "broken", location="y", shape=[2, 3])],
                             1.5))
        return r

    port, jax_ = build(report), build(jreport)
    assert port.render() == jax_.render()
    assert port.to_json() == jax_.to_json() and port.to_json(indent=2) == jax_.to_json(indent=2)
    assert not port.ok and "[preflight] FAILED" in port.render()
    with pytest.raises(ValueError):
        report.Finding("x", "fatal", "nope")


# ------------------------------------------------- sharding: the formula ---


@pytest.mark.parametrize("M,P", [(2, 1), (4, 1), (2, 2), (1, 1), (4, 2), (2, 4)])
def test_rotation_formula_and_budget_are_jax_s(M, P):
    assert shardcheck.expected_ppermutes(M, P) == jshard.expected_ppermutes(M, P)
    assert shardcheck.collective_budget(12, M * 48, M, P, 4096) == \
        jshard.collective_budget(12, M * 48, M, P, 4096)


_CLI = ("import sys\n"
        "from repro_torch.analysis import preflight\n"
        "rc = preflight.main({argv!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n")


def _run_cli(*argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-c", _CLI.format(argv=list(argv))],
                          capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)


@pytest.fixture(scope="module")
def cli():
    """``python -m repro_torch.analysis.preflight --json`` on the default
    session (D = 2, P = 2, alias): exit code and report."""
    proc = _run_cli("--json")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout)


def test_cli_json_five_passes_clean(cli):
    assert cli["ok"] is True
    assert [p["pass"] for p in cli["passes"]] == PASSES
    assert all(p["ok"] for p in cli["passes"])
    s = cli["session"]
    assert s["shrunk"] is False and s["ranks"] == 4 and s["ring_size"] == 2
    assert s["sharding"]["ppermute_formula"] == 12
    assert (s["sharding"]["ppermute_expected"], s["sharding"]["model_gathers_expected"]) == (8, 2)
    checks = {f["check"] for p in cli["passes"] for f in p["findings"]}
    assert {"sharding.ppermute-count", "sharding.phi-all-gather", "sharding.collective-bytes",
            "sharding.hbm", "smem.launch", "smem.attributes", "determinism.clean",
            "concurrency.inventory", "lint.reference-import"} <= checks


def test_cli_rejects_unknown_pass(capsys):
    assert preflight.main(["--passes", "nope"]) == 2
    assert "unknown pass" in capsys.readouterr().err


@pytest.fixture(scope="module")
def train_gate():
    """``launch.train --preflight --preflight-json`` on a 2-rank alias ring
    (M = 2, P = 1), in this process: exit code, report, the functions the
    mesh spawned."""
    spawned = []
    real = mesh.spawn

    def spy(fn, **kw):
        spawned.append(fn)
        return real(fn, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(mesh, "spawn", spy)
    mp.setattr("repro_torch.training.Trainer", _no_trainer)
    try:
        out = _gate_run(["--data-shards", "2", "--sampler", "alias", "--preflight-json"])
    finally:
        mp.undo()
    return out + (spawned,)


def _no_trainer(*a, **kw):
    raise AssertionError("the gate built a Trainer")


def _gate_run(flags):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as exc:
        ttrain.main(["--device", "cpu", "--bench-out", "", "--preflight"] + flags)
    return exc.value.code, buf.getvalue()


@pytest.fixture(scope="module")
def ring_4x1():
    return preflight.build_session(preflight.SessionSpec(data_shards=4, model_shards=1))


def test_port_ring_issues_the_formula_s_ppermutes(cli, train_gate, ring_4x1):
    """Both samplers, every rank: (2, 1) from launch.train's gate, (4, 1)
    from a session, (2, 2) from the CLI's default session. Under P > 1 each
    round's stacked (doc, z) all_gather stands for JAX's (P − 1) × 2 model
    hops (ROADMAP §3)."""
    code, out, _ = train_gate
    assert code == 0, out
    sessions = {(2, 1): json.loads(out)["session"], (4, 1): ring_4x1.meta,
                (2, 2): cli["session"]}
    for (M, P), s in sessions.items():
        want = jshard.expected_ppermutes(M, P)
        port = shardcheck.port_collectives(M, P)
        for sampler in ("dense", "alias"):
            counts, gathers = s["ppermutes"][sampler], s["model_gathers"][sampler]
            assert counts == [port["ppermute"]] * (M * P), (M, P, sampler, counts)
            assert gathers == [port["model_gather"]] * (M * P), (M, P, sampler, gathers)
            assert counts[0] + 2 * (P - 1) * gathers[0] == want, (M, P, sampler)


def test_port_count_equals_jax_traced_count(cli, subproc):
    code = textwrap.dedent("""
        import json
        from repro.analysis import preflight as pf, shardcheck
        out = {}
        for sampler in ("dense", "alias"):
            s = pf.build_session(pf.SessionSpec(sampler=sampler))
            a = shardcheck.check_epoch(
                s.epoch_sm, s.abstract_args, n_topics=s.ring_cfg.n_topics,
                rows_per_shard=s.ring_cfg.rows_per_shard, n_rounds=s.ring_cfg.n_rounds,
                model_shards=s.ring_cfg.model_shards, padded_tokens=s.padded_tokens,
                hlo_text=None)
            out[sampler] = a.ppermute_traced
        print("COUNTS " + json.dumps(out))
    """)
    out = subproc(code, n_devices=4, timeout=600)
    jax_counts = json.loads(out.split("COUNTS ", 1)[1].splitlines()[0])
    P = cli["session"]["model_shards"]
    for sampler, n in jax_counts.items():
        port = [c + 2 * (P - 1) * g for c, g in zip(cli["session"]["ppermutes"][sampler],
                                                     cli["session"]["model_gathers"][sampler])]
        assert port == [n] * 4, sampler


def test_ring_4x1_is_clean_and_replay_safe(ring_4x1):
    for name in ("sharding", "determinism"):
        result = getattr(preflight, f"run_{name}_pass")(ring_4x1)
        assert result.ok, [f.message for f in result.findings]
    assert ring_4x1.meta["sharding"]["ppermute_counted"] == [16] * 4


# ------------------------------------------------- sharding: mutations ---


def test_sharding_catches_a_skipped_shift(monkeypatch):
    """A ring of two ranks whose z re-ship is not a shift (3 planes a round,
    not 4): the count errors, naming the planes, and the gate exits 1."""
    two = preflight.SessionSpec(data_shards=2, model_shards=1, sampler="dense")
    clean = preflight.run_preflight(two, passes=("sharding",))
    assert clean.ok, clean.render()
    monkeypatch.setattr(preflight, "session_rank", _torch_ranks.skipped_shift_rank)
    bad = preflight.run_preflight(two, passes=("sharding",))
    errs = _report_errors(bad)
    assert [f.check for f in errs] == ["sharding.ppermute-count"]
    assert "M·4 + M·(P−1)·2 = 8" in errs[0].message and "int32[2, " in errs[0].message
    assert errs[0].data["counted"] == [6, 6]


def test_sharding_catches_a_phi_all_gather():
    layout = mesh.init_ranks(device="cpu", rank=0, world_size=1)
    K, rows, P = 12, 48, 2
    cost, _ = tanalysis.count_cost(
        lambda: coll.all_gather(torch.zeros(rows // P, K, dtype=torch.int32), layout, "model"))
    (entry,) = cost.collective_log
    assert entry == ("all_gather", (rows // P, K), "int32", rows // P * K * 4.0)
    kw = dict(n_topics=K, rows_per_shard=rows, n_rounds=2, model_shards=P, padded_tokens=1024)
    port = shardcheck.port_collectives(2, P)
    ring = ([("ppermute", (2, 64), "int32", 512.0)] * port["ppermute"]
            + [("all_gather", (2, 2, 32), "int32", 512.0)] * port["model_gather"])
    assert not _errors(shardcheck.check_epoch([ring], **kw).findings)
    errs = _errors(shardcheck.check_epoch([ring + [entry]], **kw).findings)
    assert [f.check for f in errs] == ["sharding.phi-all-gather"]
    assert "HBM" in errs[0].message and errs[0].data["shape"] == [rows // P, K]


def test_sharding_catches_an_over_budget_rank():
    kw = dict(n_topics=12, rows_per_shard=48, n_rounds=2, model_shards=1, padded_tokens=256)
    budget = shardcheck.collective_budget(12, 96, 2, 1, 256)["collective-permute"]
    big = [("ppermute", (2, 64), "int64", budget / 7)] * 8
    errs = _errors(shardcheck.check_epoch([big], **kw).findings)
    assert [f.check for f in errs] == ["sharding.collective-bytes"]


def test_collective_log_keeps_counts_and_bytes():
    layout = mesh.init_ranks(device="cpu", rank=0, world_size=1)
    x = torch.arange(6, dtype=torch.int64).view(2, 3)
    cost, _ = tanalysis.count_cost(lambda: (coll.shift(layout, "ring", [x, x[0]]),
                                            coll.all_reduce_(x.clone(), layout, "ring", "max")))
    assert cost.collectives == {"ppermute": 2.0, "pmax": 1.0}
    assert cost.collective_bytes == {"ppermute": 72.0, "pmax": 48.0}
    assert cost.collective_log == [("ppermute", (2, 3), "int64", 48.0),
                                   ("ppermute", (3,), "int64", 24.0),
                                   ("pmax", (2, 3), "int64", 48.0)]


def test_session_shrinks_to_what_this_host_spawns():
    """The production ring (a flattened 16×16 of 256 ranks, or 16 data ×
    16 model shards) runs its epochs on at most 16 gloo ranks, at JAX's
    SessionSpec sizes; P above 16 cannot be verified here."""
    spec = preflight.SessionSpec(n_topics=100_000, vocab_size=210_000, data_shards=256,
                                 model_shards=1, n_docs=256 * 4096, package_len=72)
    assert preflight.shrink(spec) == preflight.SessionSpec(data_shards=16, model_shards=1)
    wide = preflight.shrink(preflight.SessionSpec(data_shards=16, model_shards=16))
    assert (wide.data_shards, wide.model_shards) == (1, 16)
    small = preflight.SessionSpec(n_topics=8, vocab_size=50, n_docs=40, data_shards=1)
    assert preflight.shrink(small) == small
    rep = preflight.run_preflight(preflight.SessionSpec(model_shards=32), passes=("sharding",))
    assert [f.check for f in _report_errors(rep)] == ["session.build"]


def test_hbm_over_80gb_fails_the_gate_without_a_session_rank():
    spec = preflight.SessionSpec(n_topics=100_000, vocab_size=1_000_000, data_shards=1,
                                 model_shards=1, sampler="alias", n_docs=3000)
    rep = preflight.run_preflight(spec, passes=("sharding",))
    errs = _report_errors(rep)
    assert [f.check for f in errs] == ["sharding.hbm"]
    assert errs[0].data["hbm_bytes_per_device"] > preflight.HBM_BYTES
    assert rep.session["shrunk"] is True and rep.session["run_at"]["n_topics"] == 12


# ---------------------------------------------------------- determinism ---


@pytest.mark.parametrize("op", ["index_add_", "scatter_add_", "index_put_", "scatter_reduce_"])
def test_determinism_catches_float_accumulate(op):
    idx = torch.tensor([1, 1, 3])

    def accumulate(dtype):
        x, v = torch.zeros(8, dtype=dtype), torch.ones(3, dtype=dtype)
        if op == "index_add_":
            x.index_add_(0, idx, v)
        elif op == "scatter_add_":
            x.scatter_add_(0, idx, v)
        elif op == "index_put_":
            x.index_put_((idx,), v, accumulate=True)
        else:
            x.scatter_reduce_(0, idx, v, "sum")
        return x

    found, *_ = determinism.audit(accumulate, torch.int32)
    assert found == []
    found, *_ = determinism.audit(accumulate, torch.float32)
    assert [f.check for f in found] == ["determinism.float-scatter-add"]
    assert found[0].data["op"] == op and "int32" in found[0].message
    assert found[0].location.startswith("test_torch_preflight.py:")


def test_determinism_catches_torch_rand_in_an_epoch(monkeypatch):
    """An epoch that draws from torch's generator: the gate exits 1."""
    from repro_torch.core import distributed as dist

    real = dist.build_epoch_body

    def noisy(cfg, layout=None, pod_axis=False):
        epoch = real(cfg, layout, pod_axis)

        def run(*a):
            torch.rand(4)
            return epoch(*a)
        return run

    clean = preflight.run_preflight(ONE, passes=("determinism",))
    assert clean.ok, clean.render()
    monkeypatch.setattr(dist, "build_epoch_body", noisy)
    bad = preflight.run_preflight(ONE, passes=("determinism",))
    errs = _report_errors(bad)
    assert {f.check for f in errs} == {"determinism.torch-random"} and len(errs) == 2
    assert "core/prng" in errs[0].message


def test_determinism_counts_host_reads_and_hides_kernel_bodies():
    def epoch():
        with tanalysis.kernel_call("gibbs_argmax") as charge:
            torch.zeros(4).index_add_(0, torch.tensor([0, 0]), torch.ones(2))   # a plain body
            charge(16)
        return int(torch.tensor(3)) + torch.tensor(2).item()

    found, reads, cost, out = determinism.audit(epoch)
    assert found == [] and reads == 2 and out == 5
    assert cost.kernels["gibbs_argmax"] == {"calls": 1.0, "bytes": 16.0}


# ----------------------------------------------------------------- smem ---


def test_plans_name_the_sources_kernels():
    """Every instantiation a plan names is a kernel of its library's source,
    which exports the ``<library>_attributes`` the card is read through."""
    plans = [p for sampler in ("dense", "alias")
             for p in smem.repo_kernel_plans(64, 48, 32, 20, 300, sampler=sampler)]
    plans += [ak.mh_resample_plan(300, 64, cap, 4) for cap in (16, 32, 64)]
    plans += [ek.bag_plan(D, dt, 64, F, aligned, 0)
              for D in (1, 100, 128) for dt in (0, 1) for F in (1, 26) for aligned in (0, 1)]
    plans += [p for D in (1, 18, 128) for dt, elem in ((0, 4), (1, 2))
              for p in ek.bwd_plans(26, D, dt, ek.bwd_vec(D, elem, 0), ek.bwd_copy(D, elem, 0), 0)]
    assert {p.library for p in plans} == set(kernels.kernel_names())
    for p in plans:
        text = (kernels.CSRC / f"{p.library}.cu").read_text()
        assert f"{p.library}_attributes" in text, p.library
        assert re.search(rf"\b{p.kernel.split('<')[0]}\b", text), p.kernel


def test_plans_at_the_papers_geometry_fit():
    """The alias cell's 32,768 × 100,000 word tables in one launch (over 2³¹
    elements), a 10,000-token package, dlrm's bf16 bags and gradient."""
    plans = smem.repo_kernel_plans(100_000, 32_768, 4096, 100_000, 10_000, sampler="alias")
    plans += smem.repo_kernel_plans(100_000, 32_768, 4096, 0, 10_000, sampler="dense")
    plans.append(ek.bag_plan(128, 1, 262_144, 26, True, 0))
    plans += ek.bwd_plans(26, 128, 1, 4, 16, 0)
    assert 32_768 * 100_000 > 2 ** 31
    assert {p.kernel for p in plans} >= {"alias_build_kernel", "mh_resample_kernel",
                                         "gibbs_argmax_kernel", "long_runs_kernel<bf16, 16>"}
    findings = smem.check_plans(plans)
    assert not _errors(findings), [f.message for f in _errors(findings)]


def test_smem_catches_240kib_of_shared_memory():
    """A built kernel launched with 240 KiB of dynamic shared memory (over
    the opt-in's 227), and one with 60 KiB and no opt-in (over 48)."""
    over = _attrs(dynamic_smem=240 * 1024, max_dynamic_smem=240 * 1024)
    no_opt_in = _attrs(kernel="short_runs_kernel<float, 4>", threads=256, max_threads=256,
                       dynamic_smem=60 * 1024, max_dynamic_smem=60 * 1024, opt_in=0)
    errs = _errors(smem.check_attributes([over, no_opt_in]))
    assert [f.check for f in errs] == ["smem.built"] * 2
    assert "245,760 shared bytes a block > 232,448" in errs[0].message
    assert "61,440 shared bytes a block > 49,152 without cudaFuncSetAttribute" in errs[1].message


def test_smem_catches_an_int32_overflow_at_the_gate(monkeypatch):
    """A build plan that passes R·K as an int: at the alias cell's 32,768 ×
    100,000 tables it overflows int32 and the gate exits 1; the real plan
    (R, K and the scratch words apart) passes there."""
    spec = preflight.SessionSpec(n_topics=100_000, vocab_size=32_768, data_shards=1,
                                 model_shards=1, sampler="alias", n_docs=4096)
    assert preflight.run_preflight(spec, passes=("smem",)).ok
    real = ak.alias_build_plan

    def flat(R, K):
        p = real(R, K)
        return LaunchPlan(p.library, p.kernel, p.int_args + (("RK", R * K),))
    monkeypatch.setattr(ak, "alias_build_plan", flat)
    errs = _report_errors(preflight.run_preflight(spec, passes=("smem",)))
    assert [f.check for f in errs] == ["smem.launch"]
    assert "int argument RK = 3,276,800,000 overflows int32" in errs[0].message
    assert kernels.plan_problems(ak.mh_resample_plan(2 ** 31, 12, 8, 4)) == [
        "int argument T = 2,147,483,648 overflows int32"]
    with pytest.raises(ValueError, match="refused"):
        kernels.launch_args(ak.mh_resample_plan(2 ** 31, 12, 8, 4))


def _attrs(**kw):
    a = dict(library="embedding_bag_bwd", kernel="long_runs_kernel<bf16, 16>", regs=80,
             static_smem=0, dynamic_smem=71_680, max_dynamic_smem=71_680, local_bytes=0,
             binary_version=90, ptx_version=90, max_threads=160, threads=160, blocks_per_sm=2,
             opt_in=1)
    a.update(kw)
    return a


@pytest.mark.parametrize("bad,check", [
    (dict(binary_version=80), "smem.built"),
    (dict(regs=255, threads=1024, max_threads=1024), "smem.built"),
    (dict(static_smem=200_000), "smem.built"),
    (dict(blocks_per_sm=0), "smem.built"),
    (dict(kernel="long_runs_kernel<bf16, 8>"), "smem.plan"),
    (dict(threads=2048, max_threads=2048, regs=16), "smem.built"),
])
def test_smem_holds_built_kernels_to_sm90(bad, check):
    plan = ek.bwd_plans(26, 128, 1, 4, 16, 0)[-1]
    assert plan.kernel == "long_runs_kernel<bf16, 16>"
    ok = smem.check_attributes([_attrs()], [plan])
    assert not _errors(ok) and "2 blocks/SM" in ok[0].message
    plans = [plan] if check == "smem.plan" else []
    assert [f.check for f in _errors(smem.check_attributes([_attrs(**bad)], plans))] == [check]


def test_smem_warns_on_spills_and_reports_no_card():
    f = smem.check_attributes([_attrs(local_bytes=64)])
    assert [x.severity for x in f] == ["info", "warning"] and f[1].check == "smem.spills"
    (none,) = smem.check_attributes(None)
    assert none.severity == "info" and "no card" in none.message


# ----------------------------------------------------------------- lint ---


def _fake_port(tmp_path, ref=True, source=True, marked=True, extra=""):
    tmp_path.mkdir(parents=True, exist_ok=True)
    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
    pkg = tmp_path / "src" / "repro_torch" / "kernels" / "foo"
    pkg.mkdir(parents=True)
    (pkg / "ops.py").write_text("def foo(x):\n    return x\n")
    (pkg / "kernel.py").write_text(
        "from repro_torch.kernels import LaunchPlan\n\n\n"
        "def foo_plan(n):\n    return LaunchPlan('foo', 'foo_kernel', (('n', n),))\n")
    if ref:
        (pkg / "ref.py").write_text("def foo_ref(x):\n    return x\n")
    csrc = tmp_path / "src" / "repro_torch" / "csrc"
    csrc.mkdir()
    if source:
        (csrc / "foo.cu").write_text("// foo\n")
    (tmp_path / "tests").mkdir()
    mark = "import pytest\n\n\n@pytest.mark.kernels\n" if marked else ""
    (tmp_path / "tests" / "test_torch_kernels_foo.py").write_text(
        mark + "def test_foo():\n    pass\n")
    if extra:
        (tmp_path / "src" / "repro_torch" / "extra.py").write_text(textwrap.dedent(extra))
    return str(tmp_path)


@pytest.mark.parametrize("mutation,check", [
    (dict(ref=False), "lint.kernel-oracle"),
    (dict(source=False), "lint.kernel-source"),
    (dict(marked=False), "lint.kernel-test"),
    (dict(extra="""
        import dataclasses

        @dataclasses.dataclass
        class SloppyConfig:
            x: int = 1
        """), "lint.frozen-config"),
    (dict(extra="""
        import torch

        def pick():
            return "cuda" if torch.cuda.is_available() else "cpu"
        """), "lint.device-probe"),
    (dict(extra="""
        def helper():
            import jax.numpy as jnp
            return jnp
        """), "lint.reference-import"),
    (dict(extra="from repro.core import lda\n"), "lint.reference-import"),
    (dict(extra="import importlib\n\nmod = importlib.import_module('jaxlib')\n"),
     "lint.reference-import"),
    (dict(extra="""
        import threading

        def start():
            threading.Thread(target=print).start()
        """), "lint.thread-contract"),
])
def test_lint_catches_each_seeded_fault(tmp_path, mutation, check):
    clean = repolint.lint_repo(_fake_port(tmp_path / "clean"), advisories=False)
    assert not _errors(clean), [f.message for f in _errors(clean)]
    root = _fake_port(tmp_path / "bad", **mutation)
    assert [f.check for f in _errors(repolint.lint_repo(root, advisories=False))] == [check]
    assert not preflight.run_preflight(ONE, passes=("lint",), root=root).ok


def test_lint_allows_the_port_s_own_imports_and_the_real_tree(tmp_path):
    root = _fake_port(tmp_path, extra="from repro_torch.core import lda\nimport repro_torch\n")
    assert not _errors(repolint.lint_repo(root))
    real = repolint.lint_repo(ROOT)
    assert not _errors(real), [f.message for f in _errors(real)]
    assert any(f.check == "lint.reference-import" and f.severity == "info" for f in real)


def test_concurrency_gate_catches_an_unguarded_write(tmp_path):
    root = _fake_port(tmp_path, extra="""
        import threading

        class C:
            _GUARDED_BY = {"_count": "_lock"}

            def __init__(self):
                self._lock = threading.Lock()
                self._count = 0
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _run(self):
                while not self.stopped():
                    with self._lock:
                        self._count += 1

            def bump(self):
                self._count += 1

            def close(self):
                self._t.join()
        """)
    rep = preflight.run_preflight(ONE, passes=("concurrency",), root=root)
    assert [f.check for f in _report_errors(rep)] == ["concurrency.guard"]


# ---------------------------------------------------------- the launchers --


def test_train_gate_verdict_before_any_rank(train_gate):
    code, out, spawned = train_gate
    assert code == 0
    doc = json.loads(out)
    assert doc["ok"] and [p["pass"] for p in doc["passes"]] == PASSES
    assert doc["session"]["ring_size"] == 2 and doc["session"]["model_shards"] == 1
    assert spawned == [preflight.session_rank]       # its CPU world, never _rank_main


def test_train_gate_exits_1_on_an_invalid_geometry(monkeypatch):
    spawned = []
    monkeypatch.setattr(mesh, "spawn", lambda fn, **kw: spawned.append(fn))
    monkeypatch.setattr("repro_torch.training.Trainer", _no_trainer)
    code, out = _gate_run(["--topics", "100000", "--vocab", "1000000"])
    assert code == 1 and "sharding.hbm" in out and "[preflight] FAILED" in out
    assert spawned == []


def test_serve_gate_json():
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as exc:
        tserve.main(["--preflight", "--preflight-json"])
    assert exc.value.code == 0
    doc = json.loads(buf.getvalue())
    assert [p["pass"] for p in doc["passes"]] == ["concurrency", "lint"]
    inventory = next(f for p in doc["passes"] for f in p["findings"]
                     if f["check"] == "concurrency.inventory")
    assert all(c in inventory["message"] for c in tserve.SERVING_CLASSES)


def test_dryrun_verify_exits_with_the_verdict(monkeypatch, capsys):
    seen = []

    def canned(spec, passes=preflight.PASSES, root=None):
        seen.append(spec)
        rep = report.PreflightReport(session={"sampler": spec.sampler})
        rep.add(report.PassResult("lint", [report.info("lint.ok", "fine")]))
        if len(seen) == 2:
            rep.add(report.PassResult("smem", [report.error("smem.launch", "too big")]))
        return rep

    monkeypatch.setattr(preflight, "run_preflight", canned)
    assert tdryrun.main(["--verify"]) == 0
    assert "[preflight] OK" in capsys.readouterr().out
    assert tdryrun.main(["--verify", "--json"]) == 1
    assert json.loads(capsys.readouterr().out)["ok"] is False
    assert seen == [preflight.SessionSpec()] * 2
