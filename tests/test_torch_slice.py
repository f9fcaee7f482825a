"""The port's whole single-device slice against the JAX package:
synthetic corpus → Gibbs epochs → α re-estimation → RT-LDA model → served
features, on the same inputs. Plus the port's two package-level contracts:
it never imports jax or repro, and its entry points refuse to run without
CUDA unless asked for the CPU.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro.core import dedup as jdedup, features as jfeatures, gibbs as jgibbs
from repro.core import lda as jlda, rtlda as jrtlda
from repro.data import corpus as jcorpus, synthetic as jsynthetic
from repro_torch import convert
from repro_torch.core import dedup as tdedup, features as tfeatures, gibbs as tgibbs
from repro_torch.core import lda as tlda, rtlda as trtlda
from repro_torch.data import corpus as tcorpus, synthetic as tsynthetic

pytestmark = pytest.mark.port

V, K, BLOCK, EPOCHS = 300, 16, 512, 4
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def test_synthetic_corpus_is_the_same():
    for kw in (dict(query_like=True), dict(stopword_frac=0.3, doc_len_mean=6)):
        jc, jt = jsynthetic.lda_corpus(seed=3, n_docs=200, n_topics=12, vocab_size=V, **kw)
        tc, tt = tsynthetic.lda_corpus(seed=3, n_docs=200, n_topics=12, vocab_size=V, **kw)
        for a, b in [(tc.word_ids, jc.word_ids), (tc.doc_ids, jc.doc_ids),
                     (tt.topic_word, jt.topic_word), (tt.doc_topic, jt.doc_topic)]:
            np.testing.assert_array_equal(a, b)
        assert (tc.n_docs, tc.vocab_size) == (jc.n_docs, jc.vocab_size)
        for a, b in zip(tcorpus.pad_corpus(tc.word_ids, tc.doc_ids, 64),
                        jcorpus.pad_corpus(jc.word_ids, jc.doc_ids, 64)):
            np.testing.assert_array_equal(a, b)


def test_train_export_serve_matches_jax():
    corpus, _ = tsynthetic.lda_corpus(seed=1, n_docs=600, n_topics=12, vocab_size=V,
                                      query_like=True)
    wi, di = tcorpus.pad_corpus(corpus.word_ids, corpus.doc_ids, BLOCK)
    valid = wi >= 0
    D = corpus.n_docs

    # --- train: same z0 (JAX's threefry draw), same epochs ---
    js = jlda.init_state(jax.random.key(1), jnp.array(wi[valid]), K, V)
    z = np.zeros(len(wi), np.int32)
    z[valid] = np.asarray(js.z)
    js = jlda.LDAState(js.phi, js.psi, jnp.array(z), js.alpha, js.beta)
    ts = tlda.init_state(wi[valid], K, V, z0=z[valid], device="cpu")
    ts = tlda.LDAState(ts.phi, ts.psi, torch.from_numpy(z), ts.alpha, ts.beta)
    twi, tdi, tvalid = (torch.from_numpy(x) for x in (wi, di, valid))
    for e in range(EPOCHS):
        js = jgibbs.gibbs_epoch(js, jnp.array(wi), jnp.array(di), D, V, seed=e * 31 + 7,
                                block_size=BLOCK)
        ts = tgibbs.gibbs_epoch(ts, twi, tdi, D, V, seed=e * 31 + 7, block_size=BLOCK)
    for name in ("z", "phi", "psi"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), err_msg=name)
    tlda.check_invariants(tlda.LDAState(ts.phi, ts.psi, ts.z[tvalid], ts.alpha, ts.beta),
                          twi[tvalid])

    # --- α re-estimation ---
    jomega = jdedup.topic_count_histogram(jnp.array(di), js.z, jnp.array(valid), D, K)
    tomega = tdedup.topic_count_histogram(tdi, ts.z, tvalid, D, K)
    np.testing.assert_array_equal(tomega.numpy(), np.asarray(jomega))
    lengths = corpus.doc_lengths().astype(np.int32)
    jdl = jdedup.doc_length_histogram(jnp.array(lengths))
    tdl = tdedup.doc_length_histogram(torch.from_numpy(lengths))
    ja = jdedup.optimize_alpha(js.alpha, jomega, jdl, n_iters=5)
    ta = tdedup.optimize_alpha(ts.alpha, tomega, tdl, n_iters=5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5)

    # --- export ---
    jm = jrtlda.build_model(js.phi, js.beta, ja)
    tm = trtlda.build_model(ts.phi, ts.beta, ta, device="cpu")
    np.testing.assert_allclose(tm.pvk.numpy(), np.asarray(jm.pvk), rtol=1e-6)
    np.testing.assert_array_equal(tm.r_topic.numpy(), np.asarray(jm.r_topic))

    # --- serve: a batch of queries in bucket 8 ---
    q = np.full((128, 8), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(corpus.doc_lengths())])
    for i in range(128):
        toks = corpus.word_ids[starts[i]:starts[i + 1]][:8]
        q[i, :len(toks)] = toks
    jp, ji, jw = jfeatures.query_topic_features(jm, jnp.array(q), seed=11, n_trials=2)
    tp, ti, tw = tfeatures.make_serving_fn(5, 2, 30, device="cpu")(tm, q, 11)
    # α carries its 1e-5 into P(k|d) additively
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4)
    # ids agree except where two words' weights are a near-tie
    diff = ti.numpy() != np.asarray(ji)
    assert np.allclose(tw.numpy()[diff], np.asarray(jw)[diff], rtol=1e-4)
    assert torch.isfinite(tp).all() and ((ti >= 0) & (ti < V)).all()


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]), bad)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, check=True).stdout.split()
    assert int(out[0]) >= 32 and out[1] == "[]"


def test_entry_points_refuse_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.data import fixtures
    w = np.zeros(4, np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlda.init_state(w, 4, 5, z0=w)
    with pytest.raises(RuntimeError, match="CUDA"):
        trtlda.build_model(np.ones((5, 4), np.int32), np.float32(0.01),
                           np.ones(4, np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        tfeatures.make_serving_fn()
    with pytest.raises(RuntimeError, match="CUDA"):
        fixtures.quick_train(4, 50, train_iters=1, n_docs=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.lda_state_from_numpy(w, w, w, w, 0.01, "cuda")
    # ... and run when asked for the CPU
    st = tlda.init_state(w, 4, 5, z0=w, device="cpu")
    assert st.phi.device.type == "cpu"
