"""Beam search and the beam decoders (ROADMAP A6) in the port against the
JAX package, on the CPU.

- beam_search on test_control_flow.py's case (a finished beam stays on
  end_id at its score) and on a row of exact ties (the top-k must give
  lax.top_k's order: the lower flat index first); selected ids, parents
  and scores equal.
- The Transformer's build_decode (the whole decoder re-run on the prefix
  at each step) and build_cached_decode (per-layer KV caches) and the
  attention translator's build_decode build the JAX package's program
  bytes, and run in a scope the JAX package trained (copied with
  io.scope_from_numpy): the Transformer of tests/book/test_transformer.py
  (vocabulary 20, T = 8, 2 layers, 2 heads, d_model 32) trained on its
  copy task for 40 Adam steps, the translator (dictionary 20, widths 16,
  attention) for 40 Adam steps on the book test's shift-by-one task.
  Sentence ids equal the JAX package's exactly; the port's cached decode
  equals its full decode token for token, as tests/book/
  test_transformer.py:279 holds the JAX package's.

Tolerances: sentence scores rtol = atol = 1e-5 (sums of up to 8 fp32
log-probs through 2 layers, computed in another order); ids, parents and
the beam_search step's scores (sums of two fed values) exact.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc
from paddle_tpu.core.lod import LoDTensor as JLoDTensor
from paddle_tpu.models import machine_translation as jmt
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.core.lod import LoDTensor as TLoDTensor
from paddle_tpu_torch.models import machine_translation as tmt
from paddle_tpu_torch.models import transformer as ttr

SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
VOCAB, MAX_LEN, N_HEAD, K = 20, 8, 2, 2
TR = dict(src_vocab_size=VOCAB, trg_vocab_size=VOCAB, max_length=MAX_LEN,
          n_layer=2, n_head=N_HEAD, d_key=16, d_value=16, d_model=32,
          d_inner_hid=64)
MT = dict(dict_size=20, word_dim=16, hidden_dim=16, decoder_size=16,
          use_attention=True)
MT_DECODE = dict(MT, beam_size=K, max_length=6, start_id=1, end_id=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(pkg, fn, **kwargs):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        out = fn(**kwargs)
    return main, startup, out


def _same_bytes(jmain, tmain):
    jd = json.loads(jdesc.program_to_bytes(jmain))
    td = json.loads(tdesc.program_to_bytes(tmain))
    for jb, tb in zip(jd["blocks"], td["blocks"]):
        for jv, tv in zip(jb["vars"], tb["vars"]):
            if (jv["dtype"], tv["dtype"]) == ("int32", "int64"):
                jv["dtype"] = "int64"
    assert td == jd


def _decode_both(jscope, jmain, tmain, jfetch, tfetch, jfeed, tfeed):
    """Run a decode program in the JAX package's trained scope and in the
    port from a copy of it; returns (jax outputs, port outputs)."""
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jout = [np.asarray(v) for v in
                exe.run(jmain, feed=jfeed, fetch_list=list(jfetch))]
    state = {v.name: np.array(jscope.get(v.name))
             for v in jmain.list_vars() if v.persistable}
    tscope = tio.scope_from_numpy(state, "cpu", program=tmain)
    tout = tfluid.Executor("cpu").run(tmain, feed=tfeed,
                                      fetch_list=list(tfetch), scope=tscope)
    return jout, tout


# ---------------------------------------------------------- beam_search --

def _beam_step(fluid, b, v):
    layers = fluid.layers
    pre_ids = layers.data("pre_ids", shape=[K], append_batch_size=False,
                          dtype="int64")
    pre_scores = layers.data("pre_scores", shape=[K],
                             append_batch_size=False)
    probs = layers.data("probs", shape=[K, v], append_batch_size=False)
    return layers.beam_search(pre_ids=pre_ids, pre_scores=pre_scores,
                              ids=None, scores=probs, beam_size=K, end_id=0,
                              return_parent_idx=True)


def _beam_case(name):
    b, v = 2, 5
    pre_ids = np.array([[1, 2], [0, 3]], dtype="int64")  # row 1 beam 0 done
    pre_scores = np.zeros((b, K), np.float32)
    if name == "finished_beam":
        logp = np.log(np.full((b, K, v), 1e-9, np.float32))
        logp[0, 0, 3] = np.log(0.9)
        logp[0, 1, 4] = np.log(0.8)
        logp[1, 1, 2] = np.log(0.7)
    else:                    # every candidate of row 0 ties, row 1 in part
        logp = np.full((b, K, v), -1.0, np.float32)
        logp[1, 1, [1, 3]] = -0.5
        pre_ids[1, 0] = 4
    return {"pre_ids": pre_ids, "pre_scores": pre_scores, "probs": logp}


@pytest.mark.parametrize("name", ["finished_beam", "ties"])
def test_beam_search_step_matches_the_jax_package(name):
    feed = _beam_case(name)
    jmain, _, jout = _build(jfluid, _beam_step, fluid=jfluid, b=2, v=5)
    tmain, _, tout = _build(tfluid, _beam_step, fluid=tfluid, b=2, v=5)
    _same_bytes(jmain, tmain)
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        want = [np.asarray(x) for x in
                exe.run(jmain, feed=feed, fetch_list=list(jout))]
    got = tfluid.Executor("cpu").run(tmain, feed=feed,
                                     fetch_list=list(tout),
                                     scope=tfluid.Scope())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if name == "finished_beam":
        assert got[0][0].tolist() == [3, 4] and 0 in got[0][1]
    else:
        # ties: the lowest flat index (parent * V + token) first
        assert got[0][0].tolist() == [0, 1] and got[2][0].tolist() == [0, 0]


# ------------------------------------------------------ the Transformer --

@pytest.fixture(scope="module")
def transformer_scope():
    """The JAX package's Transformer after 40 Adam steps of the copy task
    on two sentences; returns (its scope, the source sentences)."""
    main, startup, (_, avg_cost, _) = _build(
        jfluid, jtr.build_train, warmup_steps=20, learning_rate=2.0, **TR)
    rng = np.random.RandomState(17)
    srcs = [rng.randint(3, VOCAB, 4).tolist(),
            rng.randint(3, VOCAB, 6).tolist()]
    data = [jtr.prepare_batch([s], [s], MAX_LEN, N_HEAD) for s in srcs]
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for i in range(40):
            exe.run(main, feed=data[i % 2], fetch_list=[avg_cost])
    return scope, srcs


_DECODERS = {"full": ("build_decode", "prepare_decode_batch"),
             "cached": ("build_cached_decode", "prepare_cached_decode_batch")}


@pytest.fixture(scope="module")
def transformer_decodes(transformer_scope):
    """{kind: ((JAX ids, scores), (port ids, scores))} of both decoders
    on the trained scope, each program's bytes held to the JAX
    package's."""
    scope, srcs = transformer_scope
    out = {}
    for kind, (fn, prep) in _DECODERS.items():
        jmain, _, jfetch = _build(jfluid, getattr(jtr, fn), beam_size=K,
                                  **TR)
        tmain, _, tfetch = _build(tfluid, getattr(ttr, fn), beam_size=K,
                                  **TR)
        _same_bytes(jmain, tmain)
        out[kind] = _decode_both(
            scope, jmain, tmain, jfetch, tfetch,
            getattr(jtr, prep)(srcs, MAX_LEN, N_HEAD, K),
            getattr(ttr, prep)(srcs, MAX_LEN, N_HEAD, K))
    return out


@pytest.mark.parametrize("kind", ["full", "cached"])
def test_transformer_decode_matches_the_jax_package(transformer_decodes,
                                                    kind):
    (jids, jscores), (tids, tscores) = transformer_decodes[kind]
    assert tids.shape == (2, K, MAX_LEN)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tscores, jscores, **SCORE_TOL)
    assert (tids[:, :, 0] == 1).all()


def test_transformer_cached_decode_equals_the_full_decode(
        transformer_decodes):
    full_ids, full_scores = transformer_decodes["full"][1]
    ids, scores = transformer_decodes["cached"][1]
    np.testing.assert_array_equal(ids, full_ids)
    np.testing.assert_allclose(scores, full_scores, **SCORE_TOL)


def test_fuse_qkv_decode_raises_the_jax_message():
    for module in (jtr, ttr):
        for fn in ("build_decode", "build_cached_decode"):
            with pytest.raises(NotImplementedError,
                               match="decode a fuse_qkv-trained scope"):
                _build(tfluid if module is ttr else jfluid,
                       getattr(module, fn), fuse_qkv=True, **TR)


# ------------------------------------------------------ the translator --

def _mt_batch(rng, batch=8):
    """The book test's task: the decoder must emit x + 1 for input x."""
    src, trg, nxt = [], [], []
    for _ in range(batch):
        s = rng.randint(3, MT["dict_size"] - 2, size=rng.randint(3, 7))
        t = np.concatenate([[1], s])
        src.append(s.reshape(-1, 1).astype("int64"))
        trg.append(t.reshape(-1, 1).astype("int64"))
        nxt.append((t + 1).reshape(-1, 1).astype("int64"))
    return src, trg, nxt


def test_translator_decode_matches_the_jax_package():
    main, startup, (avg_cost, _) = _build(
        jfluid, jmt.build_train, learning_rate=0.01, optimizer="adam", **MT)
    rng = np.random.RandomState(0)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(40):
            feed = dict(zip(("src_word_id", "target_language_word",
                             "target_language_next_word"),
                            map(JLoDTensor.from_sequences, _mt_batch(rng))))
            exe.run(main, feed=feed, fetch_list=[avg_cost])
    src = _mt_batch(rng, 3)[0]
    init_ids = np.full((3, K), 1, "int64")
    init_scores = np.zeros((3, K), "float32")
    init_scores[:, 1:] = -1e9
    jmain, _, jfetch = _build(jfluid, jmt.build_decode, **MT_DECODE)
    tmain, _, tfetch = _build(tfluid, tmt.build_decode, **MT_DECODE)
    _same_bytes(jmain, tmain)
    feed = {"init_ids": init_ids, "init_scores": init_scores}
    (jids, jscores), (tids, tscores) = _decode_both(
        scope, jmain, tmain, jfetch, tfetch,
        dict(feed, src_word_id=JLoDTensor.from_sequences(src)),
        dict(feed, src_word_id=TLoDTensor.from_sequences(src)))
    assert tids.shape == (3, K, MT_DECODE["max_length"] + 1)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tscores, jscores, **SCORE_TOL)
