"""The book's semantic role labeller (chapter 07: db-lstm + linear-chain
CRF, models/label_semantic_roles.py) in the port against the JAX package,
on the CPU.

- The model: build_train at a small config (dictionaries 60 / 8 / 9,
  word_dim 16, mark_dim 4, hidden 16, depth 2: one forward and one
  reverse LSTM, relu candidate and sigmoid cell) builds the JAX package's
  program bytes (zoo `srl`'s are held in tests/test_torch_zoo.py).
- Training: from the JAX startup state (io.scope_from_numpy) with the
  frozen `emb` set label-informative, as tests/book/
  test_label_semantic_roles.py sets it, two SGD steps (lr 0.03 on
  exponential_decay, `crfw` at learning_rate 0.5) on the same batches of
  8 sentences of 3-8 words from a seed: each step's loss, the Viterbi
  decode and the chunk counts; then every persistable. The frozen `emb`
  must not move.
- Serving: the inference program (the 8 feature feeds, db_lstm and
  crf_decoding on `crfw`, built apart from the training program; saved
  by save_inference_model with crf_decode as the target) saved by either
  package and
  served by the port's InferenceEngine on the CPU with 8 int LoD feeds:
  each answer equal to run_direct at its bucket and to the JAX package's
  own decode of the same sentence.

Tolerances: losses and persistables rtol = atol = 1e-5 (fp32 on both
sides, summed in another order, two steps of two LSTMs over at most 8
steps); decodes, chunk counts and served answers exact.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc
from paddle_tpu.core.lod import LoDTensor as JLoDTensor
from paddle_tpu.models import label_semantic_roles as jsrl

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.core.lod import LoDTensor as TLoDTensor
from paddle_tpu_torch.models import label_semantic_roles as tsrl
from paddle_tpu_torch.serving import InferenceEngine

WORD, VERB, LABEL = 60, 8, 9
CFG = dict(word_dict_len=WORD, label_dict_len=LABEL, pred_dict_len=VERB,
           word_dim=16, mark_dim=4, hidden_dim=16, depth=2, lr=0.03,
           mix_hidden_lr=0.5)
TOL = dict(rtol=1e-5, atol=1e-5)
_PKG = {"jax": (jfluid, JLoDTensor, jsrl), "port": (tfluid, TLoDTensor,
                                                    tsrl)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are small: one intra-op thread does, and leaves the
    other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synth_batch(rng, n, lens=(3, 8)):
    """The book test's synthetic conll05 rows: 9 columns of per-word ids
    (the word, its 5-word context around the predicate, the predicate,
    the mark, the label); labels follow the words, so the CRF can learn."""
    word2label = np.arange(WORD) % LABEL
    cols = [[] for _ in range(9)]
    for _ in range(n):
        length = rng.randint(lens[0], lens[1] + 1)
        words = rng.randint(0, WORD, length)
        pred_pos = rng.randint(0, length)
        verb = rng.randint(0, VERB)
        mark = np.zeros(length, dtype="int64")
        mark[pred_pos] = 1

        def ctx(off):
            i = min(max(pred_pos + off, 0), length - 1)
            return np.full(length, words[i], dtype="int64")

        seqs = [words, ctx(-2), ctx(-1), ctx(0), ctx(1), ctx(2),
                np.full(length, verb, dtype="int64"), mark,
                word2label[words]]
        for c, s in zip(cols, seqs):
            c.append(np.asarray(s, dtype="int64").reshape(-1, 1))
    return cols


def _build(pkg):
    fluid, _, srl = _PKG[pkg]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = srl.build_train(**CFG)
    return main, startup, out


def _label_informative_emb():
    emb = 0.1 * np.random.RandomState(1).randn(WORD, 16).astype("f")
    emb[np.arange(WORD), np.arange(WORD) % LABEL] += 2.0
    return emb


def _jax_state():
    main, startup, out = _build("jax")
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
    scope.set("emb", _label_informative_emb())
    return main, out, exe, scope


def test_build_train_is_the_jax_program():
    jmain, jstartup, jout = _build("jax")
    tmain, tstartup, tout = _build("port")
    jd = json.loads(jdesc.program_to_bytes(jmain))
    td = json.loads(tdesc.program_to_bytes(tmain))
    for jb, tb in zip(jd["blocks"], td["blocks"]):
        for jv, tv in zip(jb["vars"], tb["vars"]):
            if (jv["dtype"], tv["dtype"]) == ("int32", "int64"):
                jv["dtype"] = "int64"
    assert td == jd
    assert tdesc.program_to_bytes(tstartup) == \
        jdesc.program_to_bytes(jstartup)
    assert jout[0] == tout[0] == tsrl.FEATURE_NAMES + ["target"]
    types = {op.type for op in tmain.global_block().ops}
    assert {"lstm", "linear_chain_crf", "crf_decoding", "chunk_eval",
            "sgd"} <= types


def test_two_sgd_steps_match_the_jax_package():
    jmain, (names, javg, jdecode, jchunk), jexe, jscope = _jax_state()
    state = {v.name: np.array(jscope.get(v.name))
             for v in jmain.list_vars() if v.persistable}
    tmain, _, (_, tavg, tdecode, tchunk) = _build("port")
    tscope = tio.scope_from_numpy(state, "cpu", program=tmain)
    texe = tfluid.Executor("cpu")
    rng = np.random.RandomState(11)
    for step in range(2):
        cols = synth_batch(rng, 8)
        with jfluid.scope_guard(jscope):
            want = jexe.run(jmain, feed={n: JLoDTensor.from_sequences(c)
                                         for n, c in zip(names, cols)},
                            fetch_list=[javg, jdecode] + list(jchunk))
        got = texe.run(tmain, feed={n: TLoDTensor.from_sequences(c)
                                    for n, c in zip(names, cols)},
                       fetch_list=[tavg, tdecode] + list(tchunk),
                       scope=tscope)
        want = [np.asarray(w) for w in want]
        np.testing.assert_allclose(got[0], want[0], err_msg="loss %d"
                                   % step, **TOL)
        for i in range(1, len(got)):
            if want[i].dtype.kind == "f":
                np.testing.assert_allclose(got[i], want[i], rtol=1e-6,
                                           err_msg="fetch %d" % i)
            else:
                np.testing.assert_array_equal(got[i], want[i],
                                              err_msg="fetch %d" % i)
    for name, arr in state.items():
        np.testing.assert_allclose(tscope.get(name).numpy(),
                                   np.array(jscope.get(name)),
                                   err_msg=name, **TOL)
    np.testing.assert_array_equal(tscope.get("emb").numpy(), state["emb"])
    assert not np.array_equal(tscope.get("crfw").numpy(), state["crfw"])


def build_infer(fluid, srl):
    """The inference program: the 8 feature feeds, db_lstm and the Viterbi
    decode with the trained `crfw`, built without the training program's
    cost and optimizer (its parameters take the training program's names;
    a pruned training program would keep the SGD ops, since `crfw` is an
    output of its SGD op). Returns the decode."""
    feats = [fluid.layers.data(name=n, shape=[1], dtype="int64",
                               lod_level=1) for n in srl.FEATURE_NAMES]
    word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, verb, mark = feats
    kw = {k: v for k, v in CFG.items() if k not in ("lr", "mix_hidden_lr")}
    feature_out = srl.db_lstm(word=word, predicate=verb, ctx_n2=ctx_n2,
                              ctx_n1=ctx_n1, ctx_0=ctx_0, ctx_p1=ctx_p1,
                              ctx_p2=ctx_p2, mark=mark, **kw)
    return fluid.layers.crf_decoding(
        input=feature_out, param_attr=fluid.ParamAttr(name="crfw"))


def _infer_program(pkg):
    fluid, _, srl = _PKG[pkg]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        decode = build_infer(fluid, srl)
    return main, decode


def _save_inference(pkg, tmp):
    """The inference program of `pkg` saved with the JAX startup state:
    (model dir, the JAX inference program, its decode, the JAX scope)."""
    _, _, jexe, jscope = _jax_state()
    jinfer, jdecode = _infer_program("jax")
    path = os.path.join(str(tmp), pkg)
    if pkg == "jax":
        with jfluid.scope_guard(jscope):
            jfluid.io.save_inference_model(
                path, tsrl.FEATURE_NAMES, [jdecode], jexe,
                main_program=jinfer)
        return path, jinfer, jdecode, jscope
    tinfer, tdecode = _infer_program("port")
    state = {v.name: np.array(jscope.get(v.name))
             for v in tinfer.list_vars() if v.persistable}
    scope = tio.scope_from_numpy(state, "cpu", program=tinfer)
    tio.save_inference_model(path, tsrl.FEATURE_NAMES, [tdecode],
                             tfluid.Executor("cpu"), main_program=tinfer,
                             scope=scope)
    return path, jinfer, jdecode, jscope


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_served_decodes_equal_run_direct_and_the_jax_decode(saved_by,
                                                            tmp_path):
    path, jinfer, jdecode, jscope = _save_inference(saved_by, tmp_path)
    engine = InferenceEngine(path, device="cpu", batch_buckets=[1, 4],
                             seq_buckets=[8, 16])
    try:
        assert engine.feed_names == tsrl.FEATURE_NAMES
        rng = np.random.RandomState(5)
        requests = []
        for i in range(4):
            cols = synth_batch(rng, 1 + i % 2, lens=(2, 12))
            requests.append(dict(zip(tsrl.FEATURE_NAMES, cols[:8])))
        futures = [engine.submit(r) for r in requests]
        answers = [f.result(30).numpy()[engine.fetch_names[0]]
                   for f in futures]
        # the JAX package's decode of the same sentences, on the same state
        jexe = jfluid.Executor(jfluid.CPUPlace())
        for req, fut, ans in zip(requests, futures, answers):
            direct, bucket = engine.run_direct(
                req, batch_bucket=fut.bucket[0], seq_bucket=fut.bucket[1])
            assert bucket == fut.bucket
            np.testing.assert_array_equal(direct[engine.fetch_names[0]],
                                          ans)
            feed = {n: JLoDTensor.from_sequences(v) for n, v in req.items()}
            with jfluid.scope_guard(jscope):
                want, = jexe.run(jinfer, feed=feed, fetch_list=[jdecode])
            want = np.asarray(want)
            assert ans.dtype == np.int64 and ans.shape[1] == fut.bucket[1]
            for row, seq in enumerate(req["word_data"]):
                n = len(seq)
                np.testing.assert_array_equal(ans[row, :n], want[row, :n])
                assert not ans[row, n:].any()
    finally:
        engine.close()
