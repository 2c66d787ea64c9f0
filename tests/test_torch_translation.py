"""The port's attention translator (book chapter 08, training) against the
JAX package on the CPU.

Both packages build machine_translation.build_train at the zoo's seq2seq
size (paddle_tpu/models/zoo.py: dictionary 30, word 8, hidden 16, decoder
16); the JAX package runs its startup program and every persistable it
holds (Adam's moments and beta pows, or Adagrad's moments) is carried into
the port with io.scope_from_numpy. Feeds are made with numpy from a seed:
batch 4, source and target lengths 1-11, different in every row, so the
attention masks by the source lengths while the DynamicRNN masks by the
target lengths. The JAX package runs its masked-softmax kernel in
interpret mode (PADDLE_TPU_PALLAS=seq) and its where-mask path (=0); the
port runs its kernel wrappers' plain versions.

Tolerances: rtol = atol = 1e-5 on the loss and on every step-1 gradient
(fp32 on both sides, summed in another order, through at most 16 encoder
and decoder steps). The 20 optimizer steps are held as
tests/test_torch_sequences.py holds them: every loss within rtol 1e-5, and
every persistable after 20 steps within 2 * (the sum of the steps'
learning rates) elementwise, with at most 0.1% of the elements more than
1e-4 apart (an Adam or Adagrad step moves a parameter by up to lr whatever
the size of its gradient).
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc
from paddle_tpu.models import machine_translation as jmt

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.models import machine_translation as tmt
from paddle_tpu_torch.ops import cuda_kernels as ck

DICT, WORD, HID, DEC, BATCH, STEPS, LR = 30, 8, 16, 16, 4, 20, 0.01
TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_ATOL = 2 * STEPS * LR
PARAM_CLOSE, PARAM_FAR_SHARE = 1e-4, 1e-3
FUSED, UNFUSED = "seq", "0"
_PKG = {"jax": (jfluid, jmt), "port": (tfluid, tmt)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: one intra-op thread does, and leaves the other
    test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(pkg, use_attention=True, optimizer="adam"):
    fluid, mt = _PKG[pkg]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        avg_cost, pred = mt.build_train(
            dict_size=DICT, word_dim=WORD, hidden_dim=HID,
            decoder_size=DEC, learning_rate=LR, use_attention=use_attention,
            optimizer=optimizer)
    return main, startup, avg_cost, pred


def _lengths(seed):
    """(source, target) lengths in 1-11, each with a full and a length-1
    row; the first row is (11, 1) and the last (1, 11)."""
    rng = np.random.RandomState(seed)
    src, trg = rng.randint(1, 12, BATCH), rng.randint(1, 12, BATCH)
    src[0], src[-1], trg[0], trg[-1] = 11, 1, 1, 11
    return src, trg


def _feed(pkg, seed):
    """Random ids; the label is the target shifted by one."""
    lod = _PKG[pkg][0].LoDTensor
    src_lens, trg_lens = _lengths(seed + 1000)
    rng = np.random.RandomState(seed)
    src = [rng.randint(0, DICT, (n, 1)).astype("int64") for n in src_lens]
    trg = [rng.randint(0, DICT, (n + 1, 1)).astype("int64")
           for n in trg_lens]
    return {"src_word_id": lod.from_sequences(src),
            "target_language_word": lod.from_sequences([s[:-1]
                                                        for s in trg]),
            "target_language_next_word": lod.from_sequences([s[1:]
                                                             for s in trg])}


def _jax_state(main, startup):
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
    state = {v.name: np.array(scope.get(v.name))
             for v in main.list_vars() if v.persistable}
    return exe, scope, state


def _grad_names(main):
    return sorted(p.name + "@GRAD" for p in main.all_parameters())


@pytest.mark.parametrize("use_attention", [False, True])
def test_loss_and_every_gradient_match_the_jax_package(use_attention):
    """One run's loss and the gradient of every parameter, against the
    JAX package on its masked-softmax kernel and on its where-mask path
    (the path without attention has no sequence_softmax: one JAX run)."""
    jmain, jstartup, javg, _ = _build("jax", use_attention)
    tmain, _, tavg, _ = _build("port", use_attention)
    exe, scope, state = _jax_state(jmain, jstartup)
    grads = _grad_names(tmain)
    assert len(grads) == (11 if use_attention else 10)
    fetch = [tavg.name] + grads
    got = tfluid.Executor("cpu").run(
        tmain, feed=_feed("port", 1), fetch_list=fetch,
        scope=tio.scope_from_numpy(state, "cpu", program=tmain))
    for pallas in (FUSED, UNFUSED) if use_attention else (UNFUSED,):
        with jfluid.scope_guard(scope), pytest.MonkeyPatch.context() as mp:
            mp.setenv("PADDLE_TPU_PALLAS", pallas)
            for name, arr in state.items():
                scope.set(name, arr)
            want = exe.run(jmain, feed=_feed("jax", 1), fetch_list=fetch)
        for name, g, w in zip(fetch, got, want):
            w = np.asarray(w)
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g, w, err_msg="%s %s" % (pallas, name),
                                       **TOL)
            if name != tavg.name:
                assert np.abs(g).sum() > 0, name


def test_attention_masks_by_source_and_the_decoder_by_target_lengths():
    """`scores` in the step block carries the source lengths (its matmul's
    first sequence input is the encoder output), the decoder's output the
    target lengths; the sequence_softmax rule goes through the K8 wrapper
    once per decoder step, and rows past their target length predict 0."""
    main, startup, avg, pred = _build("port")
    step = main.blocks[1]
    sm, = [op for op in step.ops if op.type == "sequence_softmax"]
    assert sm.inputs["XLen"] == ["src_word_id@SEQLEN"]
    assert step.var(sm.inputs["X"][0]).seq_len_var == "src_word_id@SEQLEN"
    assert pred.seq_len_var == "target_language_word@SEQLEN"
    scan, = [op for op in main.global_block().ops if op.type == "rnn_scan"]
    assert scan.inputs["SeqLen"] == ["target_language_word@SEQLEN"]
    assert "src_word_id@SEQLEN" in scan.inputs["Static"]
    assert {"dec_state_w_0", "dec_state_w_1", "dec_state_w_2", "dec_state_b",
            "dec_score_w", "dec_score_b"} <= set(scan.inputs["Static"])
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    exe.run(startup, scope=scope)
    calls = []
    real = ck.masked_softmax
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ck, "masked_softmax",
                   lambda x, lens: calls.append(x.shape) or real(x, lens))
        probs, = exe.run(main, feed=_feed("port", 2), fetch_list=[pred],
                         scope=scope)
    t_pad = probs.shape[1]
    assert t_pad == 16 and len(calls) == t_pad        # 11 steps, padded to 16
    assert set(calls) == {(BATCH, 16)}
    _, trg_lens = _lengths(1002)
    for i, n in enumerate(trg_lens):
        np.testing.assert_allclose(probs[i, :n].sum(-1), 1.0, rtol=1e-5)
        assert np.all(probs[i, n:] == 0)


@pytest.fixture(scope="module", params=["adam", "adagrad"])
def train_runs(request):
    """20 steps of the attention translator in both packages from the JAX
    startup state (the JAX package on its masked-softmax kernel), a new
    batch every step."""
    optimizer = request.param
    jmain, jstartup, javg, _ = _build("jax", optimizer=optimizer)
    tmain, _, tavg, _ = _build("port", optimizer=optimizer)
    jexe, jscope, state = _jax_state(jmain, jstartup)
    tscope = tio.scope_from_numpy(state, "cpu", program=tmain)
    texe = tfluid.Executor("cpu")
    jl, tl = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_PALLAS", FUSED)
        for step in range(STEPS):
            with jfluid.scope_guard(jscope):
                jres = jexe.run(jmain, feed=_feed("jax", 100 + step),
                                fetch_list=[javg.name])
            tres = texe.run(tmain, feed=_feed("port", 100 + step),
                            fetch_list=[tavg.name], scope=tscope)
            jl.append(float(np.asarray(jres[0]).reshape(-1)[0]))
            tl.append(float(tres[0].reshape(-1)[0]))
    return dict(optimizer=optimizer, tscope=tscope, jscope=jscope,
                state=state, jl=jl, tl=tl)


def test_training_losses_agree_and_fall(train_runs):
    np.testing.assert_allclose(train_runs["tl"], train_runs["jl"], rtol=1e-5)
    assert all(np.isfinite(train_runs["tl"]))
    assert np.mean(train_runs["tl"][-5:]) < np.mean(train_runs["tl"][:5])


def test_training_state_after_twenty_steps_agrees(train_runs):
    """Parameters and the optimizer's accumulators (Adagrad: one moment
    per parameter)."""
    moments = [n for n in train_runs["state"] if n.startswith(
        "moment_" if train_runs["optimizer"] == "adagrad" else "moment1_")]
    assert len(moments) == 11
    far = total = 0
    for name in train_runs["state"]:
        t = train_runs["tscope"].get(name).numpy()
        j = np.asarray(train_runs["jscope"].get(name))
        np.testing.assert_allclose(t, j, atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)
        far += int((np.abs(t - j) > PARAM_CLOSE).sum())
        total += t.size
    assert total > 5000 and far <= PARAM_FAR_SHARE * total, (far, total)


@pytest.mark.parametrize("optimizer", ["adam", "adagrad"])
@pytest.mark.parametrize("use_attention", [False, True])
def test_training_program_serializes_like_the_jax_one(use_attention,
                                                      optimizer):
    """Main (global and step block) and startup programs: the same ops,
    uids, slots and attrs, and the same serialized bytes but for the JAX
    package's int64 -> int32 narrowing of the dtypes it infers."""
    jmain, jstartup, _, _ = _build("jax", use_attention, optimizer)
    tmain, tstartup, _, _ = _build("port", use_attention, optimizer)
    for j, t in ((jmain, tmain), (jstartup, tstartup)):
        assert len(t.blocks) == len(j.blocks)
        for jb, tb in zip(j.blocks, t.blocks):
            assert [(op.uid, op.type, op.inputs, op.outputs)
                    for op in tb.ops] == \
                [(op.uid, op.type, op.inputs, op.outputs) for op in jb.ops]
        jd = json.loads(jdesc.program_to_bytes(j))
        td = json.loads(tdesc.program_to_bytes(t))
        for jb, tb in zip(jd["blocks"], td["blocks"]):
            for jv, tv in zip(jb["vars"], tb["vars"]):
                if (jv["dtype"], tv["dtype"]) == ("int32", "int64"):
                    jv["dtype"] = "int64"
        assert td == jd
    types = {op.type for op in tmain.global_block().ops}
    assert {"rnn_scan", "lstm", "sequence_mask", "grad_of",
            optimizer} <= types
    step_types = {op.type for op in tmain.blocks[1].ops}
    assert ("sequence_softmax" in step_types) == use_attention
