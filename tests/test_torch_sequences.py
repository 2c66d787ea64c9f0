"""The port's sequence (LoD) slice against the JAX package on the CPU.

Both packages build the same programs from the same layer calls; the JAX
package runs its startup program and every persistable it holds is carried
into the port with io.scope_from_numpy. The same feeds, made with numpy
from a seed (batch 4, lengths 1-11, so a length-1 row and padding in every
batch), then go through both. The JAX package runs its Pallas sequence
kernels in interpret mode (PADDLE_TPU_PALLAS=lstm,seq) and, where the port
has a second path to hold, its unfused lax.scan / where-mask path
(PADDLE_TPU_PALLAS=0); the port runs its kernel wrappers' plain versions.

Sizes: dictionary 50, embedding 8, hid_dim 16 (LSTM hidden 4), 3 stacked
layers. Tolerances: rtol = atol = 1e-5 on forward values and on step 1's
gradients — fp32 on both sides, summed in another order, over at most 16
steps. The 20 Adam steps follow tests/test_torch_training.py: every loss
within rtol 1e-5, and the parameters and moments after 20 steps within
2 * (the sum of the steps' learning rates) elementwise, with at most 0.1%
of the elements more than 1e-4 apart (Adam moves a parameter by about lr
whatever the size of its gradient, so a near-zero gradient of the other
sign in the other package can move it the other way on any step).
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc
from paddle_tpu.core.lod import LoDTensor as JLoDTensor
from paddle_tpu.core.lod import create_lod_tensor as jcreate
from paddle_tpu.models import understand_sentiment as jsent

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.core.lod import LoDTensor as TLoDTensor
from paddle_tpu_torch.core.lod import create_lod_tensor as tcreate
from paddle_tpu_torch.models import understand_sentiment as tsent
from paddle_tpu_torch.ops import cuda_kernels as ck

DICT, EMB, HID, CLASSES, BATCH, STEPS, LR = 50, 8, 16, 2, 4, 20, 0.002
TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_ATOL = 2 * STEPS * LR
PARAM_CLOSE, PARAM_FAR_SHARE = 1e-4, 1e-3
FUSED, UNFUSED = "lstm,seq", "0"
_PKG = {"jax": (jfluid, JLoDTensor), "port": (tfluid, TLoDTensor)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: one intra-op thread does, and leaves the other
    test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lengths(seed):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, 12, size=BATCH)
    lens[0], lens[-1] = 11, 1
    return lens


def _word_seqs(seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, DICT, (n, 1)).astype("int64")
            for n in _lengths(seed + 1000)]


def _float_seqs(seed, width):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n, width) * 0.5).astype("float32")
            for n in _lengths(seed + 1000)]


def _feed(pkg, seqs, dense=None):
    lod_cls = _PKG[pkg][1]
    feed = {n: lod_cls.from_sequences(s) for n, s in seqs.items()}
    feed.update(dense or {})
    return feed


def _build(fluid, build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fetch = build(fluid)
    return main, startup, fetch


def _jax_state(main, startup):
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
    state = {v.name: np.array(scope.get(v.name))
             for v in main.list_vars() if v.persistable}
    return exe, scope, state


def _jax_fetch(build, seqs, dense, pallas, state=None):
    """One run of a fresh JAX build under PADDLE_TPU_PALLAS=pallas:
    (startup state, fetches)."""
    main, startup, fetch = _build(jfluid, build)
    exe, scope, start = _jax_state(main, startup)
    if state is not None:
        for name, arr in state.items():
            scope.set(name, arr)
    with jfluid.scope_guard(scope), pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_PALLAS", pallas)
        out = exe.run(main, feed=_feed("jax", seqs, dense),
                      fetch_list=fetch)
    return start, [np.asarray(o) for o in out]


def _port_fetch(build, seqs, dense, state):
    main, _, fetch = _build(tfluid, build)
    scope = tio.scope_from_numpy(state, "cpu", program=main)
    return tfluid.Executor("cpu").run(
        main, feed=_feed("port", seqs, dense),
        fetch_list=[v.name for v in fetch], scope=scope)


def _compare(build, seqs, dense=None, paths=(FUSED, UNFUSED)):
    """The port's fetches against the JAX package's under each kernel
    setting in `paths`, from the same startup state."""
    state, want = _jax_fetch(build, seqs, dense, paths[0])
    got = _port_fetch(build, seqs, dense, state)
    for pallas in paths:
        if pallas != paths[0]:
            _, want = _jax_fetch(build, seqs, dense, pallas, state)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape, (pallas, i)
            np.testing.assert_allclose(g, w, err_msg="%s fetch %d"
                                       % (pallas, i), **TOL)
    return got


# ---------------------------------------------------------------- LoD --

def test_to_padded_matches_the_jax_package():
    seqs = _float_seqs(1, 3)
    for bucket, max_len in ((8, None), (4, None), (8, 16), (1, 11)):
        got = TLoDTensor.from_sequences(seqs).to_padded(max_len, bucket)
        want = JLoDTensor.from_sequences(seqs).to_padded(max_len, bucket)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    lens = [3, 0, 2]
    data = np.arange(5 * 2, dtype=np.float32).reshape(5, 2)
    t, j = tcreate(data, [lens]), jcreate(data, [lens])
    assert t.lod == j.lod and t.lod_level() == 1
    np.testing.assert_array_equal(t.seq_lengths(), j.seq_lengths())
    for g, w in zip(t.to_padded(), j.to_padded()):
        np.testing.assert_array_equal(g, w)
    for lod_cls in (TLoDTensor, JLoDTensor):
        with pytest.raises(ValueError, match="malformed LoD"):
            lod_cls(data, [[0, 3, 7]]).to_padded()
        with pytest.raises(ValueError, match="malformed LoD"):
            lod_cls(data, [[0, 5]]).to_padded(max_len=4)


def test_executor_expands_lod_feeds_like_the_jax_package():
    """A LoDTensor feed and its padded data plus @SEQLEN give the same
    answer; a sequence fed as a plain array without its lengths raises the
    JAX package's TypeError."""
    def build(fluid):
        x = fluid.layers.data("x", shape=[3], dtype="float32", lod_level=1)
        return [fluid.layers.sequence_pool(x, "sum")]

    seqs = _float_seqs(2, 3)
    got = _compare(build, {"x": seqs})
    main, startup, fetch = _build(tfluid, build)
    exe = tfluid.Executor("cpu")
    padded, lens = TLoDTensor.from_sequences(seqs).to_padded()
    again, = exe.run(main, feed={"x": padded, "x@SEQLEN": lens},
                     fetch_list=fetch)
    np.testing.assert_array_equal(again, got[0])
    for fluid, exe in ((tfluid, exe),
                       (jfluid, jfluid.Executor(jfluid.CPUPlace()))):
        main, _, fetch = _build(fluid, build)
        with pytest.raises(TypeError, match="x@SEQLEN"):
            exe.run(main, feed={"x": padded}, fetch_list=fetch)


# ---------------------------------------------------------- op rules --

@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("peepholes", [False, True])
def test_lstm_rule_matches_the_jax_package(peepholes, reverse):
    """dynamic_lstm's hidden and cell. No peepholes: the JAX fused kernel
    and its lax.scan path; peepholes: the lax.scan path, which is the only
    one either package has (the port runs its torch loop)."""
    def build(fluid):
        x = fluid.layers.data("x", shape=[16], dtype="float32", lod_level=1)
        hidden, cell = fluid.layers.dynamic_lstm(
            input=x, size=16, use_peepholes=peepholes, is_reverse=reverse)
        return [hidden, cell]

    _compare(build, {"x": _float_seqs(3, 16)},
             paths=(UNFUSED,) if peepholes else (FUSED, UNFUSED))


def test_lstm_rule_takes_the_kernel_only_without_peepholes(monkeypatch):
    """The no-peephole fp32 LSTM with default activations goes through the
    K6 wrapper (its plain version, on the CPU); peepholes or another gate
    activation run the torch loop and never reach it."""
    calls = []
    real = ck.fused_lstm

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(ck, "fused_lstm", spy)
    seqs = {"x": _float_seqs(4, 16)}
    for kw, expect in ((dict(use_peepholes=False), 1),
                       (dict(use_peepholes=True), 0),
                       (dict(use_peepholes=False, gate_activation="relu"),
                        0)):
        del calls[:]

        def build(fluid):
            x = fluid.layers.data("x", shape=[16], dtype="float32",
                                  lod_level=1)
            return [fluid.layers.dynamic_lstm(input=x, size=16, **kw)[0]]

        main, startup, fetch = _build(tfluid, build)
        exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
        exe.run(startup, scope=scope)
        del calls[:]         # build-time shape inference ran on meta
        exe.run(main, feed=_feed("port", seqs), fetch_list=fetch,
                scope=scope)
        assert len(calls) == expect, kw


@pytest.mark.parametrize("ptype", ["sum", "average", "sqrt", "max", "last",
                                   "first"])
def test_sequence_pool_matches_the_jax_package(ptype):
    """All six pool types on a [B, T, 2, 3] input (the feature dims
    flatten for the kernel): SUM / AVERAGE / SQRT against the JAX masked
    pool kernel and its dense path, MAX / LAST / FIRST against the dense
    path; plus the first/last-step layers."""
    def build(fluid):
        x = fluid.layers.data("x", shape=[2, 3], dtype="float32",
                              lod_level=1)
        outs = [fluid.layers.sequence_pool(x, ptype)]
        if ptype == "first":
            outs.append(fluid.layers.sequence_first_step(x))
        if ptype == "last":
            outs.append(fluid.layers.sequence_last_step(x))
        return outs

    rng = np.random.RandomState(5)
    seqs = [rng.randn(n, 2, 3).astype("float32") for n in _lengths(5)]
    got = _compare(build, {"x": seqs})
    assert got[0].shape == (BATCH, 2, 3)


@pytest.mark.parametrize("filter_size", [3, 4])
def test_sequence_conv_matches_the_jax_package(filter_size):
    def build(fluid):
        x = fluid.layers.data("x", shape=[5], dtype="float32", lod_level=1)
        return [fluid.layers.sequence_conv(x, num_filters=6,
                                           filter_size=filter_size,
                                           act="tanh")]

    got = _compare(build, {"x": _float_seqs(6, 5)})
    # every padding step of the conv output is exactly zero before tanh
    lens = _lengths(1006)
    for i, n in enumerate(lens):
        assert np.all(got[0][i, n:] == 0.0)


def test_build_time_shapes_of_sequence_vars():
    """Shape inference puts the same sentinel into B and T: the inferred
    shapes of fc on [B, T, D], sequence_conv and sequence_pool still keep
    both dims dynamic and the feature dims static, as in the JAX
    package."""
    def build(fluid):
        words = fluid.layers.data("words", shape=[1], dtype="int64",
                                  lod_level=1)
        emb = fluid.layers.embedding(input=words, size=[DICT, EMB])
        proj = fluid.layers.fc(input=emb, size=12)
        conv = fluid.layers.sequence_conv(emb, num_filters=6, filter_size=3)
        pool = fluid.layers.sequence_pool(conv, "sqrt")
        return [emb, proj, conv, pool]

    for fluid in (jfluid, tfluid):
        _, _, (emb, proj, conv, pool) = _build(fluid, build)
        assert tuple(emb.shape) == (-1, -1, EMB)
        assert tuple(proj.shape) == (-1, -1, 12)
        assert tuple(conv.shape) == (-1, -1, 6)
        assert tuple(pool.shape) == (-1, 6)
        assert proj.lod_level == conv.lod_level == 1
        assert pool.lod_level == 0 and pool.seq_len_var is None


# ----------------------------------------------- the sentiment models --

def no_peephole_stacked_lstm_net(fluid, data, dict_dim, class_dim=2,
                                 emb_dim=128, hid_dim=512, stacked_num=3):
    """models/understand_sentiment.stacked_lstm_net's layer calls with
    use_peepholes=False on each dynamic_lstm: the configuration whose
    LSTMs run the fused kernel."""
    emb = fluid.layers.embedding(input=data, size=[dict_dim, emb_dim])
    fc1 = fluid.layers.fc(input=emb, size=hid_dim)
    lstm1, _ = fluid.layers.dynamic_lstm(input=fc1, size=hid_dim,
                                         use_peepholes=False)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = fluid.layers.fc(input=inputs, size=hid_dim)
        lstm, _ = fluid.layers.dynamic_lstm(
            input=fc, size=hid_dim, is_reverse=(i % 2) == 0,
            use_peepholes=False)
        inputs = [fc, lstm]
    fc_last = fluid.layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = fluid.layers.sequence_pool(input=inputs[1], pool_type="max")
    return fluid.layers.fc(input=[fc_last, lstm_last], size=class_dim,
                           act="softmax")


def _net(kind, fluid, words):
    if kind == "conv":
        sent = jsent if fluid is jfluid else tsent
        return sent.convolution_net(words, DICT, CLASSES, EMB, HID)
    if kind == "lstm":
        sent = jsent if fluid is jfluid else tsent
        return sent.stacked_lstm_net(words, DICT, CLASSES, EMB, HID)
    return no_peephole_stacked_lstm_net(fluid, words, DICT, CLASSES, EMB,
                                        HID)


@pytest.mark.parametrize("kind", ["conv", "lstm", "lstm_no_peepholes"])
def test_sentiment_programs_forward_match_the_jax_package(kind):
    """Both sentiment bodies end to end, forward: the conv net (two SQRT
    pools: K9), the book's stacked LSTM (peepholes: the loop) and the
    no-peephole stacked LSTM (three K6 recurrences)."""
    def build(fluid):
        words = fluid.layers.data("words", shape=[1], dtype="int64",
                                  lod_level=1)
        return [_net(kind, fluid, words)]

    got = _compare(build, {"words": _word_seqs(7)})
    assert got[0].shape == (BATCH, CLASSES)
    np.testing.assert_allclose(got[0].sum(axis=1), 1.0, rtol=1e-6)


def _train_build(fluid):
    words = fluid.layers.data("words", shape=[1], dtype="int64",
                              lod_level=1)
    label = fluid.layers.data("label", shape=[1], dtype="int64")
    pred = no_peephole_stacked_lstm_net(fluid, words, DICT, CLASSES, EMB,
                                        HID)
    cost = fluid.layers.mean(x=fluid.layers.cross_entropy(input=pred,
                                                           label=label))
    acc = fluid.layers.accuracy(input=pred, label=label)
    fluid.optimizer.Adam(learning_rate=LR).minimize(cost)
    return [cost, acc]


def _train_feed(pkg, step):
    labels = np.random.RandomState(200 + step).randint(
        0, CLASSES, (BATCH, 1)).astype("int64")
    return _feed(pkg, {"words": _word_seqs(100 + step)}, {"label": labels})


@pytest.fixture(scope="module")
def train_runs():
    """20 Adam steps of the no-peephole stacked LSTM in both packages from
    the JAX startup state (the JAX package on its fused kernels)."""
    jmain, jstartup, jfetch = _build(jfluid, _train_build)
    tmain, _, tfetch = _build(tfluid, _train_build)
    jexe, jscope, state = _jax_state(jmain, jstartup)
    tscope = tio.scope_from_numpy(state, "cpu", program=tmain)
    texe = tfluid.Executor("cpu")
    grads = sorted(p.name + "@GRAD" for p in tmain.all_parameters())
    jl, tl, jg, tg = [], [], None, None
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_PALLAS", FUSED)
        for step in range(STEPS):
            extra = grads if step == 0 else []
            with jfluid.scope_guard(jscope):
                jres = jexe.run(jmain, feed=_train_feed("jax", step),
                                fetch_list=[jfetch[0].name] + extra)
            tres = texe.run(tmain, feed=_train_feed("port", step),
                            fetch_list=[tfetch[0].name] + extra,
                            scope=tscope)
            jl.append(float(np.asarray(jres[0]).reshape(-1)[0]))
            tl.append(float(tres[0].reshape(-1)[0]))
            if step == 0:
                jg, tg = [np.asarray(a) for a in jres[1:]], tres[1:]
    return dict(tmain=tmain, tscope=tscope, jscope=jscope, state=state,
                jl=jl, tl=tl, jg=jg, tg=tg, grads=grads)


def test_training_step_one_gradients_agree(train_runs):
    # embedding, 5 fc weights + 3 fc biases + the last fc's 2 weights and
    # bias, 3 LSTM weights and biases
    assert len(train_runs["grads"]) == len(train_runs["tg"]) >= 15
    for name, j, t in zip(train_runs["grads"], train_runs["jg"],
                          train_runs["tg"]):
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, err_msg=name, **TOL)


def test_training_losses_agree_and_fall(train_runs):
    np.testing.assert_allclose(train_runs["tl"], train_runs["jl"],
                               rtol=1e-5)
    assert all(np.isfinite(train_runs["tl"]))
    assert np.mean(train_runs["tl"][-5:]) < np.mean(train_runs["tl"][:5])


def test_training_state_after_twenty_steps_agrees(train_runs):
    far = total = 0
    for name in train_runs["state"]:
        t = train_runs["tscope"].get(name).numpy()
        j = np.asarray(train_runs["jscope"].get(name))
        np.testing.assert_allclose(t, j, atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)
        far += int((np.abs(t - j) > PARAM_CLOSE).sum())
        total += t.size
    assert total > 2000 and far <= PARAM_FAR_SHARE * total, (far, total)


def test_sentiment_training_program_matches_the_jax_one():
    """The same ops, slots, attrs and uids, and the same serialized
    program but for the JAX package's int64 -> int32 narrowing of inferred
    dtypes (x64 is off there)."""
    jmain, jstartup, _ = _build(jfluid, _train_build)
    tmain, tstartup, _ = _build(tfluid, _train_build)
    for j, t in ((jmain, tmain), (jstartup, tstartup)):
        jops, tops = j.global_block().ops, t.global_block().ops
        assert [op.type for op in tops] == [op.type for op in jops]
        for jo, to in zip(jops, tops):
            assert (to.uid, to.inputs, to.outputs) == \
                (jo.uid, jo.inputs, jo.outputs), to.type
        jd = json.loads(jdesc.program_to_bytes(j))
        td = json.loads(tdesc.program_to_bytes(t))
        for jb, tb in zip(jd["blocks"], td["blocks"]):
            for jv, tv in zip(jb["vars"], tb["vars"]):
                if (jv["dtype"], tv["dtype"]) == ("int32", "int64"):
                    jv["dtype"] = "int64"
        assert td == jd
    types = {op.type for op in tmain.global_block().ops}
    assert {"lstm", "sequence_pool", "sum", "cross_entropy", "mean", "topk",
            "accuracy", "grad_of", "adam"} <= types


def test_port_saved_sentiment_model_serves_in_the_jax_package(tmp_path):
    """save_inference_model keeps the words@SEQLEN companion and the
    seq_len_var link; the JAX package loads the port's conv net and
    answers like it (the JAX-saved direction is in
    tests/test_torch_serving.py)."""
    def build(fluid):
        words = fluid.layers.data("words", shape=[1], dtype="int64",
                                  lod_level=1)
        return [_net("conv", fluid, words)]

    main, startup, (pred,) = _build(tfluid, build)
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    exe.run(startup, scope=scope)
    program = tio.save_inference_model(str(tmp_path), ["words"], [pred], exe,
                                       main, scope=scope)
    words = program.global_block().var("words")
    assert words.seq_len_var == "words@SEQLEN"
    assert program.global_block().has_var("words@SEQLEN")
    seqs = _word_seqs(9)
    got, = exe.run(program, feed=_feed("port", {"words": seqs}),
                   fetch_list=[pred.name], scope=scope)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()), \
            pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_PALLAS", FUSED)
        jprog, feeds, fetch = jfluid.io.load_inference_model(str(tmp_path),
                                                             jexe)
        assert feeds == ["words"]
        assert jprog.global_block().var("words").seq_len_var == \
            "words@SEQLEN"
        want, = jexe.run(jprog, feed=_feed("jax", {"words": seqs}),
                         fetch_list=fetch)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
