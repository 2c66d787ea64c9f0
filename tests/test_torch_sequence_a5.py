"""The rest of the sequence ops (ROADMAP A5) against the JAX package, on
the CPU.

Each rule runs through both registries on the same inputs, made with numpy
from a seed, with the cases of the JAX package's
tests/unittests/test_sequence_ops.py, test_sequence_deep.py and
test_tail_ops.py: sequence_reshape, sequence_expand, lod_reset, row_conv,
gru, gru_unit, lstm_unit, sequence_cache_write, sequence_slice and
sequence_concat. Where a rule is differentiable its gradients go through
the port's grad_of against jax.vjp of the JAX rule (test_torch_ops'
_grads_both). The layers build the JAX package's program bytes and, from
the JAX startup state (io.scope_from_numpy), give its fetches on LoD
feeds.

Tolerances: exact where a rule only moves, selects or counts values
(reshape, expand, lod_reset, slice, concat, cache write, the lengths);
rtol = atol = 1e-5 where both sides do fp32 arithmetic in another order
(row_conv, the GRUs, lstm_unit: at most a few dozen products a value, over
at most 7 steps), forward and gradients alike.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc
from paddle_tpu.core.lod import LoDTensor as JLoDTensor

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.core.lod import LoDTensor as TLoDTensor

from test_torch_ops import _grads_both, _run_both

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: one intra-op thread does, and leaves the other
    test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _same(op_type, ins, attrs, exact, slots=None):
    jout, tout = _run_both(op_type, ins, attrs)
    for slot in slots or tout:
        assert len(jout[slot]) == len(tout[slot]), slot
        for j, t in zip(jout[slot], tout[slot]):
            assert j.shape == t.shape, (op_type, slot, j.shape, t.shape)
            if exact or j.dtype.kind != "f":
                np.testing.assert_array_equal(t, j, err_msg=slot)
            else:
                np.testing.assert_allclose(t, j, err_msg=slot, **TOL)
    return tout


def _same_grads(op_type, ins, attrs, out_slots, seed=0):
    got, want = _grads_both(op_type, ins, attrs, out_slots, seed=seed)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=str(k), **TOL)


# ------------------------------------------------------------- reshape --

_RESHAPE_CASES = {
    # name: (D, new_dim, lengths, T)
    "narrow": (4, 2, [3, 1, 2], 3),      # dim 4 -> 2 doubles lengths
    "widen": (2, 4, [4, 2], 4),          # dim 2 -> 4 halves them
    "pad_t": (2, 4, [2, 2, 0], 3),       # T*D not divisible: T padded
    "to_6": (4, 6, [3, 0, 6], 6),        # gcd 2
}


@pytest.mark.parametrize("case", sorted(_RESHAPE_CASES))
def test_sequence_reshape_rule(case):
    d, nd, lens, t = _RESHAPE_CASES[case]
    ins = {"X": [_rand(len(lens), t, d, seed=1)],
           "XLen": [np.array(lens, np.int32)]}
    _same("sequence_reshape", ins, {"new_dim": nd}, exact=True)
    _same_grads("sequence_reshape", ins, {"new_dim": nd}, ["Out"])


def test_sequence_reshape_flags_an_indivisible_sequence():
    """3 * 4 = 12 is not a multiple of 8: both rules raise the flag, under
    the same message."""
    from paddle_tpu.core.lowering import LowerCtx as JaxCtx
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.lowering import LowerCtx as TorchCtx
    import jax
    import jax.numpy as jnp
    x, lens = _rand(2, 3, 4), np.array([3, 2], np.int32)
    jctx = JaxCtx(None, base_key=jax.random.key(0))
    jreg.get("sequence_reshape").lower(
        jctx, {"X": [jnp.asarray(x)], "XLen": [jnp.asarray(lens)]},
        {"new_dim": 8})
    tctx = TorchCtx(None, torch.device("cpu"))
    treg.get("sequence_reshape").lower(
        tctx, {"X": [torch.from_numpy(x)], "XLen": [torch.from_numpy(lens)]},
        {"new_dim": 8})
    assert list(tctx.op_errors) == list(jctx.op_errors)
    assert [bool(f) for f in tctx.op_errors.values()] == \
        [bool(f) for f in jctx.op_errors.values()] == [True]


# -------------------------------------------------------------- expand --

@pytest.mark.parametrize("x_shape", [(2, 3), (2, 1, 3), (2, 4, 3)])
def test_sequence_expand_rule(x_shape):
    ins = {"X": [_rand(*x_shape, seed=2)], "Y": [_rand(2, 4, 5, seed=3)],
           "YLen": [np.array([2, 4], np.int32)]}
    _same("sequence_expand", ins, {}, exact=True)
    _same_grads("sequence_expand", ins, {}, ["Out"])


# ----------------------------------------------------------- lod_reset --

def _lod_reset_cases():
    x = _rand(3, 4, 2, seed=4)
    xlen = np.array([3, 1, 4], np.int32)
    return {
        "target_lens": ({"X": [x], "XLen": [xlen]},
                        {"target_lens": [2, 5, 1]}),
        "ylen": ({"X": [x], "XLen": [xlen], "Y": [_rand(2, 6, 1)],
                  "YLen": [np.array([6, 2], np.int32)]}, {}),
        "ydata": ({"X": [x], "XLen": [xlen],
                   "YData": [np.array([0, 4, 8], np.int32)]}, {}),
        "dense_x": ({"X": [_rand(6, 3, seed=5)]},
                    {"target_lens": [4, 2]}),
        "no_target": ({"X": [x], "XLen": [xlen]}, {}),
    }


@pytest.mark.parametrize("case", sorted(_lod_reset_cases()))
def test_lod_reset_rule(case):
    ins, attrs = _lod_reset_cases()[case]
    _same("lod_reset", ins, attrs, exact=True)
    _same_grads("lod_reset", ins, attrs, ["Out"])


# ------------------------------------------------------------ row_conv --

def test_row_conv_rule():
    ins = {"X": [_rand(3, 5, 3, seed=6)],
           "Filter": [_rand(3, 3, seed=7) * 0.4],
           "XLen": [np.array([5, 2, 4], np.int32)]}
    _same("row_conv", ins, {}, exact=False)
    _same_grads("row_conv", ins, {}, ["Out"])


# ----------------------------------------------------------------- gru --

def _gru_ins(h0):
    ins = {"Input": [_rand(3, 7, 12, seed=8) * 0.5],
           "Weight": [_rand(4, 12, seed=9) * 0.5],
           "Bias": [_rand(1, 12, seed=10) * 0.1],
           "XLen": [np.array([7, 1, 4], np.int32)]}
    if h0:
        ins["H0"] = [_rand(3, 4, seed=11) * 0.5]
    return ins


@pytest.mark.parametrize("acts", [("sigmoid", "tanh"), ("sigmoid", "relu")])
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_rule(reverse, h0, acts):
    attrs = {"is_reverse": reverse, "gate_activation": acts[0],
             "activation": acts[1]}
    ins = _gru_ins(h0)
    _same("gru", ins, attrs, exact=False)
    _same_grads("gru", ins, attrs, ["Hidden"])


@pytest.mark.parametrize("acts", [(1, 2), ("sigmoid", "tanh"), (3, 0)])
def test_gru_unit_rule(acts):
    ins = {"Input": [_rand(3, 12, seed=12)],
           "HiddenPrev": [_rand(3, 4, seed=13)],
           "Weight": [_rand(4, 12, seed=14) * 0.5],
           "Bias": [_rand(1, 12, seed=15) * 0.1]}
    attrs = {"gate_activation": acts[0], "activation": acts[1]}
    _same("gru_unit", ins, attrs, exact=False)
    _same_grads("gru_unit", ins, attrs, ["Hidden", "Gate",
                                         "ResetHiddenPrev"])


@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
def test_lstm_unit_rule(forget_bias):
    ins = {"X": [_rand(3, 16, seed=16)], "C_prev": [_rand(3, 4, seed=17)]}
    attrs = {"forget_bias": forget_bias}
    _same("lstm_unit", ins, attrs, exact=False)
    _same_grads("lstm_unit", ins, attrs, ["C", "H"])


# -------------------------------------------------- sequence_cache_write --

def test_sequence_cache_write_rule():
    """Row b's step Pos[b] takes X[b]; a negative Pos counts from the end,
    and a Pos outside [-T, T) writes nothing (the JAX scatter drops it)."""
    ins = {"Cache": [_rand(5, 5, 4, seed=18)], "X": [_rand(5, 4, seed=19)],
           "Pos": [np.array([[0], [4], [2], [-1], [5]], np.int64)]}
    out = _same("sequence_cache_write", ins, {}, exact=True)["Out"][0]
    np.testing.assert_array_equal(out[4], ins["Cache"][0][4])
    np.testing.assert_array_equal(out[3, 4], ins["X"][0][3])
    ins["Pos"] = [np.array([[0], [4], [2], [1], [3]], np.int64)]
    _same_grads("sequence_cache_write", ins, {}, ["Out"])


# ----------------------------------------------------- slice and concat --

def test_sequence_slice_rule():
    ins = {"X": [_rand(3, 6, 2, seed=20)],
           "Offset": [np.array([[0], [1], [2]], np.int64)],
           "Length": [np.array([[2], [1], [3]], np.int64)],
           "XLen": [np.array([6, 4, 5], np.int32)]}
    _same("sequence_slice", ins, {}, exact=True)
    _same_grads("sequence_slice", ins, {}, ["Out"])


@pytest.mark.parametrize("axis", [0, 2])
def test_sequence_concat_rule(axis):
    ins = {"X": [_rand(2, 4, 3, seed=21), _rand(2, 5 if axis == 0 else 4,
                                                3, seed=22)],
           "XLen": [np.array([3, 4], np.int32), np.array([5, 2], np.int32)]}
    _same("sequence_concat", ins, {"axis": axis}, exact=True)
    _same_grads("sequence_concat", ins, {"axis": axis}, ["Out"])


# --------------------------------------------------------------- layers --

def _build(fluid, build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fetch = build(fluid)
    return main, startup, fetch


def _same_bytes(jprog, tprog):
    """program_to_bytes equal but for the JAX package's int64 -> int32
    narrowing of inferred dtypes."""
    jd = json.loads(jdesc.program_to_bytes(jprog))
    td = json.loads(tdesc.program_to_bytes(tprog))
    for jb, tb in zip(jd["blocks"], td["blocks"]):
        for jv, tv in zip(jb["vars"], tb["vars"]):
            if (jv["dtype"], tv["dtype"]) == ("int32", "int64"):
                jv["dtype"] = "int64"
    assert td == jd


def _run_layers(build, feeds, exact=False):
    """The layers' programs in both packages: the same bytes, then the
    port from the JAX startup state on the same feeds ({name: list of
    per-sequence arrays} or dense arrays)."""
    jmain, jstartup, jfetch = _build(jfluid, build)
    tmain, tstartup, tfetch = _build(tfluid, build)
    _same_bytes(jmain, tmain)
    _same_bytes(jstartup, tstartup)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        state = {v.name: np.array(jscope.get(v.name))
                 for v in jmain.list_vars() if v.persistable}

        def feed(lod_cls):
            return {n: lod_cls.from_sequences(v) if isinstance(v, list)
                    else v for n, v in feeds.items()}
        want = jexe.run(jmain, feed=feed(JLoDTensor), fetch_list=jfetch)
    got = tfluid.Executor("cpu").run(
        tmain, feed=feed(TLoDTensor), fetch_list=tfetch,
        scope=tio.scope_from_numpy(state, "cpu", program=tmain))
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if exact or w.dtype.kind != "f":
            np.testing.assert_array_equal(g, w, err_msg="fetch %d" % i)
        else:
            np.testing.assert_allclose(g, w, err_msg="fetch %d" % i, **TOL)
    return got


def _seqs(seed, width, lens):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, width).astype("float32") for n in lens]


def test_sequence_reshape_layer_feeds_downstream_lengths():
    """dim 4 -> 2: the downstream pools see the doubled lengths."""
    def build(fluid):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32",
                              lod_level=1)
        r = fluid.layers.sequence_reshape(x, 2)
        return [r, fluid.layers.sequence_pool(input=r, pool_type="last"),
                fluid.layers.sequence_pool(input=r, pool_type="sum"),
                r.seq_len_var]
    got = _run_layers(build, {"x": _seqs(1, 4, [3, 1, 2])})
    assert got[3].tolist() == [6, 2, 4]


def test_expand_gru_row_conv_layers():
    def build(fluid):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32",
                              lod_level=1)
        y = fluid.layers.data(name="y", shape=[9], dtype="float32",
                              lod_level=1)
        e = fluid.layers.sequence_expand(x=x, y=y)
        g = fluid.layers.dynamic_gru(input=y, size=3)
        gr = fluid.layers.dynamic_gru(input=y, size=3, is_reverse=True,
                                      candidate_activation="relu")
        rc = fluid.layers.row_conv(input=y, future_context_size=2)
        return [e, g, gr, rc,
                fluid.layers.sequence_last_step(input=g)]
    _run_layers(build, {"x": _seqs(2, 3, [1, 1]),
                        "y": _seqs(3, 9, [3, 5])})


def test_units_lod_reset_and_tail_layers():
    def build(fluid):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        h = fluid.layers.data(name="h", shape=[2], dtype="float32")
        c = fluid.layers.data(name="c", shape=[2], dtype="float32")
        gh, gr, gg = fluid.layers.gru_unit(input=x, hidden=h, size=6)
        lh, lc = fluid.layers.lstm_unit(x_t=x, hidden_t_prev=h,
                                        cell_t_prev=c, forget_bias=1.0)
        s = fluid.layers.data(name="s", shape=[2], dtype="float32",
                              lod_level=1)
        r = fluid.layers.lod_reset(s, target_lod=[0, 2, 5])
        a = fluid.layers.data(name="a", shape=[2], dtype="float32",
                              lod_level=1)
        cat = fluid.layers.sequence_concat([s, a])
        off = fluid.layers.data(name="off", shape=[1], dtype="int64")
        ln = fluid.layers.data(name="ln", shape=[1], dtype="int64")
        sl = fluid.layers.sequence_slice(s, off, ln)
        return [gh, gr, gg, lh, lc, r, r.seq_len_var, cat, cat.seq_len_var,
                sl, sl.seq_len_var]
    rng = np.random.RandomState(4)
    _run_layers(build, {
        "x": rng.randn(2, 6).astype("f"), "h": rng.randn(2, 2).astype("f"),
        "c": rng.randn(2, 2).astype("f"), "s": _seqs(5, 2, [4, 1]),
        "a": _seqs(6, 2, [2, 3]),
        "off": np.array([[1], [0]], "int64"),
        "ln": np.array([[2], [1]], "int64")})


def test_sequence_cache_write_layer():
    def build(fluid):
        cache = fluid.layers.data(name="cache", shape=[5, 4],
                                  dtype="float32")
        x = fluid.layers.data(name="xrow", shape=[4], dtype="float32")
        pos = fluid.layers.data(name="pos", shape=[1], dtype="int64")
        return [fluid.layers.sequence_cache_write(cache, x, pos)]
    rng = np.random.RandomState(7)
    _run_layers(build, {"cache": rng.randn(3, 5, 4).astype("f"),
                        "xrow": rng.randn(3, 4).astype("f"),
                        "pos": np.array([[0], [4], [2]], "int64")},
                exact=True)


def test_lod_reset_needs_a_target_in_both_packages():
    for fluid in (jfluid, tfluid):
        with pytest.raises(ValueError, match="target_lod"):
            _build(fluid, lambda f: f.layers.lod_reset(
                f.layers.data(name="x", shape=[2], dtype="float32",
                              lod_level=1)))


def test_gru_trains_as_in_the_jax_package():
    """fc -> dynamic_gru -> last step -> fc -> mean: three SGD steps from
    the JAX startup state, every loss and the parameters after them."""
    def build(fluid):
        x = fluid.layers.data(name="x", shape=[5], dtype="float32",
                              lod_level=1)
        proj = fluid.layers.fc(input=x, size=12)
        g = fluid.layers.dynamic_gru(input=proj, size=4, is_reverse=True)
        out = fluid.layers.fc(input=fluid.layers.sequence_last_step(g),
                              size=1)
        loss = fluid.layers.mean(fluid.layers.square(out))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss]
    jmain, jstartup, jfetch = _build(jfluid, build)
    tmain, _, tfetch = _build(tfluid, build)
    _same_bytes(jmain, tmain)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        state = {v.name: np.array(jscope.get(v.name))
                 for v in jmain.list_vars() if v.persistable}
        tscope = tio.scope_from_numpy(state, "cpu", program=tmain)
        texe = tfluid.Executor("cpu")
        for step in range(3):
            seqs = _seqs(10 + step, 5, [3, 1, 6])
            jl, = jexe.run(jmain, feed={"x": JLoDTensor.from_sequences(seqs)},
                           fetch_list=jfetch)
            tl, = texe.run(tmain, feed={"x": TLoDTensor.from_sequences(seqs)},
                           fetch_list=[v.name for v in tfetch], scope=tscope)
            np.testing.assert_allclose(tl, np.asarray(jl), **TOL)
        for name in state:
            np.testing.assert_allclose(
                tscope.get(name).numpy(), np.array(jscope.get(name)),
                err_msg=name, **TOL)
