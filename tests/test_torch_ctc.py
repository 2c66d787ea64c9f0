"""The OCR path's op rules (ROADMAP A6): warpctc, ctc_align, im2sequence,
and the ctc_greedy_decoder layer, in the port against the JAX package on
the CPU; the cases of tests/unittests/test_ctc_ops.py.

- warpctc: the loss and its gradient (autograd through the port's alpha
  loop against jax.vjp through the JAX lax.scan, with a random cotangent)
  with the blank at 0 and at the last class, repeated labels, a row of
  LabelLen 0, a row whose labels need more steps than it has (an
  infeasible alignment: the JAX package's large finite loss, not inf),
  norm_by_times off and on (the value raw, the gradient divided by T);
  the feasible rows also against a brute-force sum over every path.
- ctc_align with merge_repeated on and off (exact), on the JAX test's
  rows and on random ones.
- im2sequence with asymmetric paddings (up, left, down, right) and
  strides, and with two-element paddings, forward and gradient.
- ctc_greedy_decoder, warpctc and im2sequence as layers: the JAX
  package's program bytes, and the same decodes on a LoD feed.

Tolerances: rtol = atol = 1e-5 for warpctc's loss and gradient (a fp32
log-sum-exp recursion over at most 7 steps, in another order; the
infeasible row's 1e30 compared relative), 1e-4 relative against the
float64 brute force; im2sequence, ctc_align and the decodes exact (they
move values).
"""
import itertools
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc
from paddle_tpu.core.lod import LoDTensor as JLoDTensor

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.core.lod import LoDTensor as TLoDTensor

from test_torch_ops import _grads_both, _run_both

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _collapse(path, blank):
    out, prev = [], None
    for p in path:
        if p != blank and p != prev:
            out.append(p)
        prev = p
    return out


def _brute_nll(logits, label, blank):
    """-log P(label | logits), summing every alignment path (float64)."""
    t, c = logits.shape
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    total = sum(np.prod([probs[i, p] for i, p in enumerate(path)])
                for path in itertools.product(range(c), repeat=t)
                if _collapse(path, blank) == list(label))
    return -np.log(total)


def _ctc_case(blank):
    """5 rows, T = 5, 4 classes, U = 3: distinct labels, a repeat (which
    needs a blank between), LabelLen 0, a short row, and an infeasible
    row (three equal labels need 5 steps; it has 3)."""
    rng = np.random.RandomState(3)
    b, t, c, u = 5, 5, 4, 3
    nonblank = [k for k in range(c) if k != blank]
    logits = rng.randn(b, t, c).astype("float32")
    xlen = np.array([5, 5, 4, 2, 3], dtype="int32")
    llen = np.array([3, 2, 0, 1, 3], dtype="int32")
    label = np.zeros((b, u), dtype="int64")
    label[0] = nonblank[:3]
    label[1, :2] = nonblank[1]
    label[3, 0] = nonblank[2]
    label[4] = nonblank[0]
    return {"Logits": [logits], "Label": [label], "XLen": [xlen],
            "LabelLen": [llen]}


@pytest.mark.parametrize("norm_by_times", [False, True],
                         ids=["raw", "norm_by_times"])
@pytest.mark.parametrize("blank", [0, 3], ids=["blank_first",
                                               "blank_last"])
def test_warpctc_loss_and_gradient(blank, norm_by_times):
    ins = _ctc_case(blank)
    attrs = {"blank": blank, "norm_by_times": norm_by_times}
    jout, tout = _run_both("warpctc", ins, attrs)
    loss = tout["Loss"][0]
    np.testing.assert_allclose(loss, jout["Loss"][0], **TOL)
    np.testing.assert_array_equal(tout["WarpCTCGrad"][0], 0.0)
    logits, label = ins["Logits"][0], ins["Label"][0]
    xlen, llen = ins["XLen"][0], ins["LabelLen"][0]
    for i in range(4):
        want = _brute_nll(logits[i, :xlen[i]].astype("float64"),
                          label[i, :llen[i]], blank)
        np.testing.assert_allclose(loss[i, 0], want, rtol=1e-4)
    # the infeasible row: large and finite in both packages
    assert np.isfinite(loss[4, 0]) and loss[4, 0] > 1e29
    got, want = _grads_both("warpctc", ins, attrs, ["Loss"], seed=4)
    assert list(got) == list(want) == [("Logits", 0)]
    np.testing.assert_allclose(got[("Logits", 0)], want[("Logits", 0)],
                               **TOL)
    # padded steps get no gradient
    np.testing.assert_array_equal(got[("Logits", 0)][3, 2:], 0.0)


def test_warpctc_norm_by_times_divides_only_the_gradient():
    ins = _ctc_case(0)
    raw = _grads_both("warpctc", ins, {"blank": 0}, ["Loss"], seed=5)[0]
    normed = _grads_both("warpctc", ins, {"blank": 0, "norm_by_times": True},
                         ["Loss"], seed=5)[0]
    t = np.maximum(ins["XLen"][0], 1).astype("float32")[:, None, None]
    np.testing.assert_allclose(normed[("Logits", 0)],
                               raw[("Logits", 0)] / t, **TOL)


@pytest.mark.parametrize("merge", [True, False], ids=["merge", "no_merge"])
def test_ctc_align(merge):
    x = np.array([[0, 1, 1, 0, 2, 2, 0, 3],
                  [1, 1, 2, 0, 0, 1, 0, 0],
                  [3, 3, 3, 0, 3, 1, 1, 2]], dtype="int64")
    xlen = np.array([8, 6, 0], dtype="int32")
    rnd = np.random.RandomState(6).randint(0, 4, (4, 8)).astype("int64")
    for data, lens in ((x, xlen), (rnd, np.array([8, 5, 1, 3], "int32"))):
        jout, tout = _run_both(
            "ctc_align", {"Input": [data[:, :, None]], "XLen": [lens]},
            {"blank": 0, "merge_repeated": merge})
        for slot in ("Output", "OutLen"):
            np.testing.assert_array_equal(tout[slot][0], jout[slot][0])
    if merge:
        assert tout["OutLen"][0].tolist()[:1] == [
            len(_collapse(rnd[0].tolist(), 0))]


@pytest.mark.parametrize("kernels, strides, paddings", [
    ((2, 3), (1, 2), (1, 0, 2, 1)),      # up, left, down, right
    ((3, 2), (2, 1), (0, 2, 1, 0)),
    ((2, 2), (2, 2), (1, 1)),            # (up, left) on both sides
    ((5, 1), (1, 1), (0, 0, 0, 0))])     # the OCR model's column slicing
def test_im2sequence(kernels, strides, paddings):
    ins = {"X": [np.random.RandomState(7).randn(2, 3, 5, 6)
                 .astype("float32")]}
    attrs = {"kernels": list(kernels), "strides": list(strides),
             "paddings": list(paddings)}
    jout, tout = _run_both("im2sequence", ins, attrs)
    for slot in ("Out", "OutLen"):
        assert tout[slot][0].shape == jout[slot][0].shape
        np.testing.assert_array_equal(tout[slot][0], jout[slot][0])
    got, want = _grads_both("im2sequence", ins, attrs, ["Out"], seed=8)
    np.testing.assert_allclose(got[("X", 0)], want[("X", 0)], **TOL)


def _decoder_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[2, 3, 8],
                                dtype="float32")
        seq = fluid.layers.im2sequence(img, filter_size=(3, 1))
        logits = fluid.layers.fc(input=seq, size=4)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64",
                                  lod_level=1)
        cost = fluid.layers.warpctc(input=logits, label=label, blank=3)
        decoded = fluid.layers.ctc_greedy_decoder(input=logits, blank=3)
        seq_len = main.global_block().var(decoded.seq_len_var)
    return main, startup, (cost, decoded, seq_len)


def test_ctc_layers_match_the_jax_package():
    """im2sequence -> fc -> warpctc and ctc_greedy_decoder: the JAX
    package's program bytes; from its startup state, the same costs,
    decodes and decoded lengths."""
    from paddle_tpu_torch import io as tio
    jmain, jstartup, jfetch = _decoder_program(jfluid)
    tmain, _, tfetch = _decoder_program(tfluid)
    jd = json.loads(jdesc.program_to_bytes(jmain))
    td = json.loads(tdesc.program_to_bytes(tmain))
    for jb, tb in zip(jd["blocks"], td["blocks"]):
        for jv, tv in zip(jb["vars"], tb["vars"]):
            if (jv["dtype"], tv["dtype"]) == ("int32", "int64"):
                jv["dtype"] = "int64"
    assert td == jd
    rng = np.random.RandomState(9)
    img = rng.randn(4, 2, 3, 8).astype("float32")
    labels = [rng.randint(0, 3, (n, 1)).astype("int64") for n in (2, 1, 3, 4)]
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(jstartup)
        want = exe.run(jmain, feed={"img": img, "label":
                                    JLoDTensor.from_sequences(labels)},
                       fetch_list=list(jfetch))
    state = {v.name: np.array(scope.get(v.name))
             for v in jmain.list_vars() if v.persistable}
    got = tfluid.Executor("cpu").run(
        tmain, feed={"img": img, "label": TLoDTensor.from_sequences(labels)},
        fetch_list=list(tfetch),
        scope=tio.scope_from_numpy(state, "cpu", program=tmain))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **TOL)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    assert got[1].shape == (4, 8)         # one step per column
