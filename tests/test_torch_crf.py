"""The CRF, chunk and edit-distance ops against the JAX package, on the CPU.

Rules through both registries on the same numpy inputs from a seed, with
the cases of the JAX package's tests/unittests/test_crf_ops.py and
test_ctc_ops.py: linear_chain_crf (its loss, and its gradients through the
port's grad_of against jax.vjp), crf_decoding (with and without Label),
chunk_eval under IOB, IOE, IOBES and plain, with excluded types,
sequence_erase and edit_distance (normalized or not); then the layers
(their program bytes, edit_distance with ignored_tokens) and the
evaluators ChunkEvaluator and EditDistance accumulated over three batches
in both packages.

Tolerances: the NLL and its gradients rtol = atol = 1e-5 (fp32 on both
sides, logsumexp over at most 5 tags and 6 steps, summed in another
order); the decodes, every chunk and sequence count and the erased
sequences exact; precision, recall, F1 and the distances rtol 1e-6 (one
division of exact counts). Integer outputs are compared by value: the JAX
package's are int32 (x64 off), the port's int64.
"""
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
RATIO_RTOL = 1e-6
CHUNK_OUTS = ("Precision", "Recall", "F1-Score", "NumInferChunks",
              "NumLabelChunks", "NumCorrectChunks")
SCHEMES = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}  # tags a type


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: one intra-op thread does, and leaves the other
    test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _crf_case(t=5, lens=(5, 3, 1, 4), d=3, label_3d=False, seed=42):
    rng = np.random.RandomState(seed)
    b = len(lens)
    x = rng.randn(b, t, d).astype("float32")
    w = (0.5 * rng.randn(d + 2, d)).astype("float32")
    label = rng.randint(0, d, (b, t)).astype("int64")
    if label_3d:
        label = label[:, :, None]
    return x, w, np.array(lens, "int32"), label


_CRF_CASES = {"ragged": {}, "t1": dict(t=1, lens=(1, 1, 0)),
              "label_3d": dict(label_3d=True),
              "wide": dict(t=6, lens=(6, 2, 5), d=5, seed=3)}


@pytest.mark.parametrize("case", sorted(_CRF_CASES))
def test_linear_chain_crf_rule_and_gradient(case):
    x, w, xlen, label = _crf_case(**_CRF_CASES[case])
    ins = {"Emission": [x], "Transition": [w], "Label": [label],
           "XLen": [xlen]}
    jout, tout = _run_both("linear_chain_crf", ins, {})
    np.testing.assert_allclose(tout["LogLikelihood"][0],
                               jout["LogLikelihood"][0], **TOL)
    assert tout["LogLikelihood"][0].shape == (len(xlen), 1)
    got, want = _grads_both("linear_chain_crf", ins, {}, ["LogLikelihood"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=str(k), **TOL)


@pytest.mark.parametrize("case", sorted(_CRF_CASES))
@pytest.mark.parametrize("with_label", [False, True])
def test_crf_decoding_rule_is_exact(case, with_label):
    x, w, xlen, label = _crf_case(**_CRF_CASES[case])
    ins = {"Emission": [x], "Transition": [w], "XLen": [xlen]}
    if with_label:
        jpath = _run_both("crf_decoding", ins, {})[0]["ViterbiPath"][0]
        gold = np.asarray(jpath).astype("int64")
        gold[0, 0] = (gold[0, 0] + 1) % x.shape[2]   # one miss in row 0
        ins["Label"] = [gold[:, :, None] if label.ndim == 3 else gold]
    jout, tout = _run_both("crf_decoding", ins, {})
    np.testing.assert_array_equal(tout["ViterbiPath"][0],
                                  jout["ViterbiPath"][0])
    assert tout["ViterbiPath"][0].dtype == np.int64


def _chunk_case(scheme, seed, nct=3, b=6, t=12):
    rng = np.random.RandomState(seed)
    n_labels = nct * SCHEMES[scheme] + 1     # + the "other" label
    lens = rng.randint(1, t + 1, b).astype("int32")
    infer = rng.randint(0, n_labels, (b, t)).astype("int64")
    label = rng.randint(0, n_labels, (b, t)).astype("int64")
    label[:3] = infer[:3]                    # some agreement
    return {"Inference": [infer], "Label": [label], "XLen": [lens]}


def _same_chunks(ins, attrs):
    jout, tout = _run_both("chunk_eval", ins, attrs)
    for slot in CHUNK_OUTS:
        j, t = np.asarray(jout[slot][0]), tout[slot][0]
        assert t.shape == j.shape == (1,), slot
        if slot.startswith("Num"):
            assert t.dtype == np.int64
            np.testing.assert_array_equal(t, j, err_msg=slot)
        else:
            np.testing.assert_allclose(t, j, rtol=RATIO_RTOL, err_msg=slot)
    return tout


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_chunk_eval_rule_every_scheme(scheme):
    for seed in (7, 8):
        out = _same_chunks(_chunk_case(scheme, seed),
                           {"num_chunk_types": 3, "chunk_scheme": scheme})
    assert int(out["NumCorrectChunks"][0][0]) > 0


@pytest.mark.parametrize("scheme", ["IOB", "IOBES"])
def test_chunk_eval_rule_excluded_types(scheme):
    ins = _chunk_case(scheme, 3, b=4, t=10)
    for excluded in ([1], [0, 2]):
        _same_chunks(ins, {"num_chunk_types": 3, "chunk_scheme": scheme,
                           "excluded_chunk_types": excluded})


def test_chunk_eval_rule_labels_as_b_t_1():
    ins = _chunk_case("IOB", 9)
    ins = {k: [v[0][:, :, None]] if k != "XLen" else v
           for k, v in ins.items()}
    _same_chunks(ins, {"num_chunk_types": 3, "chunk_scheme": "IOB"})


def test_sequence_erase_rule():
    ins = {"X": [np.array([[3, 5, 2, 5, 9], [5, 5, 1, 0, 0]], "int64")],
           "XLen": [np.array([5, 3], "int32")]}
    for tokens in ([5], [5, 9], []):
        jout, tout = _run_both("sequence_erase", ins, {"tokens": tokens})
        for slot in ("Out", "OutLen"):
            np.testing.assert_array_equal(tout[slot][0], jout[slot][0])
    assert tout["OutLen"][0].tolist() == [5, 3]


@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance_rule(normalized):
    rng = np.random.RandomState(5)
    b, u1, u2 = 6, 7, 6
    ins = {"Hyps": [rng.randint(1, 5, (b, u1)).astype("int64")],
           "Refs": [rng.randint(1, 5, (b, u2)).astype("int64")],
           "HypsLen": [rng.randint(0, u1 + 1, b).astype("int32")],
           "RefsLen": [rng.randint(1, u2 + 1, b).astype("int32")]}
    jout, tout = _run_both("edit_distance", ins, {"normalized": normalized})
    np.testing.assert_allclose(tout["Out"][0], jout["Out"][0],
                               rtol=RATIO_RTOL)
    np.testing.assert_array_equal(tout["SequenceNum"][0],
                                  jout["SequenceNum"][0])
    assert tout["Out"][0].shape == (b, 1)


# --------------------------------------------------------------- layers --

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


def _build(fluid, build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = build(fluid)
    return main, startup, out


def _ids(seed, lens, hi):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, hi, (n, 1)).astype("int64") for n in lens]


def _seq_feed(lod_cls, seqs):
    return {n: lod_cls.from_sequences(s) for n, s in seqs.items()}


def _crf_layers(fluid):
    x = fluid.layers.data(name="x", shape=[4], dtype="float32",
                          lod_level=1)
    y = fluid.layers.data(name="y", shape=[1], dtype="int64", lod_level=1)
    emission = fluid.layers.fc(input=x, size=5)
    cost = fluid.layers.linear_chain_crf(
        input=emission, label=y, param_attr=fluid.ParamAttr(name="crfw"))
    decode = fluid.layers.crf_decoding(
        input=emission, param_attr=fluid.ParamAttr(name="crfw"))
    hits = fluid.layers.crf_decoding(
        input=emission, param_attr=fluid.ParamAttr(name="crfw"), label=y)
    chunks = fluid.layers.chunk_eval(input=decode, label=y,
                                     chunk_scheme="IOB", num_chunk_types=2)
    dist, n = fluid.layers.edit_distance(input=decode, label=y,
                                         ignored_tokens=[0])
    return [cost, decode, hits] + list(chunks) + [dist, n]


def test_crf_layers_build_and_run_as_in_the_jax_package():
    """The layers' bytes, then one run of each package from the JAX
    startup state: the costs within TOL, everything else exact."""
    from paddle_tpu_torch import io as tio
    jmain, jstartup, jfetch = _build(jfluid, _crf_layers)
    tmain, tstartup, tfetch = _build(tfluid, _crf_layers)
    _same_bytes(jmain, tmain)
    _same_bytes(jstartup, tstartup)
    lens = [5, 1, 3, 7]
    rng = np.random.RandomState(1)
    seqs = {"x": [rng.randn(n, 4).astype("f") for n in lens],
            "y": _ids(2, lens, 5)}
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        state = {v.name: np.array(jscope.get(v.name))
                 for v in jmain.list_vars() if v.persistable}
        want = jexe.run(jmain, feed=_seq_feed(JLoDTensor, seqs),
                        fetch_list=jfetch)
    got = tfluid.Executor("cpu").run(
        tmain, feed=_seq_feed(TLoDTensor, seqs), fetch_list=tfetch,
        scope=tio.scope_from_numpy(state, "cpu", program=tmain))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **TOL)
    for i, (g, w) in enumerate(zip(got[1:], want[1:]), 1):
        w = np.asarray(w)
        assert g.shape == w.shape, i
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RATIO_RTOL,
                                       err_msg="fetch %d" % i)
        else:
            np.testing.assert_array_equal(g, w, err_msg="fetch %d" % i)


def _evaluators(fluid):
    infer = fluid.layers.data(name="infer", shape=[1], dtype="int64",
                              lod_level=1)
    label = fluid.layers.data(name="label", shape=[1], dtype="int64",
                              lod_level=1)
    chunk = fluid.evaluator.ChunkEvaluator(
        input=infer, label=label, chunk_scheme="IOB", num_chunk_types=3)
    edit = fluid.evaluator.EditDistance(input=infer, label=label,
                                        ignored_tokens=[6])
    return chunk, edit


def _evaluate(fluid, lod_cls, place):
    main, startup, (chunk, edit) = _build(fluid, _evaluators)
    exe, scope = fluid.Executor(place), fluid.Scope()
    per_batch = []
    with fluid.scope_guard(scope):
        exe.run(startup)
        chunk.reset(exe)
        edit.reset(exe)
        for seed in range(3):
            lens = np.random.RandomState(seed).randint(1, 9, 5)
            infer = _ids(10 + seed, lens, 7)
            label = [s.copy() for s in infer]
            for s in label[:3]:
                s[0, 0] = (s[0, 0] + 1) % 7
            out = exe.run(main, feed={
                "infer": lod_cls.from_sequences(infer),
                "label": lod_cls.from_sequences(label)},
                fetch_list=chunk.metrics + edit.metrics)
            per_batch.append([np.asarray(o) for o in out])
        return per_batch, chunk.eval(exe), edit.eval(exe)


def test_evaluators_accumulate_to_the_jax_values():
    jb, jchunk, jedit = _evaluate(jfluid, JLoDTensor, jfluid.CPUPlace())
    tb, tchunk, tedit = _evaluate(tfluid, TLoDTensor, "cpu")
    for j, t in zip(jb, tb):
        for a, b in zip(j, t):
            np.testing.assert_allclose(b, a, rtol=RATIO_RTOL)
    for j, t in zip(jchunk + jedit, tchunk + tedit):
        assert t.dtype == np.float32 and t.shape == (1,)
        np.testing.assert_allclose(t, j, rtol=RATIO_RTOL)
    assert 0 < float(tchunk[2][0]) < 1 and float(tedit[0][0]) > 0
