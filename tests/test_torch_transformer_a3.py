"""The Transformer's training builders at the JAX package's signature
(fault C11) and its A3 features (dropout, the unfused label smoothing,
the fused qkv projection) against the JAX package, on the CPU.

- Program bytes: transformer() and build_train() with their defaults
  (the dense attn_bias attention, no dropout, the fused label smoothing,
  no qkv fusion), and with dropout_rate 0.1, use_fused_label_smooth=False
  (one_hot -> label_smooth -> soft-label softmax_with_cross_entropy) and
  use_qkv_fusion=True (one fused_qkv.w projection, split in three),
  serialize to the JAX package's bytes, main and startup, but for its
  int64 -> int32 narrowing of inferred dtypes. Fused attention with
  dropout raises in both.
- Numbers: the dropout program with every dropout op's dropout_prob set
  to 0 in both built Programs (the random streams differ by design; the
  JAX package's grad_of replays the forward rule from a copy of its attrs,
  so the copy is set too), one
  training step from the JAX package's startup state: the loss within
  rtol 1e-5 and every gradient within rtol = atol = 1e-5 (fp32 sums in
  another order, as tests/test_torch_training.py holds the fused path).
- The inference program of the same configuration with dropout on
  (transformer(), clone(for_test=True): every dropout scales by 1 - p,
  no draw): the predicted logits within rtol = atol = 1e-5 of the JAX
  package's, and the same on a second run.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import program_desc as jdesc
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.models import transformer as ttr

VOCAB, T, BATCH = 40, 8, 3
SMALL = dict(n_layer=1, n_head=2, d_key=8, d_value=8, d_model=16,
             d_inner_hid=32)
A3 = dict(dropout_rate=0.1, label_smooth_eps=0.1,
          use_fused_label_smooth=False, use_qkv_fusion=True)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread does, and leaves the other test
    workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _narrowed(jprog, tprog):
    """Both programs' JSON, the JAX package's int32 vars that the port
    declares int64 set back to int64."""
    jd = json.loads(jdesc.program_to_bytes(jprog))
    td = json.loads(tdesc.program_to_bytes(tprog))
    for jb, tb in zip(jd["blocks"], td["blocks"]):
        for jv, tv in zip(jb["vars"], tb["vars"]):
            if (jv["dtype"], tv["dtype"]) == ("int32", "int64"):
                jv["dtype"] = "int64"
    return jd, td


def _built(fluid, fn):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = fn()
    return main, startup, out


@pytest.mark.parametrize("builder", ["transformer", "build_train"])
@pytest.mark.parametrize("kwargs", [{}, A3], ids=["defaults", "a3"])
def test_builders_serialize_to_the_jax_bytes(builder, kwargs):
    jmain, jstartup, _ = _built(jfluid, lambda: getattr(jtr, builder)(
        VOCAB, VOCAB, T, **kwargs))
    tmain, tstartup, _ = _built(tfluid, lambda: getattr(ttr, builder)(
        VOCAB, VOCAB, T, **kwargs))
    jd, td = _narrowed(jmain, tmain)
    assert td == jd
    assert tdesc.program_to_bytes(tstartup) == \
        jdesc.program_to_bytes(jstartup)
    types = [op.type for op in tmain.global_block().ops]
    assert "fused_attention" not in types
    if kwargs:
        # the two embeddings; each of the 2 encoder layers' attention
        # weights and two sublayers; each decoder layer's two attentions'
        # weights and three sublayers
        assert types.count("dropout") == 2 + 2 * 3 + 2 * 5
        assert "label_smooth" in types and "split" in types
        assert any(p.name.startswith("fused_qkv.w")
                   for p in tmain.all_parameters())
        xent, = [op for op in tmain.global_block().ops
                 if op.type == "softmax_with_cross_entropy"]
        assert xent.attrs["soft_label"]


@pytest.mark.parametrize("fluid,tr", [(jfluid, jtr), (tfluid, ttr)],
                         ids=["jax", "port"])
def test_fused_attention_with_dropout_raises(fluid, tr):
    with pytest.raises(ValueError, match="dropout_rate=0"):
        _built(fluid, lambda: tr.build_train(VOCAB, VOCAB, T,
                                             use_fused_attention=True,
                                             dropout_rate=0.1))


def _a3_programs(builder="build_train"):
    jmain, jstartup, jout = _built(jfluid, lambda: getattr(jtr, builder)(
        VOCAB, VOCAB, T, **SMALL, **A3))
    tmain, _, tout = _built(tfluid, lambda: getattr(ttr, builder)(
        VOCAB, VOCAB, T, **SMALL, **A3))
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup)
    state = {v.name: np.array(jscope.get(v.name))
             for v in jmain.list_vars() if v.persistable}
    rng = np.random.RandomState(12)
    src = [rng.randint(3, VOCAB, n).tolist() for n in (T, 5, 3)]
    trg = [rng.randint(3, VOCAB, n).tolist() for n in (4, T, 6)]
    feed = jtr.prepare_batch(src, trg, T, SMALL["n_head"])
    return jmain, jout, tmain, tout, state, feed


def _jax_run(main, state, feed, fetch):
    scope = jfluid.Scope()
    for name, a in state.items():
        scope.set(name, a)
    with jfluid.scope_guard(scope):
        out = jfluid.Executor(jfluid.CPUPlace()).run(main, feed=feed,
                                                     fetch_list=fetch)
    return [np.asarray(x) for x in out]


def test_a3_training_step_matches_the_jax_one_at_p0():
    jmain, (_, javg, _), tmain, (_, tavg, _), state, feed = _a3_programs()
    for prog in (jmain, tmain):
        drops = [op for op in prog.global_block().ops if op.type == "dropout"]
        assert len(drops) == 2 + 3 + 5
        for op in drops:
            op.attrs["dropout_prob"] = 0.0
        for op in prog.global_block().ops:
            if op.type == "grad_of" and op.attrs["fwd_type"] == "dropout":
                op.attrs["fwd_attrs"]["dropout_prob"] = 0.0
    grads = sorted(p.name + "@GRAD" for p in tmain.all_parameters()
                   if p.trainable)
    want = _jax_run(jmain, state, feed, [javg.name] + grads)
    got = tfluid.Executor("cpu").run(
        tmain, feed=feed, fetch_list=[tavg.name] + grads,
        scope=tio.scope_from_numpy(state, "cpu", program=tmain))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for name, g, w in zip(grads, got[1:], want[1:]):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_a3_inference_program_matches_the_jax_one():
    jmain, (_, _, jpred), tmain, (_, _, tpred), state, feed = _a3_programs(
        "transformer")
    jtest, ttest = jmain.clone(for_test=True), tmain.clone(for_test=True)
    assert all(op.attrs["is_test"] for op in ttest.global_block().ops
               if op.type == "dropout")
    want, = _jax_run(jtest, state, feed, [jpred.name])
    scope = tio.scope_from_numpy(state, "cpu", program=ttest)
    exe = tfluid.Executor("cpu")
    got, = exe.run(ttest, feed=feed, fetch_list=[tpred.name], scope=scope)
    again, = exe.run(ttest, feed=feed, fetch_list=[tpred.name], scope=scope)
    assert got.shape == (BATCH, T, VOCAB)
    np.testing.assert_array_equal(got, again)
    np.testing.assert_allclose(got, want, **TOL)
