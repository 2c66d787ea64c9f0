"""The port's training slice against the JAX package, end to end on the CPU.

Both packages build `transformer.build_train` at a small size (2+2 layers,
d_model 32, 4 heads, d_key 8, d_inner 64, vocab 64, T=16, label smoothing
0.1, fused attention, Adam(0.9, 0.98, 1e-9) on noam with 40 warm-up
steps). The JAX package runs its startup program; every persistable it
holds (parameters, Adam moments, beta pows, the step counter) is carried
into the port with io.scope_from_numpy. Then both run 20 steps on the
same numpy feeds (batch 4, ragged lengths, made from a seed), the JAX
package with its Pallas kernels in interpret mode (FLAGS_flash_min_seq=0,
PADDLE_TPU_PALLAS=1), the port through its kernel wrappers' plain
versions.

Tolerances:
- step 1's gradients: rtol = atol = 1e-5 — one fp32 forward and backward
  on each side, summed in a different order;
- every loss: rtol = 1e-5;
- the parameters and moments after 20 steps: every element within
  2 * (the sum of the 20 steps' learning rates), and at most 0.1% of the
  elements more than 1e-4 apart. Adam with epsilon 1e-9 moves a parameter
  by about lr * sign(g) even where g is rounding noise, so an element
  whose near-zero gradient has another sign in the other package may
  move the other way on any step: 2 * lr per step is the most that can
  add up to. Every other element agrees to fp32 rounding (measured: the
  largest difference is about 1e-6, no element over 1e-4).
"""
import json
import os

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
from paddle_tpu_torch.ops import cuda_kernels as ck

VOCAB, T, BATCH, STEPS = 64, 16, 4, 20
CFG = dict(n_layer=2, n_head=4, d_key=8, d_value=8, d_model=32,
           d_inner_hid=64, label_smooth_eps=0.1)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
# noam's rate over steps 1..20, inside its 40-step warm-up:
# d_model^-0.5 * step * 40^-1.5
LR_SUM = sum(CFG["d_model"] ** -0.5 * t * 40 ** -1.5
             for t in range(1, STEPS + 1))
PARAM_ATOL = 2 * LR_SUM
PARAM_CLOSE, PARAM_FAR_SHARE = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: one intra-op thread does, and leaves the other
    test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_build():
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        out = jtr.build_train(VOCAB, VOCAB, T, use_fused_attention=True,
                              **CFG)
    return main, startup, out


def _port_build():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        out = ttr.build_train(VOCAB, VOCAB, T, use_fused_attention=True,
                               **CFG)
    return main, startup, out


def _feed(step):
    rng = np.random.RandomState(100 + step)
    src = [rng.randint(3, VOCAB, rng.randint(4, T + 1)).tolist()
           for _ in range(BATCH)]
    trg = [rng.randint(3, VOCAB, rng.randint(4, T + 1)).tolist()
           for _ in range(BATCH)]
    return jtr.prepare_batch(src, trg, T, CFG["n_head"], fused=True)


def _grad_names(main):
    return sorted(p.name + "@GRAD" for p in main.all_parameters()
                  if p.trainable)


@pytest.fixture(scope="module")
def runs():
    """Both packages' 20 steps from the JAX startup state: (port main,
    port scope, JAX main, JAX scope, initial state, JAX losses, port
    losses, JAX step-1 grads, port step-1 grads, whether _build changed)."""
    jmain, jstartup, jout = _jax_build()
    tmain, _, tout = _port_build()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
    state = {v.name: np.array(jscope.get(v.name))
             for v in jmain.list_vars() if v.persistable}
    tscope = tio.scope_from_numpy(state, "cpu", program=tmain)
    texe = tfluid.Executor("cpu")
    build_before = sorted(os.listdir(ck.BUILD_DIR)) \
        if os.path.isdir(ck.BUILD_DIR) else None
    grads = _grad_names(tmain)
    jl, tl, jg, tg = [], [], None, None
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLAGS_flash_min_seq", "0")
        mp.setenv("PADDLE_TPU_PALLAS", "1")
        for step in range(STEPS):
            feed = _feed(step)
            fetch = [jout[1].name] + (grads if step == 0 else [])
            with jfluid.scope_guard(jscope):
                jres = jexe.run(jmain, feed=feed, fetch_list=fetch)
            tres = texe.run(tmain, feed=feed, fetch_list=fetch,
                            scope=tscope)
            jl.append(float(np.asarray(jres[0]).reshape(-1)[0]))
            tl.append(float(tres[0].reshape(-1)[0]))
            if step == 0:
                jg = [np.asarray(a) for a in jres[1:]]
                tg = tres[1:]
    build_after = sorted(os.listdir(ck.BUILD_DIR)) \
        if os.path.isdir(ck.BUILD_DIR) else None
    return dict(tmain=tmain, tscope=tscope, jmain=jmain, jscope=jscope,
                state=state, jl=jl, tl=tl, jg=jg, tg=tg, grads=grads,
                build_touched=build_before != build_after)


def test_step_one_gradients_agree(runs):
    assert len(runs["grads"]) == len(runs["tg"]) > 30
    for name, j, t in zip(runs["grads"], runs["jg"], runs["tg"]):
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, err_msg=name, **GRAD_TOL)


def test_every_loss_agrees_and_falls(runs):
    np.testing.assert_allclose(runs["tl"], runs["jl"], rtol=LOSS_RTOL)
    assert all(np.isfinite(runs["tl"]))
    assert np.mean(runs["tl"][-5:]) < np.mean(runs["tl"][:5])


def test_state_after_twenty_steps_agrees(runs):
    """Every persistable the JAX package holds: parameters and moments
    within PARAM_ATOL and, but for PARAM_FAR_SHARE of their elements,
    within PARAM_CLOSE; the beta pows and the step counter (int32 in the
    JAX package, int64 in the port; it starts at -1 and the first step's
    increment makes it 0) exactly."""
    tscope, jscope = runs["tscope"], runs["jscope"]
    far = total = 0
    for name in runs["state"]:
        t = tscope.get(name).numpy()
        j = np.asarray(jscope.get(name))
        if name == "@LR_DECAY_COUNTER@":
            assert t.dtype == np.int64
            assert t.tolist() == j.tolist() == [STEPS - 1]
        elif name.startswith("beta"):
            np.testing.assert_allclose(t, j, rtol=1e-6)
        else:
            np.testing.assert_allclose(t, j, atol=PARAM_ATOL, rtol=0,
                                       err_msg=name)
            far += int((np.abs(t - j) > PARAM_CLOSE).sum())
            total += t.size
    assert total > 100000 and far <= PARAM_FAR_SHARE * total, (far, total)


def test_frozen_position_tables_are_untouched(runs):
    """trainable=False: no Adam op and no accumulator, and the values are
    bit-identical after training (both packages still emit a grad_of
    output for them, as the tables are not stop_gradient)."""
    tmain, tscope, state = runs["tmain"], runs["tscope"], runs["state"]
    ops = tmain.global_block().ops
    for name in ttr.POS_ENC_PARAM_NAMES:
        np.testing.assert_array_equal(tscope.get(name).numpy(), state[name])
        assert not any(op.type == "adam" and op.inputs["Param"] == [name]
                       for op in ops)
        assert not any(name in v for v in tmain.global_block().vars
                       if v.startswith("moment"))


def test_the_cpu_run_builds_no_kernel(runs):
    assert not runs["build_touched"]


def test_training_program_matches_the_jax_one_op_for_op():
    jmain, jstartup, _ = _jax_build()
    tmain, tstartup, _ = _port_build()
    for j, t in ((jmain, tmain), (jstartup, tstartup)):
        jops, tops = j.global_block().ops, t.global_block().ops
        assert [op.type for op in tops] == [op.type for op in jops]
        for jo, to in zip(jops, tops):
            assert (to.uid, to.inputs, to.outputs) == \
                (jo.uid, jo.inputs, jo.outputs), to.type
            if to.type == "grad_of":
                for key in ("fwd_type", "fwd_uid", "fwd_inputs",
                            "fwd_outputs", "no_grad_names",
                            "__accumulate_outputs__"):
                    assert to.attrs[key] == jo.attrs[key], key
    types = {op.type for op in tmain.global_block().ops}
    assert {"grad_of", "adam", "adam_beta_pow_update",
            "softmax_with_cross_entropy", "increment"} <= types


def test_training_program_serializes_like_the_jax_one():
    """program_to_bytes is equal but for the JAX package's int64 -> int32
    narrowing (x64 is off there) of the dtypes it infers."""
    jmain, jstartup, _ = _jax_build()
    tmain, tstartup, _ = _port_build()
    for j, t in ((jmain, tmain), (jstartup, tstartup)):
        jd = json.loads(jdesc.program_to_bytes(j))
        td = json.loads(tdesc.program_to_bytes(t))
        narrowed = 0
        for jb, tb in zip(jd["blocks"], td["blocks"]):
            for jv, tv in zip(jb["vars"], tb["vars"]):
                if (jv["dtype"], tv["dtype"]) == ("int32", "int64"):
                    jv["dtype"] = "int64"
                    narrowed += 1
        assert td == jd
        assert narrowed <= 2
    # the byte-for-byte check on a program with no narrowed var
    assert tdesc.program_to_bytes(tstartup) == \
        jdesc.program_to_bytes(jstartup)


def test_scope_from_numpy_needs_every_persistable(runs):
    """Adam moments, beta pows and the step counter are checked by name and
    shape like the parameters: a training run resumes from the full
    state or not at all."""
    tmain, state = runs["tmain"], runs["state"]
    moment = next(n for n in state if n.startswith("moment1_"))
    for missing in (moment, "@LR_DECAY_COUNTER@", "beta2_pow_acc_1"):
        arrays = {k: v for k, v in state.items() if k != missing}
        with pytest.raises(ValueError, match="%s: missing" % missing):
            tio.scope_from_numpy(arrays, "cpu", program=tmain)
    wrong = dict(state, **{moment: np.zeros((3,), np.float32)})
    with pytest.raises(ValueError, match="%s: shape" % moment):
        tio.scope_from_numpy(wrong, "cpu", program=tmain)


def _both(build):
    """Run `build(fluid)` -> (fetch vars, feed) under fresh programs of
    each package; returns (JAX fetches, port fetches) of one run after
    the startup program (the port's weights carried from the JAX ones)."""
    outs = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            fetch, feed = build(fluid)
        outs.append((main, startup, fetch, feed))
    (jmain, jstartup, jfetch, feed), (tmain, _, tfetch, _) = outs
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        state = {v.name: np.array(jscope.get(v.name))
                 for v in jmain.list_vars() if v.persistable}
        want = jexe.run(jmain, feed=feed, fetch_list=jfetch)
    got = tfluid.Executor("cpu").run(
        tmain, feed=feed, fetch_list=[v.name for v in tfetch],
        scope=tio.scope_from_numpy(state, "cpu", program=tmain))
    return [np.asarray(w) for w in want], got


@pytest.mark.parametrize("seeded", [False, True])
def test_calc_gradient_matches_the_jax_package(seeded):
    """calc_gradient of y = x * x + 3 x (reduced) with respect to a data
    var (stop_gradient, so differentiable only as an explicit input),
    with the target's gradient filled with ones or fed."""
    rng = np.random.RandomState(1)
    xs = rng.randn(4, 5).astype(np.float32)
    gs = rng.randn(4, 1).astype(np.float32)

    def build(fluid):
        x = fluid.layers.data("x", [5])
        y = fluid.layers.reduce_sum(x * x + x * 3.0, dim=1, keep_dim=True)
        feed = {"x": xs}
        tg = None
        if seeded:
            tg = [fluid.layers.data("g", [1])]
            feed["g"] = gs
        dx, = fluid.backward.calc_gradient(y, x, target_gradients=tg)
        return [dx], feed

    want, got = _both(build)
    expect = (2 * xs + 3) * (gs if seeded else 1.0)
    np.testing.assert_allclose(got[0], want[0], **GRAD_TOL)
    np.testing.assert_allclose(got[0], expect, **GRAD_TOL)


@pytest.mark.parametrize("kind", ["L2Decay", "L1Decay"])
def test_weight_decay_matches_the_jax_package(kind):
    """Adam with a regularizer: the decay term is added to each gradient
    before the update (L1 through the sign op), as in the JAX package."""
    rng = np.random.RandomState(2)
    xs = rng.randn(6, 8).astype(np.float32)

    def build(fluid):
        x = fluid.layers.data("x", [8])
        y = fluid.layers.fc(input=x, size=3)
        loss = fluid.layers.reduce_sum(y * y)
        reg = getattr(fluid.regularizer, kind)(0.05)
        fluid.optimizer.Adam(learning_rate=0.01,
                             regularization=reg).minimize(loss)
        params = sorted(p.name for p in
                        fluid.default_main_program().all_parameters())
        return ([loss] + [fluid.default_main_program().global_block()
                          .var(n) for n in params]
                + [fluid.default_main_program().global_block()
                   .var(n + "@GRAD@REGULARIZED") for n in params],
                {"x": xs})

    want, got = _both(build)
    assert len(got) == 5
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


def test_unported_gradient_clips_raise_when_the_program_is_built():
    """Clipping is ported (ROADMAP A3; it raised at build time before):
    GradientClipByNorm builds one clip_by_norm op per gradient, and Adam
    updates from the clipped gradient, whose norm is at most clip_norm
    (tests/test_torch_clip.py holds every clip against the JAX
    package)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [8])
        loss = tfluid.layers.reduce_sum(tfluid.layers.fc(input=x, size=3))
        tfluid.clip.set_gradient_clip(tfluid.GradientClipByNorm(1.0))
        tfluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    clips = [op for op in main.global_block().ops
             if op.type == "clip_by_norm"]
    assert len(clips) == 2
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    exe.run(startup, scope=scope)
    names = [op.outputs["Out"][0] for op in clips]
    raw = [op.inputs["X"][0] for op in clips]
    got = exe.run(main, feed={"x": np.full((4, 8), 3.0, np.float32)},
                  fetch_list=names + raw, scope=scope)
    for clipped, grad in zip(got[:2], got[2:]):
        assert np.linalg.norm(grad) > 1.0
        np.testing.assert_allclose(np.linalg.norm(clipped), 1.0, rtol=1e-5)
        np.testing.assert_allclose(clipped, grad / np.linalg.norm(grad),
                                   rtol=1e-5, atol=1e-7)


def test_kept_graphs_are_released_and_inference_keeps_none():
    """A training run keeps each differentiated op's local graph only until
    its grad_of, and leaves no tensor that requires grad in the run's
    values; a run of the pruned scoring program keeps no graph at all."""
    from paddle_tpu_torch.core.lowering import Env, LowerCtx, lower_block
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        _, avg_cost, predict = ttr.build_train(
            VOCAB, VOCAB, T, use_fused_attention=True,
            **dict(CFG, n_layer=1))
    exe = tfluid.Executor("cpu")
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = _feed(0)
    for program, grad_ops in ((main, True),
                              (main.prune([predict.name], for_test=True),
                               False)):
        persistable = {v.name for v in program.list_vars() if v.persistable}
        env = Env(scope, persistable, torch.device("cpu"))
        for name, value in feed.items():
            if program.global_block().vars.get(name) is not None:
                env.write(name, torch.from_numpy(value))
        ctx = LowerCtx(program, torch.device("cpu"), run_seed=1)
        with torch.no_grad():
            lower_block(ctx, program.global_block(), env)
        assert bool(ctx.grad_stop) == grad_ops
        assert ctx.saved == {}
        assert not any(v.requires_grad for v in env.values.values())
