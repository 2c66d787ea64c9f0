"""Places where the port's result once differed from the JAX package's,
each held to the JAX rule on the CPU.

- lookup_table with ids outside [0, V): the JAX rule's jnp.take wraps an
  id in [-V, 0) and gives a NaN row for any other, and W's gradient gets
  nothing from such a row. Exact: both sides only select values.
- softmax_with_cross_entropy and cross_entropy with hard labels outside
  [0, V): the JAX package's CPU path (its `_gather_label_logits`) wraps
  -1 to V - 1 and clamps V + k to V - 1. rtol = atol = 1e-5: fp32 log-
  softmax summed in another order.
- random ops inside an RNN step: the JAX rng folds each enclosing loop's
  iteration into the key, so a step's draw differs from the last one's.
  The port's streams are its own generators (the JAX package's threefry
  bits are not portable), so this compares behaviour and statistics,
  never bits.
- outputs that nothing reads (softmax_with_cross_entropy's Softmax) are
  not built, and the losses still match.
- fused_attention with a query length other than the key length: the
  JAX rule answers through its dense attention_reference; the port sent
  every such shape to its flash kernel, which takes one length for q, k
  and v, and raised. rtol = atol = 1e-5: fp32 in another order.
- sequence_pool LAST and sequence_last_step with a length above T (C8):
  the JAX rule's jnp.take_along_axis fills the row with NaN and it gets
  no gradient; the port's gather raised. Lengths 0 and negative take
  step 0 in both. Exact: both sides only select values.
- fused_attention with a row that has no valid key (C9): below its 1024
  crossover the JAX package answers through its dense path, which gives
  the mean of v over all keys; at and above it through its flash kernel,
  which gives 0, as the port's does at every length. rtol = atol = 1e-5
  for values and gradients: fp32 in another order.
- warpctc with a Label or LabelLen out of range (C14) and
  edit_distance with a HypsLen or RefsLen out of range (C15): the JAX
  rules gather with jnp.take_along_axis, which wraps an index in
  [-n, -1] and gives NaN past the end; the port clamped. Losses and
  gradients at rtol = atol = 1e-5 (fp32 log-sum-exp in another order),
  distances exact (both sides select one table entry), NaN equal to NaN.
- topk among equal values (C12): lax.top_k puts the lower index first
  (and ranks NaN above inf, +0 above -0); the port's torch.topk left ties
  in an order of its own, so `accuracy` on a tied row differed. Exact:
  both sides only select values.

Inputs are made with numpy from a seed and handed to both packages.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu  # noqa: F401  (registers the JAX rules)
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lowering import LowerCtx as JaxCtx

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lowering import LowerCtx as TorchCtx
from paddle_tpu_torch.ops import cuda_kernels as ck

from test_torch_ops import _grads_both, _run_both

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def _jax_rule(op_type, ins, attrs):
    jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    return jreg.get(op_type).lower(JaxCtx(None, base_key=jax.random.key(0)),
                                   jins, attrs)


def _port_rule(op_type, ins, attrs):
    tins = {s: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
            for s, v in ins.items()}
    return treg.get(op_type).lower(TorchCtx(None, CPU, run_seed=1), tins,
                                   attrs)


# --------------------------------------------------------- lookup_table --

_V = 6


def _lookup_inputs(shape):
    rng = np.random.RandomState(21)
    w = rng.randn(_V, 5).astype(np.float32)
    ids = rng.randint(0, _V, size=shape).astype(np.int64)
    flat = ids.reshape(-1)
    flat[:5] = [_V, _V + 5, -1, -_V, -_V - 1]   # NaN, NaN, V-1, 0, NaN
    return w, flat.reshape(shape)


@pytest.mark.parametrize("padding_idx", [-1, 2])
@pytest.mark.parametrize("shape", [(9, 1), (3, 4)])
def test_lookup_table_out_of_range_ids_match_jnp_take(shape, padding_idx):
    """Ids V, V + 5 and -V - 1 give NaN rows, -1 and -V wrap; values
    compared with NaN equal to NaN, exactly."""
    w, ids = _lookup_inputs(shape)
    ins = {"W": [w], "Ids": [ids]}
    attrs = {"padding_idx": padding_idx}
    want = np.asarray(_jax_rule("lookup_table", ins, attrs)["Out"][0])
    got = _port_rule("lookup_table", ins, attrs)["Out"][0].numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    nan_rows = np.isnan(got.reshape(-1, w.shape[1])).all(axis=1)
    assert list(nan_rows[:5]) == [True, True, False, False, True]


def test_lookup_table_gradient_skips_out_of_range_ids():
    """dW of sum(out * g) over the valid rows only: the rows of the ids
    that wrap land on their wrapped row, the NaN rows add nothing."""
    w, ids = _lookup_inputs((9, 1))
    g = np.random.RandomState(22).randn(9, 5).astype(np.float32)
    keep = np.ones(9, bool)
    keep[[0, 1, 4]] = False     # the ids that give NaN rows

    def jloss(wj):
        out = _jax_rule("lookup_table", {"W": [wj], "Ids": [ids]},
                        {})["Out"][0]
        return jnp.sum(jnp.where(keep[:, None], out * g, 0.0))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_(True)
    out = treg.get("lookup_table").lower(
        TorchCtx(None, CPU), {"W": [wt], "Ids": [torch.from_numpy(ids)]},
        {})["Out"][0]
    torch.where(torch.from_numpy(keep)[:, None], out * torch.from_numpy(g),
                torch.zeros(())).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), want, **TOL)
    # the full output's gradient also leaves W finite: a NaN row takes
    # no part of W
    wt.grad = None
    out = treg.get("lookup_table").lower(
        TorchCtx(None, CPU), {"W": [wt], "Ids": [torch.from_numpy(ids)]},
        {})["Out"][0]
    (out * torch.from_numpy(g)).sum().backward()
    assert np.isfinite(wt.grad.numpy()).all()


# ------------------------------------------------------ hard-label xent --

def _xent_logits(shape):
    """ROADMAP's [3, 5] example: rows 0 and 1 have labels -1 and 7."""
    logits = np.random.RandomState(23).randn(*shape).astype(np.float32) * 2
    return logits


@pytest.mark.parametrize("labels", [[-1, 7, 2], [5, -5, -6]])
@pytest.mark.parametrize("rank", [2, 3])
def test_softmax_with_cross_entropy_out_of_range_labels(rank, labels):
    """-1 -> V - 1, V + k -> V - 1, -V -> 0, -V - 1 -> 0 (the JAX CPU path,
    PADDLE_TPU_PALLAS=0), on 2-D logits (K4's plain version) and 3-D (the
    log-softmax path)."""
    logits = _xent_logits((3, 5))
    lab = np.array(labels, np.int64).reshape(3, 1)
    if rank == 3:
        logits, lab = logits[None], lab[None]
    ins = {"Logits": [logits], "Label": [lab]}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_PALLAS", "0")
        want = np.asarray(_jax_rule("softmax_with_cross_entropy", ins,
                                    {})["Loss"][0])
    got = _port_rule("softmax_with_cross_entropy", ins, {})["Loss"][0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the rule by hand: the class hard_label_index picks
    idx = [(v + 5 if v < 0 else v) for v in labels]
    idx = [min(max(v, 0), 4) for v in idx]
    lp = torch.log_softmax(torch.from_numpy(logits.reshape(3, 5)), -1)
    np.testing.assert_allclose(got.numpy().reshape(3),
                               -lp[torch.arange(3), idx].numpy(), **TOL)


def test_roadmap_example_losses():
    """ROADMAP §C3's numbers: a [3, 5] row block with labels -1 and 7 gives
    1.385 / 1.419 on the JAX CPU path; the port now agrees (2-D and
    3-D)."""
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 5).astype(np.float32)
    lab = np.array([[-1], [7], [0]], np.int64)
    for lg, lb in ((logits, lab), (logits[None], lab[None])):
        ins = {"Logits": [lg], "Label": [lb]}
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PADDLE_TPU_PALLAS", "0")
            want = np.asarray(_jax_rule("softmax_with_cross_entropy", ins,
                                        {})["Loss"][0]).reshape(-1)
        got = _port_rule("softmax_with_cross_entropy", ins,
                         {})["Loss"][0].numpy().reshape(-1)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got[:2], [1.385, 1.419], atol=1e-3)


def test_cross_entropy_out_of_range_labels():
    """cross_entropy on probabilities takes the same class rule."""
    probs = torch.softmax(torch.from_numpy(_xent_logits((4, 5))), -1).numpy()
    lab = np.array([[-1], [5], [9], [-7]], np.int64)
    ins = {"X": [probs], "Label": [lab]}
    want = np.asarray(_jax_rule("cross_entropy", ins, {})["Y"][0])
    got = _port_rule("cross_entropy", ins, {})["Y"][0].numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_softmax_xent_backward_takes_the_forward_class():
    """SoftmaxXent's gradient puts the one-hot at the class the forward
    picked: against autograd through log_softmax and that class for
    every label, and against jax.vjp of the JAX CPU path for the labels
    in [-V, V). (For a label that only the clamp brings into range, V + k
    or -V - k, the JAX gradient is 0: its gather clamps but the scatter
    that transposes it drops the index. The port keeps the gradient of
    its own forward.)"""
    logits = _xent_logits((6, 5))
    lab = np.array([-1, 5, 12, -5, -9, 3], np.int64)
    g = np.random.RandomState(24).randn(6, 1).astype(np.float32)
    x = torch.from_numpy(logits).requires_grad_(True)
    loss, _ = ck.SoftmaxXent.apply(x, torch.from_numpy(lab))
    got, = torch.autograd.grad(loss, x, torch.from_numpy(g))
    y = torch.from_numpy(logits).requires_grad_(True)
    idx = ck.hard_label_index(torch.from_numpy(lab)[:, None], 5)
    ref = -torch.log_softmax(y, -1).gather(1, idx)
    want, = torch.autograd.grad(ref, y, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)

    def jloss(xj):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PADDLE_TPU_PALLAS", "0")
            return _jax_rule("softmax_with_cross_entropy",
                             {"Logits": [xj], "Label": [lab[:, None]]},
                             {})["Loss"][0]

    _, vjp = jax.vjp(jloss, jnp.asarray(logits))
    jwant, = vjp(jnp.asarray(g))
    inside = (lab >= -5) & (lab < 5)
    np.testing.assert_allclose(got.numpy()[inside],
                               np.asarray(jwant)[inside], **TOL)


# ------------------------------------------- random ops in an RNN step --

def _noisy_rnn(b, t, h, seed):
    """A StaticRNN whose step adds uniform_random [B, H] noise (op seed
    `seed`; 0 = the run's stream) to its step input; the output stacks
    the steps."""
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = 7
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[t, h], dtype="float32")
        rnn = tfluid.layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            block = main.current_block()
            noise = block.create_var(name="step_noise", shape=[b, h],
                                     dtype="float32")
            block.append_op(type="uniform_random", outputs={"Out": [noise]},
                            attrs={"shape": [b, h], "min": 0.0, "max": 1.0,
                                   "dtype": "float32", "seed": seed},
                            infer_shape=False)
            rnn.output(tfluid.layers.elementwise_add(xt, noise))
        out = rnn()
    return main, startup, out


@pytest.mark.parametrize("seed", [0, 11])
def test_random_op_in_rnn_step_draws_anew_each_step(seed):
    """Each step's draw differs from every other step's, two runs of one
    program repeat each other, and the draws keep U(0, 1)'s statistics
    (mean 0.5, std 1/sqrt(12), within 5 standard errors over 4096
    values)."""
    b, t, h = 8, 4, 128
    main, startup, out = _noisy_rnn(b, t, h, seed)
    exe = tfluid.Executor("cpu")
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.zeros((b, t, h), np.float32)}
    got, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    again, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    assert got.shape == (b, t, h)
    for i in range(t):
        for j in range(i):
            assert not np.allclose(got[:, i], got[:, j]), (i, j)
    if seed:
        np.testing.assert_array_equal(got, again)
    vals = got.reshape(-1)
    se = (1 / np.sqrt(12)) / np.sqrt(vals.size)
    assert abs(vals.mean() - 0.5) < 5 * se
    assert abs(vals.std() - 1 / np.sqrt(12)) < 0.02
    assert vals.min() >= 0.0 and vals.max() < 1.0


def test_rnn_step_draws_repeat_between_runs_of_one_seed():
    """Two executors on two fresh scopes, one program seed: the same
    draws at every step (the run counter starts from the same place)."""
    b, t, h = 4, 3, 16
    runs = []
    for _ in range(2):
        main, startup, out = _noisy_rnn(b, t, h, 0)
        exe = tfluid.Executor("cpu")
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        runs.append(exe.run(main, feed={"x": np.zeros((b, t, h),
                                                       np.float32)},
                            fetch_list=[out], scope=scope)[0])
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.allclose(runs[0][:, 0], runs[0][:, 1])


# --------------------------------------- outputs that nothing reads (C4) --

_TV, _TT, _TB = 32, 8, 2
_TCFG = dict(n_layer=1, n_head=2, d_key=8, d_value=8, d_model=16,
             d_inner_hid=32, label_smooth_eps=0.1)


def _softmax_names(main):
    return [n for op in main.global_block().ops
            if op.type == "softmax_with_cross_entropy"
            for n in op.outputs["Softmax"]]


def _both_transformers():
    """The small Transformer training program in both packages, the port's
    scope holding the JAX startup's state: (JAX main, JAX scope, JAX
    avg_cost, port main, port scope, port avg_cost)."""
    import paddle_tpu as jfluid
    from paddle_tpu.models import transformer as jtr
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.models import transformer as ttr
    jmain, jstartup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(jmain, jstartup):
        _, javg, _ = jtr.build_train(_TV, _TV, _TT, use_fused_attention=True,
                                     **_TCFG)
    tmain, tstartup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(tmain, tstartup):
        _, tavg, _ = ttr.build_train(_TV, _TV, _TT, use_fused_attention=True,
                                     **_TCFG)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup)
    state = {v.name: np.array(jscope.get(v.name))
             for v in jmain.list_vars() if v.persistable}
    tscope = tio.scope_from_numpy(state, "cpu", program=tmain)
    return jmain, jscope, javg, tmain, tscope, tavg


def _transformer_feed(step):
    from paddle_tpu.models import transformer as jtr
    rng = np.random.RandomState(300 + step)
    src = [rng.randint(3, _TV, rng.randint(3, _TT + 1)).tolist()
           for _ in range(_TB)]
    trg = [rng.randint(3, _TV, rng.randint(3, _TT + 1)).tolist()
           for _ in range(_TB)]
    return jtr.prepare_batch(src, trg, _TT, _TCFG["n_head"], fused=True)


def test_unread_softmax_is_not_built_and_losses_match_jax():
    """A Transformer training step that fetches only the loss leaves no
    Softmax tensor in the run's env or scope, and three steps' losses
    still match the JAX package's (rtol 1e-5: fp32 in another summation
    order, as tests/test_torch_training.py holds twenty)."""
    import paddle_tpu as jfluid
    from paddle_tpu_torch.core import executor as texec
    jmain, jscope, javg, tmain, tscope, tavg = _both_transformers()
    names = _softmax_names(tmain)
    assert names
    envs = []
    run_block = texec.lower_block

    def capture(ctx, block, env):
        envs.append(env)
        run_block(ctx, block, env)

    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), tfluid.Executor("cpu")
    jl, tl = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLAGS_flash_min_seq", "0")
        mp.setenv("PADDLE_TPU_PALLAS", "1")
        mp.setattr(texec, "lower_block", capture)
        for step in range(3):
            feed = _transformer_feed(step)
            with jfluid.scope_guard(jscope):
                jl.append(float(np.asarray(jexe.run(
                    jmain, feed=feed, fetch_list=[javg])[0]).reshape(-1)[0]))
            tl.append(float(texe.run(tmain, feed=feed, fetch_list=[tavg],
                                     scope=tscope)[0].reshape(-1)[0]))
    assert len(envs) == 3
    for env in envs:
        assert not any(n in env.values for n in names)
        assert tavg.name in env.values
    assert not any(tscope.has(n) for n in names)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_fetched_softmax_is_built_and_matches_jax():
    """Fetching the Softmax output of the same program builds it, and it
    equals the JAX package's (rtol = atol = 1e-5), with the loss."""
    import paddle_tpu as jfluid
    jmain, jscope, javg, tmain, tscope, tavg = _both_transformers()
    jname, = _softmax_names(jmain)
    tname, = _softmax_names(tmain)
    feed = _transformer_feed(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLAGS_flash_min_seq", "0")
        mp.setenv("PADDLE_TPU_PALLAS", "1")
        with jfluid.scope_guard(jscope):
            jsm, jloss = jfluid.Executor(jfluid.CPUPlace()).run(
                jmain, feed=feed, fetch_list=[jname, javg])
        tsm, tloss = tfluid.Executor("cpu").run(
            tmain, feed=feed, fetch_list=[tname, tavg], scope=tscope)
    assert tsm.shape == np.asarray(jsm).shape == (_TB * _TT, _TV)
    np.testing.assert_allclose(tsm, np.asarray(jsm), **TOL)
    np.testing.assert_allclose(tsm.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(tloss, np.asarray(jloss), rtol=1e-5)


@pytest.mark.parametrize("soft_label", [False, True])
def test_unread_outputs_names_only_what_nothing_reads(soft_label):
    """lowering.unread_outputs: Softmax unread until it is fetched or an
    op reads it; the loss, read by mean, never; both paths of the rule
    build Softmax only when it is read, and the loss either way."""
    from paddle_tpu_torch.core.lowering import unread_outputs
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[5], dtype="float32")
        lab = tfluid.layers.data(name="lab", shape=[5 if soft_label else 1],
                                 dtype="float32" if soft_label else "int64")
        loss = tfluid.layers.softmax_with_cross_entropy(x, lab, soft_label)
        avg = tfluid.layers.mean(loss)
    sm, = _softmax_names(main)
    assert unread_outputs(main, [avg.name]) >= {sm}
    assert loss.name not in unread_outputs(main, [avg.name])
    assert sm not in unread_outputs(main, [sm])
    rng = np.random.RandomState(31)
    feed = {"x": rng.randn(4, 5).astype(np.float32),
            "lab": (rng.dirichlet(np.ones(5), 4).astype(np.float32)
                    if soft_label else rng.randint(0, 5, (4, 1)))}
    exe = tfluid.Executor("cpu")
    got_sm, got_avg = exe.run(main, feed=feed, fetch_list=[sm, avg])
    only_avg, = exe.run(main, feed=feed, fetch_list=[avg])
    np.testing.assert_allclose(got_sm, torch.softmax(
        torch.from_numpy(feed["x"]), -1).numpy(), **TOL)
    np.testing.assert_array_equal(only_avg, got_avg)


def test_an_output_whose_gradient_is_read_counts_as_read():
    """A grad_of that differentiates through Softmax (its Softmax@GRAD is
    an input) needs the forward's Softmax: calc_gradient from Softmax
    with a random cotangent keeps it out of the unread set, and x's
    gradient equals autograd's through torch.softmax."""
    from paddle_tpu_torch.core.lowering import unread_outputs
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[5], dtype="float32")
        lab = tfluid.layers.data(name="lab", shape=[1], dtype="int64")
        cot = tfluid.layers.data(name="cot", shape=[5], dtype="float32")
        tfluid.layers.softmax_with_cross_entropy(x, lab)
        sm, = _softmax_names(main)
        dx, = tfluid.backward.calc_gradient(
            [main.global_block().var(sm)], [x], target_gradients=[cot])
    assert sm not in unread_outputs(main, [dx.name])
    rng = np.random.RandomState(32)
    feed = {"x": rng.randn(4, 5).astype(np.float32),
            "lab": rng.randint(0, 5, (4, 1)),
            "cot": rng.randn(4, 5).astype(np.float32)}
    got, = tfluid.Executor("cpu").run(main, feed=feed, fetch_list=[dx])
    xt = torch.from_numpy(feed["x"]).requires_grad_(True)
    want, = torch.autograd.grad(torch.softmax(xt, -1), xt,
                                torch.from_numpy(feed["cot"]))
    assert np.abs(want.numpy()).max() > 0.1
    np.testing.assert_allclose(got, want.numpy(), **TOL)


# ------------------------------ unequal query and key lengths (C5) --

_AQ, _AK, _AH, _AD = 5, 7, 2, 8


def _attention_build(causal, with_len):
    """A one-op program: fused_attention of q [B, 5, 2, 8] over k, v [B,
    7, 2, 8] (key lengths fed as [B, 1] int32 when with_len), the loss
    mean(out * w), and q, k, v's gradients through append_backward."""
    def build(fluid):
        q, k, v = (fluid.layers.data(n, shape=[t, _AH, _AD],
                                     dtype="float32")
                   for n, t in (("q", _AQ), ("k", _AK), ("v", _AK)))
        for x in (q, k, v):
            x.stop_gradient = False
        w = fluid.layers.data("w", shape=[_AQ, _AH, _AD], dtype="float32")
        kv_len = fluid.layers.data("kv_len", shape=[1], dtype="int32") \
            if with_len else None
        out = fluid.layers.fused_attention(q, k, v, causal=causal,
                                           kv_len=kv_len)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(out, w))
        fluid.append_backward(loss)
        block = q.block
        return [out, loss] + [block.var(n + "@GRAD") for n in "qkv"]
    return build


def _attention_feed(with_len):
    rng = np.random.RandomState(41)
    feed = {n: rng.randn(2, t, _AH, _AD).astype(np.float32)
            for n, t in (("q", _AQ), ("k", _AK), ("v", _AK), ("w", _AQ))}
    if with_len:
        feed["kv_len"] = np.array([[6], [0]], np.int32)   # ragged and empty
    return feed


@pytest.mark.parametrize("with_len", [False, True], ids=["full", "kv_len"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fused_attention_unequal_lengths_match_jax(causal, with_len):
    """q [2, 5, 2, 8] against k, v [2, 7, 2, 8] through a one-op program
    in both packages: the output [B, Tq, H, D] (also the shape the port's
    build inferred), the loss and the gradients of q, k and v agree with
    the JAX package's within 1e-5; the port never reaches its flash
    kernel's wrapper for such shapes."""
    import paddle_tpu as jfluid
    build, feed = _attention_build(causal, with_len), \
        _attention_feed(with_len)
    jmain, jstartup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(jmain, jstartup):
        jfetch = build(jfluid)
    with jfluid.scope_guard(jfluid.Scope()):
        want = [np.asarray(a) for a in jfluid.Executor(
            jfluid.CPUPlace()).run(jmain, feed=feed, fetch_list=jfetch)]
    tmain, tstartup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(tmain, tstartup):
        tfetch = build(tfluid)
    assert tuple(tfetch[0].shape) == (-1, _AQ, _AH, _AD)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ck.FlashAttention, "apply",
                   lambda *a: calls.append(a) or pytest.fail("flash"))
        got = tfluid.Executor("cpu").run(
            tmain, feed=feed, fetch_list=[v.name for v in tfetch],
            scope=tfluid.Scope())
    assert not calls
    assert got[0].shape == (2, _AQ, _AH, _AD)
    for name, g, w in zip(["out", "loss", "dq", "dk", "dv"], got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    assert np.abs(got[3]).max() > 1e-3      # the gradients are not all 0


def test_unequal_lengths_are_dense_on_every_device(monkeypatch):
    """kernel_config.flash_at's structural rule: q_len != k_len is dense
    on the CPU and on the card, whatever the pin; equal lengths keep the
    flash kernel at the default crossover."""
    from paddle_tpu_torch.ops.kernel_config import flash_at
    monkeypatch.delenv("FLAGS_flash_min_seq", raising=False)
    for dev in ("cpu", "cuda"):
        assert flash_at(5, dev, 7) is False
        assert flash_at(256, dev, 128) is False
        assert flash_at(256, dev, 256) is True
        assert flash_at(256, dev) is True
    monkeypatch.setenv("FLAGS_flash_min_seq", "1024")
    assert flash_at(256, "cuda", 300) is False     # no raise: structural


# ----------------------------------------------- sequence_pool LAST, C8 --

_LAST_LENS = np.array([5, 1, 0, -2, 3], np.int32)   # T = 3: over, in, 0, <0


@pytest.mark.parametrize("op_type,attrs", [
    ("sequence_pool", {"pooltype": "LAST"}),
    ("sequence_last_step", {})], ids=["pool_last", "last_step"])
@pytest.mark.parametrize("feat", [(), (2,), (2, 3)], ids=["2d", "3d", "4d"])
def test_last_step_past_t_gives_nan_rows_like_take_along_axis(op_type, attrs,
                                                             feat):
    """x [5, 3, *feat] with lengths [5, 1, 0, -2, 3]: the row of length 5
    is NaN in both packages, the others pick step min(max(len - 1, 0),
    2); values compared with NaN equal to NaN, exactly. The ROADMAP's
    example (x [2, 3, 2], lengths [5, 1]) is the first two rows' case."""
    rng = np.random.RandomState(61)
    x = rng.randn(5, 3, *feat).astype(np.float32)
    ins = {"X": [x], "XLen": [_LAST_LENS]}
    want = np.asarray(_jax_rule(op_type, ins, attrs)["Out"][0])
    got = _port_rule(op_type, ins, attrs)["Out"][0].numpy()
    assert got.shape == want.shape == (5,) + feat
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[0]).all() and not np.isnan(got[1:]).any()
    np.testing.assert_array_equal(got[2], x[2, 0])


def test_last_step_past_t_gets_no_gradient():
    """d x of sum(out * g) over the rows that are not NaN: the same in
    both packages, and the NaN row adds nothing (its x rows stay 0)."""
    rng = np.random.RandomState(62)
    x = rng.randn(5, 3, 2).astype(np.float32)
    g = rng.randn(5, 2).astype(np.float32)
    keep = _LAST_LENS <= 3

    def jloss(xj):
        out = _jax_rule("sequence_pool", {"X": [xj], "XLen": [_LAST_LENS]},
                        {"pooltype": "LAST"})["Out"][0]
        return jnp.sum(jnp.where(keep[:, None], out * g, 0.0))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = treg.get("sequence_pool").lower(
        TorchCtx(None, CPU), {"X": [xt], "XLen": [torch.from_numpy(
            _LAST_LENS)]}, {"pooltype": "LAST"})["Out"][0]
    torch.where(torch.from_numpy(keep)[:, None], out * torch.from_numpy(g),
                torch.zeros(())).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    assert not xt.grad[0].any()


# ---------------------------------------- fused_attention empty rows, C9 --

def _empty_row_attention(t, causal):
    """q, k, v [2, t, 2, 4] and key lengths [0, t - 3]: row 0 has no valid
    key."""
    rng = np.random.RandomState(63 + t)
    q, k, v = (rng.randn(2, t, 2, 4).astype(np.float32) for _ in range(3))
    ins = {"Q": [q], "K": [k], "V": [v],
           "KVLen": [np.array([[0], [t - 3]], np.int32)]}
    return ins, {"causal": causal, "scale": None}


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("t", [8, 1024])
def test_fused_attention_empty_row_matches_jax(monkeypatch, t, causal):
    """At the JAX package's default crossover (FLAGS_flash_min_seq unset):
    T = 8 is its dense path (row 0 the mean of v), T = 1024 its flash
    kernel in interpret mode (row 0 exactly 0). The port takes its flash
    path at both; values and q, k, v's gradients of sum(out * g) agree
    within 1e-5."""
    monkeypatch.delenv("FLAGS_flash_min_seq", raising=False)
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "1")
    ins, attrs = _empty_row_attention(t, causal)
    g = np.random.RandomState(64).randn(2, t, 2, 4).astype(np.float32)

    def jout(q, k, v):
        jins = dict(ins, Q=[q], K=[k], V=[v])
        return _jax_rule("fused_attention", jins, attrs)["Out"][0]

    want, vjp = jax.vjp(jout, *(jnp.asarray(ins[s][0]) for s in "QKV"))
    want_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(ins[s][0]).requires_grad_(True)
              for s in "QKV"]
    tins = {"Q": [leaves[0]], "K": [leaves[1]], "V": [leaves[2]],
            "KVLen": [torch.from_numpy(ins["KVLen"][0])]}
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        apply = ck.FlashAttention.apply
        mp.setattr(ck.FlashAttention, "apply",
                   lambda *a: calls.append(1) or apply(*a))
        got = treg.get("fused_attention").lower(
            TorchCtx(None, CPU), tins, attrs)["Out"][0]
    assert calls                            # the port's flash path
    got_grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    expect_row0 = ins["V"][0][0].mean(axis=0) if t < 1024 else 0.0
    np.testing.assert_allclose(want[0], np.broadcast_to(
        expect_row0, want[0].shape), **TOL)
    for name, a, b in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


def test_fused_attention_empty_row_follows_the_pin(monkeypatch):
    """FLAGS_flash_min_seq=0 sends the JAX package to its flash kernel at
    T = 8 too: both give 0 on the empty row there."""
    monkeypatch.setenv("FLAGS_flash_min_seq", "0")
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "1")
    ins, attrs = _empty_row_attention(8, False)
    want = np.asarray(_jax_rule("fused_attention", ins, attrs)["Out"][0])
    got = _port_rule("fused_attention", ins, attrs)["Out"][0].numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[0].any()


# ------------------------------------------------------------ topk (C12) --

def _nan_row():
    row = np.array([[1.0, np.nan, 3.0, 3.0, np.nan, 2.0, 0.0, -0.0, np.inf,
                     -np.inf]], np.float32)
    row[0, 4] = -row[0, 4]      # a NaN with its sign bit set
    return row


@pytest.mark.parametrize("x, k", [
    (np.array([[1, 3, 3, 2, 3]], np.float32), 3),
    (np.zeros((1, 40), np.float32), 1),
    (_nan_row(), 10),
    (np.random.RandomState(5).randint(0, 3, (6, 9)).astype(np.float32), 4),
], ids=["ties", "zeros", "nan", "small-ints"])
def test_topk_orders_ties_as_lax_top_k(x, k):
    """The lower index first among equal values; NaN, signed zeros and
    infinities where lax.top_k puts them."""
    jout, tout = _run_both("topk", {"X": [x]}, {"k": k})
    for slot in ("Out", "Indices"):
        np.testing.assert_array_equal(tout[slot][0], jout[slot][0],
                                      err_msg=slot)
    assert tout["Indices"][0].dtype == np.int64


def test_accuracy_on_a_uniform_row_matches_jax():
    """A uniform [4, 10] input with label 0: topk's first index is 0 in
    both packages, so accuracy is 1.0 in both (the port gave 0.0)."""
    x = np.full((4, 10), 0.1, np.float32)
    label = np.zeros((4, 1), np.int64)
    for k in (1, 3):
        jtop, ttop = _run_both("topk", {"X": [x]}, {"k": k})
        ins = {"Indices": [jtop["Indices"][0]], "Label": [label]}
        jacc, _ = _run_both("accuracy", ins, {})
        _, tacc = _run_both("accuracy", dict(
            ins, Indices=[ttop["Indices"][0]]), {})
        for slot in ("Accuracy", "Correct", "Total"):
            np.testing.assert_array_equal(tacc[slot][0], jacc[slot][0],
                                          err_msg=slot)
        assert float(tacc["Accuracy"][0][0]) == 1.0


# ------------------------------------------------ warpctc, edit_distance --

def _ctc_fault_case(labels=None, label_len=(3, 2, 1)):
    """B 3, T 6, C 5, U 3, blank 0, XLen 6 (seed 0)."""
    rng = np.random.RandomState(0)
    label = rng.randint(1, 5, (3, 3)).astype(np.int64) if labels is None \
        else np.asarray(labels, np.int64)
    return {"Logits": [rng.randn(3, 6, 5).astype(np.float32)],
            "Label": [label[:, :, None]],
            "XLen": [np.full((3,), 6, np.int32)],
            "LabelLen": [np.asarray(label_len, np.int32)]}


C14_CASES = {
    "label_len_above_u": dict(label_len=(4, 2, 7)),
    "label_len_negative": dict(label_len=(1, -1, 2)),
    "label_len_minus_two": dict(label_len=(-2, 3, 3)),
    "label_at_or_above_c": dict(labels=[[1, 2, 3], [7, 1, 2], [5, 5, 1]]),
    "label_below_minus_c": dict(labels=[[-6, 1, 2], [1, 2, 3], [2, 3, 4]]),
    "label_negative_wraps": dict(labels=[[-1, 2, 3], [1, -2, 3], [4, 3, -1]]),
}


@pytest.mark.parametrize("case", sorted(C14_CASES))
def test_warpctc_out_of_range_matches_take_along_axis(case):
    ins = _ctc_fault_case(**C14_CASES[case])
    jout, tout = _run_both("warpctc", ins, {"blank": 0})
    want, got = jout["Loss"][0], tout["Loss"][0]
    assert np.array_equal(np.isnan(got), np.isnan(want)), (got, want)
    np.testing.assert_allclose(got, want, **TOL)
    tgot, twant = _grads_both("warpctc", ins, {"blank": 0}, ["Loss"], seed=1)
    np.testing.assert_allclose(tgot[("Logits", 0)], twant[("Logits", 0)],
                               **TOL)


def test_warpctc_cases_measured_at_discovery():
    """The two cases measured when C14 was found: NaN past U, a wrapped
    end state for LabelLen -1."""
    for lens, nan_rows in (((4, 2, 7), [True, False, True]),
                           ((1, -1, 2), [False, False, False])):
        ins = _ctc_fault_case(label_len=lens)
        jout, tout = _run_both("warpctc", ins, {"blank": 0})
        got = tout["Loss"][0][:, 0]
        assert list(np.isnan(got)) == nan_rows
        np.testing.assert_allclose(got, jout["Loss"][0][:, 0], **TOL)


def _edit_case(hlen, rlen):
    return {"Hyps": [np.array([[1, 2, 3, 4], [2, 3, 4, 5]], np.int64)],
            "Refs": [np.array([[1, 2, 4, 0], [2, 2, 2, 2]], np.int64)],
            "HypsLen": [np.asarray(hlen, np.int64)],
            "RefsLen": [np.asarray(rlen, np.int64)]}


C15_CASES = {"hyps_len_above_u": ((5, 4), (4, 4)),
             "refs_len_above_u": ((4, 4), (3, 5)),
             "negative_lengths_wrap": ((-1, 4), (4, -2)),
             "minus_n_wraps_to_zero": ((-5, 2), (-5, 1)),
             "below_minus_n": ((-6, 4), (4, -7)),
             "in_range": ((3, 4), (3, 4))}


@pytest.mark.parametrize("normalized", [False, True],
                         ids=["raw", "normalized"])
@pytest.mark.parametrize("case", sorted(C15_CASES))
def test_edit_distance_out_of_range_matches_take_along_axis(case,
                                                            normalized):
    hlen, rlen = C15_CASES[case]
    jout, tout = _run_both("edit_distance", _edit_case(hlen, rlen),
                           {"normalized": normalized})
    np.testing.assert_array_equal(tout["Out"][0], jout["Out"][0])
    np.testing.assert_array_equal(tout["SequenceNum"][0],
                                  jout["SequenceNum"][0])


def test_edit_distance_cases_measured_at_discovery():
    """The cases measured when C15 was found, not normalized: NaN for a
    length past the table; -1 and -2 wrap to the last row and column."""
    cases = (((5, 4), (4, 4), [True, False]), ((4, 4), (5, 4), [True, False]),
             ((-1, 4), (4, -2), [False, False]))
    for hlen, rlen, nan_rows in cases:
        jout, tout = _run_both("edit_distance", _edit_case(hlen, rlen),
                               {"normalized": False})
        got = tout["Out"][0][:, 0]
        assert list(np.isnan(got)) == nan_rows
        np.testing.assert_array_equal(got, jout["Out"][0][:, 0])
