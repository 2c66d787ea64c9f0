"""The port's LSTMP slice (dynamic_lstmp, the lstmp rule, K7's plain
version and its autograd Function, a stacked-LSTMP acoustic model) against
the JAX package on the CPU.

Kernel level: the same inputs, made with numpy from a seed (batch 4,
lengths 1-9 with a length-1 and a full row, D 5-8, P 3-4), go through the
port's fused_lstmp_plain / FusedLSTMP / fused_lstmp_bwd and the JAX
package's fused_lstmp (its Pallas kernel in interpret mode) and jax.vjp
of it. Program level: both packages build the same programs from the
same layer calls; the JAX package runs its startup program and every
persistable is carried into the port with io.scope_from_numpy. The JAX
package runs its fused LSTMP kernel in interpret mode
(PADDLE_TPU_PALLAS=lstm) and its lax.scan path (PADDLE_TPU_PALLAS=0),
which round differently on some machines, so the port is held against
each with a tolerance, never bit for bit.

The acoustic model is PaddlePaddle's DeepASR stacked_lstmp_model cut to
size: 2 layers of fc(4D) + dynamic_lstmp(D 5, P 3, no peepholes), a
per-frame softmax over 7 classes, cross_entropy and the length-masked
mean (models/common.masked_mean_cost), frame width 6.

Tolerances: rtol = atol = 1e-5 on forward values and gradients — fp32 on
both sides, summed in another order, over at most 16 steps. The 20 Adam
steps: every loss within 1e-4 relative, the parameters and moments after
20 steps within 2 * (the sum of the steps' learning rates) elementwise
with at most 0.1% of the elements more than 1e-4 apart (Adam moves a
parameter by about lr whatever the size of its gradient, so a near-zero
gradient of the other sign can move it the other way on any step).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import serving as jserving
from paddle_tpu.core import program_desc as jdesc
from paddle_tpu.core.lod import LoDTensor as JLoDTensor
from paddle_tpu.models import common as jcommon
from paddle_tpu.ops import pallas_kernels as pk

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import program_desc as tdesc
from paddle_tpu_torch.core.lod import LoDTensor as TLoDTensor
from paddle_tpu_torch.models import common as tcommon
from paddle_tpu_torch.ops import cuda_kernels as ck
from paddle_tpu_torch.serving import InferenceEngine

TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, FRAME, HID, PROJ, LAYERS, CLASSES = 4, 6, 5, 3, 2, 7
STEPS, LR = 20, 0.01
PARAM_ATOL = 2 * STEPS * LR
PARAM_CLOSE, PARAM_FAR_SHARE = 1e-4, 1e-3
FUSED, UNFUSED = "lstm", "0"
_PKG = {"jax": (jfluid, JLoDTensor, jcommon),
        "port": (tfluid, TLoDTensor, tcommon)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: one intra-op thread does, and leaves the other
    test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# ------------------------------------------------------------ the kernel --

def _lstmp_inputs(b=4, t=9, d=8, p=4, seed=51, state=True):
    """x [B, T, 4D], w [P, 4D], w_proj [D, P], bias, optional r0 [B, P]
    and c0 [B, D], and ragged lengths with a full and a length-1 row."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, t, 4 * d) * 0.4).astype(np.float32)
    w = (rng.randn(p, 4 * d) * 0.3).astype(np.float32)
    w_proj = (rng.randn(d, p) * 0.3).astype(np.float32)
    bias = (rng.randn(4 * d) * 0.1).astype(np.float32)
    r0 = np.tanh(rng.randn(b, p) * 0.3).astype(np.float32) if state else None
    c0 = (rng.randn(b, d) * 0.2).astype(np.float32) if state else None
    lens = rng.randint(1, t + 1, size=b).astype(np.int32)
    lens[0], lens[-1] = t, 1
    return x, w, w_proj, bias, r0, c0, lens


def _jax_lstmp(x, w, w_proj, bias, r0, c0, lens, reverse):
    """The JAX fused_lstmp (Pallas kernel, interpret mode). It takes r0
    always: zeros stand for None, as its lstmp rule passes them."""
    if r0 is None:
        r0 = np.zeros((x.shape[0], w_proj.shape[1]), np.float32)
    return pk.fused_lstmp(_j(x), _j(w), _j(w_proj), _j(bias), _j(r0),
                          _j(c0), jnp.asarray(lens), reverse=reverse,
                          interpret=True)


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_fused_lstmp_plain_matches_jax_kernel(reverse, state):
    """K7's plain version against the JAX fused_lstmp: projection and
    cell, forward and reverse, ragged lengths with 1 and T, zero and given
    initial states."""
    x, w, wp, bias, r0, c0, lens = _lstmp_inputs(state=state)
    proj, cell = ck.fused_lstmp_plain(_t(x), _t(w), _t(wp), _t(bias),
                                      _t(r0), _t(c0), _t(lens), reverse)
    jp, jc = _jax_lstmp(x, w, wp, bias, r0, c0, lens, reverse)
    assert proj.shape == (4, 9, 4) and cell.shape == (4, 9, 8)
    np.testing.assert_allclose(proj.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(cell.numpy(), np.asarray(jc), **TOL)
    # the length-1 row: the padding steps carry the state of its one
    # valid step (forward) or the initial state (reverse, where they come
    # first)
    if not reverse:
        assert np.all(proj.numpy()[-1, 1:] == proj.numpy()[-1, :1])
    elif state:
        assert np.all(proj.numpy()[-1, 1:] == r0[-1])


@pytest.mark.parametrize("reverse", [False, True])
def test_fused_lstmp_function_backward_matches_jax_custom_vjp(reverse):
    """FusedLSTMP (forward K7, backward the saved-state reverse scan in
    torch) against jax.vjp of the JAX fused_lstmp (_lstmp_seq_core_bwd):
    dx, dw, dw_proj, db, dr0, dc0 from random projection and cell
    gradients."""
    x, w, wp, bias, r0, c0, lens = _lstmp_inputs(d=5, p=3, seed=52)
    rng = np.random.RandomState(4)
    gp = rng.randn(*x.shape[:2], wp.shape[1]).astype(np.float32)
    gc = rng.randn(*x.shape[:2], wp.shape[0]).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, w, wp, bias, r0, c0)]
    proj, cell = ck.FusedLSTMP.apply(*leaves, torch.from_numpy(lens),
                                     reverse)
    got = torch.autograd.grad((proj, cell), leaves,
                              (torch.from_numpy(gp), torch.from_numpy(gc)))
    _, vjp = jax.vjp(lambda *a: pk.fused_lstmp(
        *a, jnp.asarray(lens), reverse=reverse, interpret=True),
        *(jnp.asarray(a) for a in (x, w, wp, bias, r0, c0)))
    want = vjp((jnp.asarray(gp), jnp.asarray(gc)))
    for name, a, b in zip(("dx", "dw", "dw_proj", "db", "dr0", "dc0"), got,
                          want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
    # padding steps of x get exactly zero gradient
    assert np.all(got[0].numpy()[-1, 1:] == 0.0)


@pytest.mark.parametrize("reverse", [False, True])
def test_fused_lstmp_backward_matches_autograd_of_the_plain_loop(reverse):
    """fused_lstmp_bwd against torch.autograd through fused_lstmp_plain's
    own loop, with only the projection gradient given (the cell is unread,
    as in a stack of LSTMP layers)."""
    x, w, wp, bias, r0, c0, lens = _lstmp_inputs(seed=53)
    g = np.random.RandomState(8).randn(4, 9, 4).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, w, wp, bias, r0, c0)]
    proj, _ = ck.fused_lstmp_plain(*leaves, torch.from_numpy(lens), reverse)
    want = torch.autograd.grad(proj, leaves, torch.from_numpy(g))
    args = [torch.from_numpy(a) for a in (x, w, wp, bias, r0, c0)]
    proj, cell = ck.fused_lstmp_plain(*args, torch.from_numpy(lens), reverse)
    got = ck.fused_lstmp_bwd(*args, torch.from_numpy(lens), proj, cell,
                             torch.from_numpy(g), None, reverse)
    for name, a, b in zip(("dx", "dw", "dw_proj", "db", "dr0", "dc0"), got,
                          want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **TOL)


def test_fused_lstmp_wrapper_dispatches_by_device():
    """A CPU tensor takes the plain version and launches nothing, a strided
    x is read as it lies, a meta tensor gives shapes, and a bad shape
    raises."""
    ck.reset_launch_counts()
    x, w, wp, bias, r0, c0, lens = _lstmp_inputs()
    args = [_t(a) for a in (x, w, wp, bias, r0, c0, lens)]
    for got, want in zip(ck.fused_lstmp(*args, reverse=True),
                         ck.fused_lstmp_plain(*args, reverse=True)):
        assert torch.equal(got, want)
    wide = torch.from_numpy(np.concatenate([x, x], axis=1))[:, ::2]
    assert wide.stride(2) == 1
    for got, want in zip(
            ck.fused_lstmp(torch.from_numpy(np.ascontiguousarray(
                wide.numpy())), *args[1:]),
            ck.fused_lstmp(wide, *args[1:])):
        assert torch.equal(got, want)
    mx = torch.empty((1021, 1021, 4096), device="meta")
    proj, cell = ck.fused_lstmp(
        mx, torch.empty((512, 4096), device="meta"),
        torch.empty((1024, 512), device="meta"),
        torch.empty(4096, device="meta"),
        lens=torch.empty(1021, dtype=torch.int32, device="meta"))
    assert proj.shape == (1021, 1021, 512) and cell.shape == (1021, 1021,
                                                              1024)
    assert proj.device.type == "meta"
    assert ck.launch_counts()["fused_lstmp"] == 0
    assert sum(ck.launch_counts().values()) == 0
    with pytest.raises(ValueError, match="4D"):
        ck.fused_lstmp(torch.zeros(2, 3, 10), torch.zeros(2, 8),
                       torch.zeros(2, 2), torch.zeros(8))
    with pytest.raises(ValueError, match="w_proj \\[D, P\\]"):
        ck.fused_lstmp(torch.zeros(2, 3, 8), torch.zeros(2, 8),
                       torch.zeros(3, 2), torch.zeros(8))
    with pytest.raises(ValueError, match="w \\[P, 4D\\]"):
        ck.fused_lstmp(torch.zeros(2, 3, 8), torch.zeros(3, 8),
                       torch.zeros(2, 2), torch.zeros(8))
    with pytest.raises(ValueError, match="r0"):
        ck.fused_lstmp(torch.zeros(2, 3, 8), torch.zeros(2, 8),
                       torch.zeros(2, 2), torch.zeros(8),
                       r0=torch.zeros(2, 3))


def _split_covers(ranges, n):
    """The ranges are [j n / G, (j + 1) n / G): they tile [0, n) in order
    with no gap or overlap, and their sizes differ by at most one."""
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0 and a0 <= a1
    sizes = [hi - lo for lo, hi in ranges]
    assert max(sizes) - min(sizes) <= 1
    return max(sizes)


def _plan_words(bsz, d, p, plan):
    """K7's shared memory in 4-byte words, region by region as the kernel
    lays it out (csrc/fused_lstmp_fwd.cu), written out independently of
    cuda_kernels._lstmp_smem_floats."""
    up4 = lambda v: -(-v // 4) * 4                       # noqa: E731
    ku, kp, tile = plan["ku"], plan["kp"], plan["row_tile"]
    words = 0
    if plan["resident"]:
        words += up4(p) * 4 * ku                 # W slices [Pp][4 ku]
        words += up4(d) * up4(kp)                # W_proj slices [Dp][kp4]
    # phase A's r_prev^T row tile, partial sums (8 x 4 a thread) and
    # their sums, then phase B's rows of h
    words += max(up4(p) * tile + plan["threads"] * 8 * 4 + tile * 4 * ku,
                 plan["h_rows"] * up4(d) + plan["threads"])
    if plan["prefetch"]:
        words += up4(2 * bsz * 4 * ku)           # x of two steps
    return words + up4(bsz * ku) + up4(bsz * kp) + bsz


@pytest.mark.parametrize("sm", [132, 114])
@pytest.mark.parametrize("bsz", [1, 8, 32])
def test_lstmp_launch_plan_deepasr_widths(sm, bsz):
    """D 1024 / P 512 (DeepASR): one block per SM, every block owns 7-9
    hidden units and 3-5 projection columns, both weight slices resident
    (64-72 KB + 16-20 KB) with the whole batch in one row tile, within
    the 227 KB a Hopper block may use."""
    plan = ck.lstmp_launch_plan(bsz, 1024, 512, sm)
    assert plan["grid"] == sm and plan["threads"] == 256
    assert plan["ku"] == _split_covers(plan["units"], 1024) == -(-1024 // sm)
    assert plan["kp"] == _split_covers(plan["cols"], 512) == -(-512 // sm)
    assert plan["resident"] and plan["prefetch"]
    assert plan["row_tile"] == plan["b_pad"] == -(-bsz // 8) * 8
    assert plan["smem"] == 4 * _plan_words(bsz, 1024, 512, plan)
    assert plan["smem"] <= ck.LSTMP_SMEM_LIMIT
    # the barrier's counter, r^T [512, b_pad] and h [B, 1024]
    assert plan["scratch"] == 4 + 512 * plan["b_pad"] + bsz * 1024
    # the whole batch's h_new in one tile, but for 27 rows at 114 SMs
    assert plan["h_rows"] == (27 if (sm, bsz) == (114, 32) else bsz)
    if (sm, bsz) == (132, 8):
        # W 512 x 32 + W_proj 1024 x 4 + r^T 512 x 8 + partial sums 256 x
        # 32 + their sums 8 x 32 + x 2 x 8 x 32 + c 8 x 8 + r 8 x 4 + lens
        # 8 words
        assert plan["smem"] == 4 * 33640


def test_lstmp_launch_plan_small_widths():
    """Hidden 8 / proj 4 (the card-vs-CPU step): 8 blocks, one unit each;
    four of them own one projection column and four own none."""
    plan = ck.lstmp_launch_plan(4, 8, 4, 132)
    assert plan["grid"] == 8 and (plan["ku"], plan["kp"]) == (1, 1)
    assert plan["units"] == [(j, j + 1) for j in range(8)]
    sizes = [hi - lo for lo, hi in plan["cols"]]
    assert sorted(sizes) == [0] * 4 + [1] * 4
    _split_covers(plan["cols"], 4)
    assert plan["resident"] and plan["row_tile"] == plan["b_pad"] == 8
    assert plan["h_rows"] == 4
    assert plan["smem"] == 4 * _plan_words(4, 8, 4, plan)


@pytest.mark.parametrize("d,p,sm", [(1000, 500, 132), (37, 21, 5),
                                    (130, 3, 132), (3, 130, 132)])
def test_lstmp_launch_plan_ragged_slices(d, p, sm):
    """D and P not multiples of the grid (and D < G or P < G): the balanced
    split still tiles both, each block owning floor or ceil of D / G."""
    plan = ck.lstmp_launch_plan(32, d, p, sm)
    assert plan["grid"] == min(sm, max(d, p))
    assert plan["ku"] == _split_covers(plan["units"], d)
    assert plan["kp"] == _split_covers(plan["cols"], p)
    assert plan["smem"] == 4 * _plan_words(32, d, p, plan)
    assert plan["smem"] <= ck.LSTMP_SMEM_LIMIT


def test_lstmp_launch_plan_falls_back_within_the_kernel():
    """Where the slices or the batch's buffers crowd shared memory, the
    plan keeps the same kernel: a smaller row tile, then no x prefetch,
    then weights read from L2 at every step; past that it raises rather
    than running anything else."""
    plan = ck.lstmp_launch_plan(256, 1024, 512, 132)
    assert plan["resident"] and plan["prefetch"] and plan["row_tile"] < 256
    plan = ck.lstmp_launch_plan(1024, 1024, 512, 132)
    assert plan["resident"] and not plan["prefetch"]
    assert plan["b_pad"] % plan["row_tile"] == 0 and plan["b_pad"] >= 1024
    plan = ck.lstmp_launch_plan(32, 4096, 2048, 132)
    assert not plan["resident"] and plan["ku"] == 32
    for bsz, d, p in ((256, 1024, 512), (1024, 1024, 512),
                      (32, 4096, 2048)):
        plan = ck.lstmp_launch_plan(bsz, d, p, 132)
        # every thread gets at least one 8 x 4 tile of a row tile
        assert plan["row_tile"] // 8 * plan["ku"] <= plan["threads"]
        assert 1 <= plan["h_rows"] <= min(bsz - 1, 64)
        assert plan["smem"] == 4 * _plan_words(bsz, d, p, plan)
        assert plan["smem"] <= ck.LSTMP_SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        ck.lstmp_launch_plan(8192, 1024, 512, 132)
    with pytest.raises(ValueError, match="positive"):
        ck.lstmp_launch_plan(8, 1024, 512, 0)


# ----------------------------------------------------------- the lstmp rule --

def _lengths(seed):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, 10, size=BATCH)
    lens[0], lens[-1] = 9, 1
    return lens


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


def _jax_fetch(build, feed, pallas, state=None):
    """One run of a fresh JAX build under PADDLE_TPU_PALLAS=pallas:
    (startup state, fetches)."""
    main, startup, fetch = _build(jfluid, build)
    exe, scope, start = _jax_state(main, startup)
    if state is not None:
        for name, arr in state.items():
            scope.set(name, arr)
    with jfluid.scope_guard(scope), pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_PALLAS", pallas)
        out = exe.run(main, feed=feed("jax"), fetch_list=fetch)
    return start, [np.asarray(o) for o in out]


def _compare(build, feed, paths=(FUSED, UNFUSED)):
    """The port's fetches against the JAX package's under each kernel
    setting in `paths`, from the same startup state."""
    state, want = _jax_fetch(build, feed, paths[0])
    main, _, fetch = _build(tfluid, build)
    scope = tio.scope_from_numpy(state, "cpu", program=main)
    got = tfluid.Executor("cpu").run(main, feed=feed("port"),
                                     fetch_list=[v.name for v in fetch],
                                     scope=scope)
    for pallas in paths:
        if pallas != paths[0]:
            _, want = _jax_fetch(build, feed, pallas, state)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape, (pallas, i)
            np.testing.assert_allclose(g, w, err_msg="%s fetch %d"
                                       % (pallas, i), **TOL)
    return got


def _lstmp_build(with_state=False, **kw):
    """dynamic_lstmp on a [B, T, 4D] LoD input (D 5, P 3), optionally with
    h_0 and c_0 fed as dense [B, D] data, and the input's gradient through
    a mean of the squared projection (append_backward)."""
    def build(fluid):
        x = fluid.layers.data("x", shape=[4 * HID], dtype="float32",
                              lod_level=1)
        x.stop_gradient = False
        extra = {}
        if with_state:
            extra = dict(
                h_0=fluid.layers.data("h0", shape=[HID], dtype="float32"),
                c_0=fluid.layers.data("c0", shape=[HID], dtype="float32"))
        proj, cell = fluid.layers.dynamic_lstmp(
            input=x, size=4 * HID, proj_size=PROJ, **dict(kw, **extra))
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(proj, proj))
        fluid.append_backward(loss)
        return [proj, cell, loss, x.block.var("x@GRAD")]
    return build


def _lstmp_feed(seed, with_state=False):
    seqs = {"x": _float_seqs(seed, 4 * HID)}
    dense = None
    if with_state:
        rng = np.random.RandomState(seed + 7)
        dense = {"h0": (rng.randn(BATCH, HID) * 0.3).astype("float32"),
                 "c0": (rng.randn(BATCH, HID) * 0.3).astype("float32")}
    return lambda pkg: _feed(pkg, seqs, dense)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstmp_rule_matches_the_jax_package(reverse, with_state):
    """dynamic_lstmp without peepholes (the K7 configuration): projection,
    cell, loss and the input's gradient against the JAX fused kernel and
    its lax.scan path, with zero and with fed initial states (h_0 enters
    through tanh(h_0 @ ProjWeight), whose gradient flows too)."""
    got = _compare(_lstmp_build(with_state, use_peepholes=False,
                                is_reverse=reverse),
                   _lstmp_feed(60, with_state))
    assert got[0].shape[0] == BATCH and got[0].shape[2] == PROJ


@pytest.mark.parametrize("kw", [
    dict(use_peepholes=True),
    dict(use_peepholes=True, is_reverse=True),
    dict(use_peepholes=False, proj_activation="relu"),
    dict(use_peepholes=False, cell_activation="sigmoid",
         candidate_activation="relu"),
    dict(use_peepholes=False, gate_activation="tanh", is_reverse=True)],
    ids=["peepholes", "peepholes-reverse", "proj-relu", "cell-sigmoid",
         "gate-tanh-reverse"])
def test_lstmp_rule_torch_loop_matches_the_jax_scan(kw):
    """Peepholes or a non-default activation: the port's torch loop
    against the JAX lax.scan path, the only path either package has for
    them (with h_0 and c_0 fed)."""
    _compare(_lstmp_build(True, **kw), _lstmp_feed(61, True),
             paths=(UNFUSED,))


def test_lstmp_rule_takes_the_kernel_only_in_its_configuration(monkeypatch):
    """The no-peephole fp32 LSTMP with default activations goes through the
    K7 wrapper (its plain version, on the CPU); peepholes or another
    projection activation run the torch loop and never reach it."""
    calls = []
    real = ck.fused_lstmp

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(ck, "fused_lstmp", spy)
    feed = _lstmp_feed(62)("port")
    for kw, expect in ((dict(use_peepholes=False), 1),
                       (dict(use_peepholes=True), 0),
                       (dict(use_peepholes=False, proj_activation="relu"),
                        0)):
        main, startup, fetch = _build(tfluid, _lstmp_build(**kw))
        exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
        exe.run(startup, scope=scope)
        del calls[:]         # build-time shape inference ran on meta
        exe.run(main, feed=feed, fetch_list=fetch[:2], scope=scope)
        assert len(calls) == expect, kw


def test_lstmp_program_matches_the_jax_one():
    """dynamic_lstmp emits the same op, slots, attrs and parameters (shapes
    [P, 4D], [D, P], [1, 7D]) in both packages, with param_attr given as a
    [weight, projection] pair."""
    def build(fluid):
        x = fluid.layers.data("x", shape=[4 * HID], dtype="float32",
                              lod_level=1)
        proj, _ = fluid.layers.dynamic_lstmp(
            input=x, size=4 * HID, proj_size=PROJ,
            param_attr=[fluid.ParamAttr(name="lstmp_w"),
                        fluid.ParamAttr(name="lstmp_wp")])
        return [proj]

    jmain, _, _ = _build(jfluid, build)
    tmain, _, _ = _build(tfluid, build)
    assert json.loads(tdesc.program_to_bytes(tmain)) == \
        json.loads(jdesc.program_to_bytes(jmain))
    shapes = {p.name: tuple(p.shape) for p in tmain.all_parameters()}
    assert shapes["lstmp_w"] == (PROJ, 4 * HID)
    assert shapes["lstmp_wp"] == (HID, PROJ)
    assert (1, 7 * HID) in shapes.values()


# ----------------------------------------------- the acoustic model --

def stacked_lstmp_net(fluid, frames, hidden, proj, layers, classes):
    """DeepASR's stacked_lstmp_model (PaddlePaddle/models, fluid/DeepASR/
    model_utils/model.py) without its batch_norm layers and with
    use_peepholes=False: fc(4 * hidden) + dynamic_lstmp per layer, each
    with its bias, then a per-frame softmax."""
    x = frames
    for _ in range(layers):
        fc = fluid.layers.fc(input=x, size=hidden * 4)
        x, _ = fluid.layers.dynamic_lstmp(
            input=fc, size=hidden * 4, proj_size=proj, use_peepholes=False,
            cell_activation="tanh", proj_activation="tanh")
    return fluid.layers.fc(input=x, size=classes, act="softmax")


def _acoustic_build(train):
    def build(fluid):
        frames = fluid.layers.data("frames", shape=[FRAME], dtype="float32",
                                   lod_level=1)
        pred = stacked_lstmp_net(fluid, frames, HID, PROJ, LAYERS, CLASSES)
        if not train:
            return [pred]
        label = fluid.layers.data("label", shape=[1], dtype="int64",
                                  lod_level=1)
        common = jcommon if fluid is jfluid else tcommon
        cost = fluid.layers.cross_entropy(input=pred, label=label)
        avg_cost = common.masked_mean_cost(cost, label, pred)
        fluid.optimizer.Adam(learning_rate=LR).minimize(avg_cost)
        return [avg_cost, pred]
    return build


def _acoustic_feed(seed, train=True):
    frames = _float_seqs(seed, FRAME)
    rng = np.random.RandomState(seed + 3)
    labels = [rng.randint(0, CLASSES, (len(f), 1)).astype("int64")
              for f in frames]
    seqs = {"frames": frames, "label": labels} if train \
        else {"frames": frames}
    return lambda pkg: _feed(pkg, seqs)


def test_acoustic_forward_matches_the_jax_package():
    """The 2-layer stacked-LSTMP acoustic model, forward: per-frame
    posteriors against both JAX paths (two K7 recurrences), each frame's
    summing to 1."""
    got = _compare(_acoustic_build(False), _acoustic_feed(70, False))
    assert got[0].shape[0] == BATCH and got[0].shape[2] == CLASSES
    np.testing.assert_allclose(got[0].sum(axis=-1), 1.0, rtol=1e-6)


@pytest.fixture(scope="module")
def train_runs():
    """20 Adam steps of the acoustic model on one batch in both packages
    from the JAX startup state (the JAX package on its fused kernel)."""
    build = _acoustic_build(True)
    jmain, jstartup, jfetch = _build(jfluid, build)
    tmain, _, tfetch = _build(tfluid, build)
    jexe, jscope, state = _jax_state(jmain, jstartup)
    tscope = tio.scope_from_numpy(state, "cpu", program=tmain)
    texe = tfluid.Executor("cpu")
    grads = sorted(p.name + "@GRAD" for p in tmain.all_parameters())
    feed = _acoustic_feed(80)
    jl, tl, jg, tg = [], [], None, None
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_PALLAS", FUSED)
        for step in range(STEPS):
            extra = grads if step == 0 else []
            with jfluid.scope_guard(jscope):
                jres = jexe.run(jmain, feed=feed("jax"),
                                fetch_list=[jfetch[0].name] + extra)
            tres = texe.run(tmain, feed=feed("port"),
                            fetch_list=[tfetch[0].name] + extra,
                            scope=tscope)
            jl.append(float(np.asarray(jres[0]).reshape(-1)[0]))
            tl.append(float(tres[0].reshape(-1)[0]))
            if step == 0:
                jg, tg = [np.asarray(a) for a in jres[1:]], tres[1:]
    return dict(tmain=tmain, tscope=tscope, jscope=jscope, state=state,
                jl=jl, tl=tl, jg=jg, tg=tg, grads=grads)


def test_acoustic_step_one_gradients_agree(train_runs):
    # 3 fc weights and biases, 2 LSTMP weights, projections and biases
    assert len(train_runs["grads"]) == len(train_runs["tg"]) == 12
    for name, j, t in zip(train_runs["grads"], train_runs["jg"],
                          train_runs["tg"]):
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, err_msg=name, **TOL)


def test_acoustic_losses_agree_and_fall(train_runs):
    np.testing.assert_allclose(train_runs["tl"], train_runs["jl"],
                               rtol=1e-4)
    assert all(np.isfinite(train_runs["tl"]))
    assert train_runs["tl"][-1] < train_runs["tl"][0]


def test_acoustic_state_after_twenty_steps_agrees(train_runs):
    far = total = 0
    for name in train_runs["state"]:
        t = train_runs["tscope"].get(name).numpy()
        j = np.asarray(train_runs["jscope"].get(name))
        np.testing.assert_allclose(t, j, atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)
        far += int((np.abs(t - j) > PARAM_CLOSE).sum())
        total += t.size
    assert total > 500 and far <= PARAM_FAR_SHARE * total, (far, total)


def test_acoustic_training_program_matches_the_jax_one():
    """The same ops, slots, attrs and uids, and the same serialized
    program but for the JAX package's int64 -> int32 narrowing of inferred
    dtypes (x64 is off there)."""
    jmain, jstartup, _ = _build(jfluid, _acoustic_build(True))
    tmain, tstartup, _ = _build(tfluid, _acoustic_build(True))
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
    types = [op.type for op in tmain.global_block().ops]
    assert types.count("lstmp") == LAYERS
    assert {"sequence_mask", "cross_entropy", "grad_of", "adam"} <= set(types)


# ------------------------------------------------------------- serving --

def _frame_requests(seed, lens=(3, 9, 14, 1)):
    """One-utterance requests: lists of one [T, FRAME] float32 array."""
    rng = np.random.RandomState(seed)
    return [{"frames": [(rng.randn(n, FRAME) * 0.5).astype("float32")]}
            for n in lens]


@pytest.fixture(scope="module")
def port_acoustic_model(tmp_path_factory):
    """The port's acoustic model, initialized on the CPU and saved."""
    model_dir = str(tmp_path_factory.mktemp("port_acoustic"))
    main, startup, (pred,) = _build(tfluid, _acoustic_build(False))
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    exe.run(startup, scope=scope)
    tio.save_inference_model(model_dir, ["frames"], [pred], exe, main,
                             scope=scope)
    return model_dir, pred.name


@pytest.mark.parametrize("buckets", [[4], [1, 2, 4]])
def test_acoustic_engine_answers_equal_run_direct(port_acoustic_model,
                                                  buckets):
    """Float LoD frame feeds through InferenceEngine on the CPU: ragged
    one-utterance requests coalesce into (batch, seq) buckets, and each
    answer equals run_direct at its recorded buckets, bit for bit; every
    frame's posteriors sum to 1."""
    model_dir, fetch = port_acoustic_model
    engine = InferenceEngine(model_dir, device="cpu", batch_buckets=buckets,
                             seq_buckets=[8, 16], max_queue_delay_ms=50)
    try:
        assert engine._seq_feeds == {"frames"}
        reqs = _frame_requests(5)
        futures = [engine.submit(r) for r in reqs]
        for req, fut in zip(reqs, futures):
            got = fut.result(120).numpy()[fetch]
            direct, bucket = engine.run_direct(req, *fut.bucket)
            assert bucket == fut.bucket and bucket[1] in (8, 16)
            assert got.shape == (1, bucket[1], CLASSES)
            np.testing.assert_array_equal(direct[fetch], got)
            np.testing.assert_allclose(got.sum(axis=-1), 1.0, rtol=1e-6)
        assert engine.metrics.snapshot()["errors_total"] == 0
    finally:
        engine.close()


def test_jax_saved_acoustic_model_serves_in_the_port(tmp_path):
    """The JAX package saves the acoustic model and answers frame requests
    with its fused LSTMP kernel in interpret mode; the port's engine
    serves the same directory and answers alike."""
    model_dir = str(tmp_path)
    main, startup, (pred,) = _build(jfluid, _acoustic_build(False))
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        jfluid.io.save_inference_model(model_dir, ["frames"], [pred], exe,
                                       main)
    reqs = _frame_requests(6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_PALLAS", FUSED)
        jengine = jserving.InferenceEngine(model_dir, batch_buckets=[4],
                                           seq_buckets=[8, 16],
                                           pipeline_depth=0)
        try:
            futures = [jengine.submit(r) for r in reqs]
            want = [f.result(120).numpy()[pred.name] for f in futures]
        finally:
            jengine.close()
    engine = InferenceEngine(model_dir, device="cpu", batch_buckets=[4],
                             seq_buckets=[8, 16])
    try:
        futures = [engine.submit(r) for r in reqs]
        for fut, w in zip(futures, want):
            got = fut.result(120).numpy()[pred.name]
            assert got.shape == w.shape and got.shape[2] == CLASSES
            np.testing.assert_allclose(got, w, **TOL)
    finally:
        engine.close()
