"""The port's pipeline and mixture-of-experts functions
(paddle_tpu_torch/parallel/pipeline.py, moe.py) against the JAX package's
(tests/unittests/test_pipeline.py, test_moe.py) on the same numpy inputs.

Tolerances: the schedule reorders no sum of the forward, so the port's
pipeline forward equals its own sequential stack bit for bit; a weight's
gradient sums over microbatches (another order, 1e-6 relative), and the
MoE layer's expert groups likewise. Against the JAX package the products
and sums run in other libraries: 1e-5 (forward, fp32) and 1e-4 relative
(gradients), the JAX tests' own.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel import moe as jmoe
from paddle_tpu.parallel import pipeline as jpipe

from paddle_tpu_torch.parallel import (make_mesh, moe_layer,
                                       init_moe_params, pipeline_apply,
                                       sequential_reference,
                                       stack_stage_params)
from paddle_tpu_torch.parallel import moe as tmoe
from paddle_tpu_torch.parallel import pipeline as tpipe

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
SUM_TOL = dict(rtol=1e-6, atol=1e-7)


def _stage_np(rng, n_stages, feat):
    return [(rng.randn(feat, feat).astype("float32") * 0.3,
             rng.randn(feat).astype("float32") * 0.1)
            for _ in range(n_stages)]


def _t_stage(params, x):
    w, b = params
    return torch.tanh(x @ w + b)


def _j_stage(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def _t_params(per):
    return stack_stage_params([(torch.from_numpy(w), torch.from_numpy(b))
                               for w, b in per])


def _pp_mesh(n, **axes):
    axes = dict(axes) or {"pp": n}
    size = int(np.prod(list(axes.values())))
    return make_mesh(axes, ["cpu"] * size)


@pytest.mark.parametrize("n_micro", [4, 8])
def test_pipeline_forward_matches_sequential_and_jax(n_micro):
    rng = np.random.RandomState(0)
    per = _stage_np(rng, 4, 16)
    x = rng.randn(n_micro * 2, 16).astype("float32")
    got = pipeline_apply(_t_stage, _t_params(per), torch.from_numpy(x),
                         _pp_mesh(4), num_microbatches=n_micro)
    ref = sequential_reference(_t_stage, _t_params(per), torch.from_numpy(x))
    assert torch.equal(got, ref)
    want = jpipe.pipeline_apply(
        _j_stage, jpipe.stack_stage_params(per), x,
        jmake_mesh({"pp": 4}, jax.devices()[:4]), num_microbatches=n_micro)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_pipeline_grads_match_sequential_and_jax():
    rng = np.random.RandomState(1)
    per = _stage_np(rng, 4, 8)
    x = rng.randn(8, 8).astype("float32")
    tgt = rng.randn(8, 8).astype("float32")

    def grads(fn):
        params = [t.clone().requires_grad_(True) for t in _t_params(per)]
        out = fn(tuple(params))
        loss = ((out - torch.from_numpy(tgt)) ** 2).mean()
        return torch.autograd.grad(loss, params)

    g_pipe = grads(lambda p: pipeline_apply(
        _t_stage, p, torch.from_numpy(x), _pp_mesh(4), num_microbatches=4))
    g_seq = grads(lambda p: sequential_reference(_t_stage, p,
                                                 torch.from_numpy(x)))
    for a, b in zip(g_pipe, g_seq):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **SUM_TOL)
    jmesh = jmake_mesh({"pp": 4}, jax.devices()[:4])
    g_jax = jax.grad(lambda p: jnp.mean((jpipe.pipeline_apply(
        _j_stage, p, x, jmesh, num_microbatches=4) - tgt) ** 2))(
            jpipe.stack_stage_params(per))
    for a, b in zip(g_pipe, jax.tree_util.tree_leaves(g_jax)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_pipeline_schedule_slots_and_stage_calls():
    """Stage s takes microbatch t - s at tick t over M + S - 1 ticks; the
    bubble slots are skipped, so a run makes S * M stage calls."""
    slots = tpipe.pipeline_schedule(4, 8)
    assert len(slots) == 32
    assert max(t for t, _, _ in slots) == 8 + 4 - 2
    assert all(m == t - s and 0 <= m < 8 for t, s, m in slots)
    for s in range(4):
        assert [m for _, st, m in slots if st == s] == list(range(8))
    calls = []
    rng = np.random.RandomState(5)
    per = _stage_np(rng, 4, 8)

    def stage(p, x):
        calls.append(x.shape[0])
        return _t_stage(p, x)

    pipeline_apply(stage, _t_params(per), torch.randn(16, 8), _pp_mesh(4),
                   num_microbatches=8)
    assert calls == [2] * 32


def test_pipeline_dp_pp_splits_each_microbatch():
    """batch_axis='dp' splits each microbatch over the dp replicas (one
    stage call a part); a row-local stage gives the sequential result."""
    rng = np.random.RandomState(2)
    per = _stage_np(rng, 4, 8)
    x = torch.from_numpy(rng.randn(16, 8).astype("float32"))
    mesh = make_mesh({"dp": 2, "pp": 4}, ["cpu"] * 8)
    calls = []

    def stage(p, xb):
        calls.append(xb.shape[0])
        return _t_stage(p, xb)

    got = pipeline_apply(stage, _t_params(per), x, mesh,
                         num_microbatches=4, batch_axis="dp")
    assert calls == [2] * 32
    ref = sequential_reference(_t_stage, _t_params(per), x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **SUM_TOL)


def test_pipeline_rejects_bad_shapes_and_distinct_cards():
    rng = np.random.RandomState(3)
    with pytest.raises(ValueError, match="leading dim"):
        pipeline_apply(_t_stage, _t_params(_stage_np(rng, 2, 8)),
                       torch.randn(8, 8), _pp_mesh(4))
    params4 = _t_params(_stage_np(rng, 4, 8))
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(_t_stage, params4, torch.randn(7, 8), _pp_mesh(4),
                       num_microbatches=4)
    apart = make_mesh({"pp": 4}, ["cpu", "cuda:0", "cuda:1", "cuda:2"])
    with pytest.raises(NotImplementedError, match="item 5"):
        pipeline_apply(_t_stage, params4, torch.randn(8, 8), apart)


def test_pipeline_megatron_stages_match_jax():
    """Stages of Megatron column/row blocks over tp_size=2 pieces summed
    (the all-reduce on one device), pipelined over pp=2 with dp=2: the
    JAX package's dense sequential stack."""
    w = [jpipe.mlp_block_init(7 + s, 16, 32) for s in range(2)]
    per = [{k: torch.from_numpy(np.array(v)) for k, v in p.items()}
           for p in w]
    x = np.random.RandomState(2).randn(8, 16).astype("float32")
    mesh = make_mesh({"dp": 2, "mp": 2, "pp": 2}, ["cpu"] * 8)
    got = pipeline_apply(
        lambda p, xb: tpipe.mlp_block_apply(p, xb, tp_size=2),
        stack_stage_params(per), torch.from_numpy(x), mesh,
        num_microbatches=4, batch_axis="dp",
        param_specs=tpipe.mlp_block_specs(tp_axis="mp", pp_axis="pp"))
    want = jpipe.sequential_reference(
        lambda p, xb: jpipe.mlp_block_apply(p, xb),
        jpipe.stack_stage_params(w), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    dense = sequential_reference(tpipe.mlp_block_apply,
                                 stack_stage_params(per),
                                 torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **FWD_TOL)


def _moe_pair(seed, d=8, h=16, e=4):
    rng = np.random.RandomState(seed)
    jp = jmoe.init_moe_params(rng, d_model=d, d_hidden=h, num_experts=e)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return rng, jp, tp


def test_init_moe_params_draws_the_jax_numbers():
    _, jp, _ = _moe_pair(0)
    tp = init_moe_params(np.random.RandomState(0), 8, 16, 4)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


@pytest.mark.parametrize("capacity", [0.5, 1.25, 4.0])
def test_moe_layer_matches_jax(capacity):
    rng, jp, tp = _moe_pair(0)
    x = rng.randn(32, 8).astype("float32")
    y, aux = moe_layer(tp, torch.from_numpy(x), capacity_factor=capacity)
    jy, jaux = jmoe.moe_layer(jp, x, capacity_factor=capacity)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FWD_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    if capacity == 4.0:   # no token can be dropped: the dense reference
        ref = tmoe.dense_reference(tp, torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=2e-4,
                                   atol=2e-5)
        assert float(aux) >= 1.0 - 1e-5


def test_moe_routing_positions_match_the_jax_cumsum():
    rng, jp, tp = _moe_pair(4)
    x = rng.randn(40, 8).astype("float32")
    probs = torch.softmax(torch.from_numpy(x) @ tp["gate"], dim=-1)
    expert, top_p, pos, keep = tmoe.route(probs, 6)
    onehot = jax.nn.one_hot(jnp.argmax(jnp.asarray(probs.numpy()), -1), 4)
    jpos = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1.0
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jpos) < 6)


def test_moe_capacity_drops_overflow_tokens():
    """A zero gate ties every expert; the ties go to expert 0, whose 2
    slots (capacity 0.5 over 16 tokens and 4 experts) take the first two
    tokens: the others get zero output, in both packages."""
    rng, jp, tp = _moe_pair(1)
    jp["gate"] = jnp.zeros_like(jp["gate"])
    tp["gate"] = torch.zeros_like(tp["gate"])
    x = rng.randn(16, 8).astype("float32")
    y, _ = moe_layer(tp, torch.from_numpy(x), capacity_factor=0.5)
    jy, _ = jmoe.moe_layer(jp, x, capacity_factor=0.5)
    rows = (y.abs().amax(dim=1) > 1e-9).numpy()
    assert rows.tolist() == [True, True] + [False] * 14
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FWD_TOL)


def test_moe_grads_match_jax():
    rng, jp, tp = _moe_pair(2)
    x = rng.randn(24, 8).astype("float32")
    tgt = rng.randn(24, 8).astype("float32")
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    y, aux = moe_layer(leaves, torch.from_numpy(x), capacity_factor=2.0)
    loss = ((y - torch.from_numpy(tgt)) ** 2).mean() + 0.01 * aux
    names = sorted(leaves)
    got = torch.autograd.grad(loss, [leaves[k] for k in names])

    def jloss(p):
        jy, jaux = jmoe.moe_layer(p, x, capacity_factor=2.0)
        return jnp.mean((jy - tgt) ** 2) + 0.01 * jaux

    want = jax.grad(jloss)(jp)
    for k, g in zip(names, got):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   err_msg=k, **GRAD_TOL)
    assert float(got[names.index("w1")].abs().max()) > 0


def test_moe_expert_groups_split_the_work_not_the_values():
    """ep groups of E / ep experts (one a replica of the 'ep' axis) give
    the values of one group, gradients included."""
    rng, _, tp = _moe_pair(3, e=8)
    x = torch.from_numpy(rng.randn(32, 8).astype("float32"))
    outs = {}
    for ep in (1, 2, 4, 8):
        leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        y, aux = moe_layer(leaves, x, capacity_factor=1.25, ep=ep)
        g = torch.autograd.grad((y ** 2).sum() + aux, leaves["w1"])[0]
        outs[ep] = (y.detach(), aux.detach(), g)
    for ep in (2, 4, 8):
        for a, b in zip(outs[1], outs[ep]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **SUM_TOL)
    with pytest.raises(ValueError, match="do not split"):
        moe_layer(tp, x, ep=3)
