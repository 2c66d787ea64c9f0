"""The port's op rules against the JAX package's rules on the same inputs.

Each op type of the Transformer scoring and training programs runs
through both registries; inputs are made with numpy from a seed.
Tolerance: rtol = atol = 1e-5 where the two sides do fp32 arithmetic in a
different order, exact where they only move or select values. The 4
startup op types are checked on shape, dtype and, for the random ones, the
mean and standard deviation of a large draw (the two packages' random
streams differ by design, so their bits are never compared).

Gradients: each differentiable rule of the training program also runs
through the port's `grad_of` (a program holding the op and the grad_of op
core/backward.py emits for it, run by Executor("cpu") with every output's
cotangent fed as <out>@GRAD) against jax.vjp of the JAX rule, at the same
1e-5: each input gradient is a sum of at most a few dozen fp32 products.
The JAX package's integer inputs are int32 (x64 is off there); values are
compared, not dtypes.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu  # noqa: F401  (registers the JAX rules)
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lowering import LowerCtx as JaxCtx

import paddle_tpu_torch as tfluid  # (registers the port's rules)
from paddle_tpu_torch.core import backward as tbackward
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lowering import LowerCtx as TorchCtx

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: one intra-op thread does, and leaves the other
    test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_both(op_type, ins, attrs):
    """Run one op through both registries; returns ({slot: [np]}) x 2."""
    jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    tins = {s: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
            for s, v in ins.items()}
    jout = jreg.get(op_type).lower(
        JaxCtx(None, base_key=jax.random.key(0)), jins, attrs)
    tout = treg.get(op_type).lower(TorchCtx(None, CPU, run_seed=1), tins,
                                   attrs)
    to_np = {s: [np.asarray(a) for a in v] for s, v in jout.items()
             if isinstance(v, (list, tuple))}
    return to_np, {s: [a.numpy() for a in v] for s, v in tout.items()}


def _assert_same(op_type, ins, attrs, exact=False, slots=None):
    jout, tout = _run_both(op_type, ins, attrs)
    for slot in slots or tout:
        for j, t in zip(jout[slot], tout[slot]):
            assert j.shape == t.shape, (op_type, slot, j.shape, t.shape)
            if exact:
                np.testing.assert_array_equal(t, j)
            else:
                np.testing.assert_allclose(t, j, **TOL)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_mul():
    _assert_same("mul", {"X": [_rand(2, 3, 8)], "Y": [_rand(8, 5, seed=1)]},
                 {"x_num_col_dims": 2, "y_num_col_dims": 1})


@pytest.mark.parametrize("shape", [[0, -1, 2, 4], [-1, 8], [6, 8]])
def test_reshape(shape):
    _assert_same("reshape", {"X": [_rand(2, 3, 8)]}, {"shape": shape},
                 exact=True)


@pytest.mark.parametrize("y_shape,axis", [((8,), -1), ((3,), 1),
                                          ((3, 8), 1), ((2, 3, 8), -1)])
def test_elementwise_add(y_shape, axis):
    _assert_same("elementwise_add",
                 {"X": [_rand(2, 3, 8)], "Y": [_rand(*y_shape, seed=2)]},
                 {"axis": axis}, exact=True)


def test_relu():
    _assert_same("relu", {"X": [_rand(4, 6)]}, {}, exact=True)


@pytest.mark.parametrize("attrs", [{"scale": 2.5},
                                   {"scale": 0.5, "bias": 1.0},
                                   {"scale": 3.0, "bias": -1.0,
                                    "bias_after_scale": False}])
def test_scale(attrs):
    _assert_same("scale", {"X": [_rand(3, 5)]}, attrs)


@pytest.mark.parametrize("pallas", ["0", "1"])
@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm(monkeypatch, pallas, affine):
    """The port sends layer_norm with scale and bias to its kernel wrapper
    (the plain version on the CPU); the JAX rule runs either its dense
    path or its Pallas kernel in interpret mode."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS", pallas)
    ins = {"X": [_rand(2, 5, 16) * 2 + 0.5]}
    if affine:
        ins["Scale"] = [_rand(16, seed=1)]
        ins["Bias"] = [_rand(16, seed=2)]
    _assert_same("layer_norm", ins,
                 {"epsilon": 1e-5, "begin_norm_axis": 2})


@pytest.mark.parametrize("causal", [False, True])
def test_fused_attention_flash(monkeypatch, causal):
    """Flash branch on both sides: the JAX kernel in interpret mode
    (forced by FLAGS_flash_min_seq=0), the port's wrapper (plain version
    on the CPU). kv_len arrives [B, 1] int32 and includes an empty row."""
    monkeypatch.setenv("FLAGS_flash_min_seq", "0")
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "1")
    q, k, v = (_rand(3, 24, 2, 16, seed=s) for s in range(3))
    kv = np.array([[24], [0], [13]], np.int32)
    _assert_same("fused_attention",
                 {"Q": [q], "K": [k], "V": [v], "KVLen": [kv]},
                 {"causal": causal, "scale": None, "block_q": None,
                  "block_k": None, "sp_impl": "ring"})


def test_fused_attention_decode_shape_is_dense():
    """q_len == 1 is dense on both sides (the structural decode rule of
    kernel_config.flash_at), even with the crossover at 0."""
    q, k, v = (_rand(3, 1, 2, 16, seed=s) for s in range(3))
    kv = np.array([[1], [1], [1]], np.int32)
    _assert_same("fused_attention",
                 {"Q": [q], "K": [k], "V": [v], "KVLen": [kv]},
                 {"causal": True, "scale": 0.3})


@pytest.mark.parametrize("causal", [False, True])
def test_fused_attention_dense_below_the_pinned_crossover(monkeypatch,
                                                          causal):
    """FLAGS_flash_min_seq above q_len sends both sides to their dense
    path on the CPU. No row is empty here: the dense reference softmaxes
    an empty row uniformly where flash gives 0."""
    monkeypatch.setenv("FLAGS_flash_min_seq", "1024")
    q, k, v = (_rand(2, 24, 2, 16, seed=s) for s in range(3))
    kv = np.array([[24], [13]], np.int32)
    _assert_same("fused_attention",
                 {"Q": [q], "K": [k], "V": [v], "KVLen": [kv]},
                 {"causal": causal, "scale": None})


def test_flash_pin_cannot_turn_the_card_kernel_off(monkeypatch):
    """On the CPU the pin picks the dense path; on the card the same pin
    raises (the crossover there is unmeasured), while the structural
    decode rule and a pin at or below q_len still decide quietly."""
    from paddle_tpu_torch.ops.kernel_config import flash_at
    monkeypatch.setenv("FLAGS_flash_min_seq", "1024")
    assert flash_at(256, "cpu") is False
    with pytest.raises(RuntimeError, match="FLAGS_flash_min_seq=1024"):
        flash_at(256, "cuda")
    assert flash_at(1, "cuda") is False
    assert flash_at(2048, "cuda") is True
    monkeypatch.setenv("FLAGS_flash_min_seq", "0")
    assert flash_at(256, "cuda") is True


def test_flash_pin_rejects_a_malformed_value(monkeypatch):
    from paddle_tpu_torch.ops.kernel_config import flash_at
    monkeypatch.setenv("FLAGS_flash_min_seq", "1k")
    with pytest.raises(ValueError, match="not an integer"):
        flash_at(256, "cpu")


@pytest.mark.parametrize("ids_shape", [(2, 5), (2, 5, 1)])
@pytest.mark.parametrize("padding_idx", [-1, 3])
def test_lookup_table(ids_shape, padding_idx):
    ids = np.random.RandomState(4).randint(0, 10, ids_shape).astype(np.int64)
    ids.flat[0] = 3
    _assert_same("lookup_table", {"W": [_rand(10, 6)], "Ids": [ids]},
                 {"padding_idx": padding_idx}, exact=True)


# ------------------------------------------------------- startup ops --

def _startup(op_type, attrs):
    jout, tout = _run_both(op_type, {}, attrs)
    return jout["Out"][0], tout["Out"][0]


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_fill_constant(dtype):
    j, t = _startup("fill_constant",
                    {"shape": [3, 4], "value": 2.0, "dtype": dtype})
    assert t.shape == j.shape == (3, 4) and str(t.dtype) == dtype
    np.testing.assert_array_equal(t, j)


def test_assign_value():
    vals = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    j, t = _startup("assign_value",
                    {"shape": [3, 4], "values": vals, "dtype": "float32"})
    assert t.dtype == np.float32
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("op_type,attrs,mean,std", [
    ("uniform_random", {"min": -0.5, "max": 1.5}, 0.5, 2 / np.sqrt(12)),
    ("gaussian_random", {"mean": 0.25, "std": 0.02}, 0.25, 0.02),
])
def test_random_init(op_type, attrs, mean, std):
    attrs = dict(attrs, shape=[400, 500], dtype="float32", seed=0)
    j, t = _startup(op_type, attrs)
    assert t.shape == j.shape == (400, 500) and t.dtype == j.dtype
    for a in (j, t):
        assert abs(a.mean() - mean) < 0.1 * std
        assert abs(a.std() - std) < 0.01 * std
    # a nonzero seed attr pins the port's stream across runs
    pinned = dict(attrs, seed=17)
    first = treg.get(op_type).lower(TorchCtx(None, CPU, run_seed=1), {},
                                    pinned)["Out"][0]
    again = treg.get(op_type).lower(TorchCtx(None, CPU, run_seed=2), {},
                                    pinned)["Out"][0]
    assert torch.equal(first, again)


def test_rules_run_on_meta_tensors():
    """Build-time shape inference: every rule of the scoring program runs
    on meta tensors (nothing computed) and yields the JAX package's
    shapes under jax.eval_shape."""
    cases = [
        ("mul", {"X": [(1021, 7, 8)], "Y": [(8, 5)]},
         {"x_num_col_dims": 2}),
        ("reshape", {"X": [(1021, 7, 8)]}, {"shape": [0, -1, 2, 4]}),
        ("elementwise_add", {"X": [(1021, 7, 8)], "Y": [(8,)]},
         {"axis": 2}),
        ("relu", {"X": [(1021, 3)]}, {}),
        ("scale", {"X": [(1021, 3)]}, {"scale": 2.0}),
        ("layer_norm", {"X": [(1021, 7, 8)], "Scale": [(8,)],
                        "Bias": [(8,)]}, {"begin_norm_axis": 2}),
        ("fused_attention", {"Q": [(1021, 7, 2, 4)], "K": [(1021, 7, 2, 4)],
                             "V": [(1021, 7, 2, 4)], "KVLen": [(1021, 1)]},
         {"causal": True}),
        ("lookup_table", {"W": [(30, 8)], "Ids": [(1021, 7)]}, {}),
    ]
    for op_type, shapes, attrs in cases:
        def dt(slot):
            return "int32" if slot in ("KVLen", "Ids") else "float32"
        tins = {s: [torch.empty(sh, dtype=getattr(torch, dt(s)),
                                device="meta") for sh in v]
                for s, v in shapes.items()}
        jins = {s: [jax.ShapeDtypeStruct(sh, np.dtype(dt(s))) for sh in v]
                for s, v in shapes.items()}
        tout = treg.get(op_type).lower(treg.AbstractCtx(), tins, attrs)
        jout = jax.eval_shape(
            lambda i: jreg.get(op_type).lower(jreg.AbstractCtx(), i, attrs),
            jins)
        for slot, vals in tout.items():
            for t, j in zip(vals, jout[slot]):
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(j.shape), (op_type, slot)


# ------------------------------------------------- training-program ops --

def _positive(*shape, seed=0):
    return np.abs(_rand(*shape, seed=seed)) + 0.5


_ELEMENTWISE_Y = [((8,), -1), ((3,), 1), ((3, 8), 1), ((2, 3, 8), -1),
                  ((1,), -1)]


@pytest.mark.parametrize("y_shape,axis", _ELEMENTWISE_Y)
@pytest.mark.parametrize("op_type", ["elementwise_sub", "elementwise_mul",
                                     "elementwise_div", "elementwise_min",
                                     "elementwise_pow"])
def test_elementwise_family(op_type, y_shape, axis):
    """The rest of the elementwise family, through the one shared helper
    elementwise_add uses, with fluid `axis` broadcasting of Y."""
    x = _positive(2, 3, 8) if op_type == "elementwise_pow" else _rand(2, 3, 8)
    y = _positive(*y_shape, seed=2) if op_type in (
        "elementwise_div", "elementwise_pow") else _rand(*y_shape, seed=2)
    _assert_same(op_type, {"X": [x], "Y": [y]}, {"axis": axis})


@pytest.mark.parametrize("attrs", [
    {"dim": 1, "keep_dim": True}, {"dim": [0, 2]}, {"dim": -1},
    {"reduce_all": True}, {"reduce_all": True, "keep_dim": True}])
def test_reduce_sum(attrs):
    _assert_same("reduce_sum", {"X": [_rand(2, 3, 8)]}, attrs)


@pytest.mark.parametrize("x,out_dtype", [
    (np.arange(-3, 9, dtype=np.int64).reshape(3, 4), "float32"),
    (_rand(3, 4) * 4, "int32"),
    (_rand(3, 4), "float32")])
def test_cast(x, out_dtype):
    _assert_same("cast", {"X": [x]},
                 {"in_dtype": str(x.dtype), "out_dtype": out_dtype},
                 exact=True)


@pytest.mark.parametrize("shape", [(6, 1), (2, 3)])
def test_one_hot(shape):
    """A trailing 1 is dropped; an id outside [0, depth) gives a zero
    row on both sides."""
    ids = np.random.RandomState(3).randint(0, 5, shape).astype(np.int64)
    ids.flat[0], ids.flat[1] = 7, -1
    _assert_same("one_hot", {"X": [ids]}, {"depth": 5}, exact=True)


@pytest.mark.parametrize("x,step", [(np.array([4], np.int64), 1.0),
                                    (np.array([-1], np.int64), 1.0),
                                    (np.array([0.5], np.float32), 2.5)])
def test_increment(x, step):
    _assert_same("increment", {"X": [x]}, {"step": step}, exact=True)


def test_sign():
    x = _rand(4, 6)
    x[0, :3] = 0.0
    _assert_same("sign", {"X": [x]}, {}, exact=True)


def _xent_case(kind):
    """(ins, attrs, PADDLE_TPU_PALLAS) of one softmax_with_cross_entropy
    case. The hard-label 2-D case has labels -1 and V: the port (K4's
    plain version) takes the JAX CPU path's rule (both pick V - 1), so
    that case runs the JAX rule with PADDLE_TPU_PALLAS=0 (its Pallas path
    picks 0 instead)."""
    rng = np.random.RandomState(8)
    if kind == "hard_2d":
        lab = rng.randint(0, 20, (12, 1)).astype(np.int64)
        lab[:2, 0] = [-1, 20]
        return ({"Logits": [_rand(12, 20) * 3], "Label": [lab]}, {}, "0")
    if kind == "hard_2d_dense":
        lab = rng.randint(0, 20, (12, 1)).astype(np.int64)
        return ({"Logits": [_rand(12, 20) * 3], "Label": [lab]}, {}, "0")
    if kind == "hard_3d":
        lab = rng.randint(0, 10, (2, 5, 1)).astype(np.int64)
        return ({"Logits": [_rand(2, 5, 10) * 3], "Label": [lab]}, {}, "0")
    soft = rng.rand(6, 10).astype(np.float32)
    soft /= soft.sum(axis=1, keepdims=True)
    return ({"Logits": [_rand(6, 10) * 3], "Label": [soft]},
            {"soft_label": True}, "0")


_XENT_KINDS = ["hard_2d", "hard_2d_dense", "hard_3d", "soft"]


@pytest.mark.parametrize("kind", _XENT_KINDS)
def test_softmax_with_cross_entropy(monkeypatch, kind):
    ins, attrs, pallas = _xent_case(kind)
    monkeypatch.setenv("PADDLE_TPU_PALLAS", pallas)
    _assert_same("softmax_with_cross_entropy", ins, attrs)


def test_adam():
    ins = {"Param": [_rand(4, 6)], "Grad": [_rand(4, 6, seed=1) * 1e-3],
           "Moment1": [_rand(4, 6, seed=2) * 1e-3],
           "Moment2": [_positive(4, 6, seed=3) * 1e-6],
           "LearningRate": [np.array([1e-3], np.float32)],
           "Beta1Pow": [np.array([0.9 ** 3], np.float32)],
           "Beta2Pow": [np.array([0.98 ** 3], np.float32)]}
    _assert_same("adam", ins, {"beta1": 0.9, "beta2": 0.98,
                               "epsilon": 1e-9})


def test_adam_beta_pow_update():
    _assert_same("adam_beta_pow_update",
                 {"Beta1Pow": [np.array([0.9 ** 3], np.float32)],
                  "Beta2Pow": [np.array([0.98 ** 3], np.float32)]},
                 {"beta1": 0.9, "beta2": 0.98})


@pytest.mark.parametrize("op_type,shapes,attrs", [
    ("elementwise_div", {"X": [(1021, 7, 8)], "Y": [(7,)]}, {"axis": 1}),
    ("elementwise_pow", {"X": [(1,)], "Y": [(1,)]}, {}),
    ("reduce_sum", {"X": [(1021, 30)]}, {"dim": 1, "keep_dim": True}),
    ("reduce_sum", {"X": [(1021, 30)]}, {"reduce_all": True}),
    ("cast", {"X": [(1,)]}, {"in_dtype": "int64", "out_dtype": "float32"}),
    ("one_hot", {"X": [(1021, 1)]}, {"depth": 30}),
    ("increment", {"X": [(1,)]}, {"step": 1.0}),
    ("softmax_with_cross_entropy", {"Logits": [(1021, 30)],
                                    "Label": [(1021, 1)]}, {}),
    ("adam", {"Param": [(30, 8)], "Grad": [(30, 8)], "Moment1": [(30, 8)],
              "Moment2": [(30, 8)], "LearningRate": [(1,)],
              "Beta1Pow": [(1,)], "Beta2Pow": [(1,)]}, {}),
])
def test_training_rules_run_on_meta_tensors(op_type, shapes, attrs):
    """Build-time shape inference of the training program's new rules:
    meta tensors in, the JAX package's shapes out (jax.eval_shape)."""
    def dt(op_slot):
        return "int64" if op_slot in (("cast", "X"), ("one_hot", "X"),
                                      ("increment", "X"),
                                      ("softmax_with_cross_entropy",
                                       "Label")) else "float32"
    tins = {s: [torch.empty(sh, dtype=getattr(torch, dt((op_type, s))),
                            device="meta") for sh in v]
            for s, v in shapes.items()}
    jins = {s: [jax.ShapeDtypeStruct(sh, np.dtype(dt((op_type, s))).name
                                     .replace("64", "32")) for sh in v]
            for s, v in shapes.items()}
    tout = treg.get(op_type).lower(treg.AbstractCtx(), tins, attrs)
    jout = jax.eval_shape(
        lambda i: jreg.get(op_type).lower(jreg.AbstractCtx(), i, attrs), jins)
    for slot, vals in tout.items():
        for t, j in zip(vals, jout[slot]):
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(j.shape), (op_type, slot)


# ----------------------------------------------------------- gradients --

def _grads_both(op_type, ins, attrs, out_slots, seed=0):
    """d(sum of cot * out over out_slots)/d(every float input), from the
    port through grad_of and from jax.vjp of the JAX rule: two
    {(slot, i): np} dicts."""
    jout, tout = _run_both(op_type, ins, attrs)
    rng = np.random.RandomState(seed)
    cots = {s: [rng.randn(*a.shape).astype(np.float32) for a in jout[s]]
            for s in out_slots}
    floats = [(s, i) for s, vs in ins.items() for i, a in enumerate(vs)
              if a.dtype.kind == "f"]

    def jax_fn(prim):
        jins = {s: [prim[(s, i)] if (s, i) in prim else jnp.asarray(a)
                    for i, a in enumerate(vs)] for s, vs in ins.items()}
        out = jreg.get(op_type).lower(
            JaxCtx(None, base_key=jax.random.key(0)), jins, attrs)
        return {s: list(out[s]) for s in out_slots}

    _, vjp = jax.vjp(jax_fn, {k: jnp.asarray(ins[k[0]][k[1]])
                              for k in floats})
    want, = vjp({s: [jnp.asarray(c) for c in cs] for s, cs in cots.items()})

    program = tfluid.Program()
    block = program.global_block()

    def var(slot, i):
        return "%s_%d" % (slot.lower(), i)

    feed = {}
    for s, vs in ins.items():
        for i, a in enumerate(vs):
            block.create_var(name=var(s, i), shape=a.shape,
                             dtype=str(a.dtype))
            feed[var(s, i)] = a
    outs = {s: ["out_" + var(s, i) for i in range(len(v))]
            for s, v in tout.items()}
    for names in outs.values():
        for n in names:
            block.create_var(name=n)
    block.append_op(type=op_type,
                    inputs={s: [var(s, i) for i in range(len(v))]
                            for s, v in ins.items()},
                    outputs=outs, attrs=dict(attrs), infer_shape=False)
    seeds = set()
    for s in out_slots:
        for n, c in zip(outs[s], cots[s]):
            seeds.add(n)
            feed[n + "@GRAD"] = c
    tbackward._backward_sweep(block, [True], {var(*k) for k in floats},
                              set(), seeds, 1)
    assert [op.type for op in block.ops] == [op_type, "grad_of"]
    got = tfluid.Executor("cpu").run(
        program, feed=feed, fetch_list=[var(*k) + "@GRAD" for k in floats],
        scope=tfluid.Scope())
    return dict(zip(floats, got)), {k: np.asarray(v) for k, v in want.items()}


def _grad_cases():
    kv = np.array([[24], [0], [13]], np.int32)
    att = {s: [_rand(3, 24, 2, 16, seed=i)] for i, s in enumerate("QKV")}
    att["KVLen"] = [kv]
    ids = np.random.RandomState(4).randint(0, 10, (2, 5)).astype(np.int64)
    ids.flat[0] = 3
    cases = [
        ("elementwise_add", {"X": [_rand(2, 3, 8)], "Y": [_rand(3, seed=2)]},
         {"axis": 1}, ["Out"], "0"),
        ("elementwise_sub", {"X": [_rand(2, 3, 8)],
                             "Y": [_rand(3, 8, seed=2)]},
         {"axis": 1}, ["Out"], "0"),
        ("elementwise_mul", {"X": [_rand(2, 3, 8)], "Y": [_rand(8, seed=2)]},
         {"axis": -1}, ["Out"], "0"),
        ("elementwise_div", {"X": [_rand(2, 3, 8)],
                             "Y": [_positive(2, 3, 8, seed=2)]},
         {"axis": -1}, ["Out"], "0"),
        ("elementwise_min", {"X": [_rand(2, 3, 8)], "Y": [_rand(3, seed=2)]},
         {"axis": 1}, ["Out"], "0"),
        ("elementwise_pow", {"X": [_positive(2, 3)],
                             "Y": [np.array([-0.5], np.float32)]},
         {"axis": -1}, ["Out"], "0"),
        ("reduce_sum", {"X": [_rand(4, 6)]}, {"dim": 1, "keep_dim": True},
         ["Out"], "0"),
        ("reduce_sum", {"X": [_rand(4, 6)]}, {"reduce_all": True}, ["Out"],
         "0"),
        ("mul", {"X": [_rand(2, 3, 8)], "Y": [_rand(8, 5, seed=1)]},
         {"x_num_col_dims": 2, "y_num_col_dims": 1}, ["Out"], "0"),
        ("reshape", {"X": [_rand(2, 3, 8)]}, {"shape": [0, -1, 2, 4]},
         ["Out"], "0"),
        ("relu", {"X": [_rand(4, 6)]}, {}, ["Out"], "0"),
        ("scale", {"X": [_rand(3, 5)]}, {"scale": 2.5, "bias": 1.0},
         ["Out"], "0"),
        ("lookup_table", {"W": [_rand(10, 6)], "Ids": [ids]},
         {"padding_idx": 3}, ["Out"], "0"),
        ("layer_norm", {"X": [_rand(2, 5, 16) * 2 + 0.5],
                        "Scale": [_rand(16, seed=1)],
                        "Bias": [_rand(16, seed=2)]},
         {"epsilon": 1e-5, "begin_norm_axis": 2}, ["Y"], "1"),
        ("layer_norm", {"X": [_rand(2, 5, 16) * 2 + 0.5],
                        "Scale": [_rand(16, seed=1)],
                        "Bias": [_rand(16, seed=2)]},
         {"epsilon": 1e-5, "begin_norm_axis": 2}, ["Y"], "0"),
        ("fused_attention", att, {"causal": False, "scale": None},
         ["Out"], "1"),
        ("fused_attention", att, {"causal": True, "scale": None},
         ["Out"], "1"),
    ]
    for kind in _XENT_KINDS:
        ins, attrs, pallas = _xent_case(kind)
        if kind == "hard_2d":
            # label V becomes -V here: the JAX CPU path's gradient drops a
            # label its gather had to clamp (its forward picks V - 1, its
            # scatter transpose drops V), while -1 and -V wrap in range.
            # tests/test_torch_faults.py holds label V's gradient to the
            # port's own forward.
            lab = ins["Label"][0].copy()
            lab[1, 0] = -20
            ins = dict(ins, Label=[lab])
        cases.append(("softmax_with_cross_entropy", ins, attrs,
                      ["Loss", "Softmax"], pallas))
    # C13: jax.grad(jnp.abs) is +1 at 0 (and at -0); torch.abs's is 0
    cases.append(("abs", {"X": [np.array([-1.0, 0.0, 1.0, 0.0, 2.0, -0.0],
                                         np.float32)]}, {}, ["Out"], "0"))
    return cases


_GRAD_CASES = _grad_cases()


@pytest.mark.parametrize(
    "case", range(len(_GRAD_CASES)),
    ids=["%s-%d" % (c[0], i) for i, c in enumerate(_GRAD_CASES)])
def test_grad_of_matches_jax_vjp(monkeypatch, case):
    """grad_of keeps the forward op's local graph and differentiates it
    with torch.autograd; the kernel ops go through their autograd
    Functions (K1 -> K2 + K3, K4, K5) and the JAX side through its
    custom_vjps (PADDLE_TPU_PALLAS=1, flash forced by
    FLAGS_flash_min_seq=0)."""
    op_type, ins, attrs, out_slots, pallas = _GRAD_CASES[case]
    monkeypatch.setenv("PADDLE_TPU_PALLAS", pallas)
    monkeypatch.setenv("FLAGS_flash_min_seq", "0")
    got, want = _grads_both(op_type, ins, attrs, out_slots)
    assert set(got) == set(want) and got
    for key in got:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], err_msg=str(key),
                                   **TOL)
