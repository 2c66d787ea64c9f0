"""The port's op rules against the JAX package's rules on the same inputs.

Each of the 8 op types of the Transformer scoring program runs through
both registries; inputs are made with numpy from a seed. Tolerance:
rtol = atol = 1e-5 where the two sides do fp32 arithmetic in a different
order, exact where they only move or select values. The 4 startup op
types are checked on shape, dtype and, for the random ones, the mean and
standard deviation of a large draw (the two packages' random streams
differ by design, so their bits are never compared).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu  # noqa: F401  (registers the JAX rules)
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lowering import LowerCtx as JaxCtx

import paddle_tpu_torch  # noqa: F401  (registers the port's rules)
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
