"""The port's weight-dtype serving (serving/quantize.py,
InferenceEngine(weights_dtype=...)) on the CPU, mirroring the tests of
tests/unittests/test_quantized_serving.py that need neither
from_checkpoint (ROADMAP A8) nor a replica pool (A10), plus a parity test
with the JAX package.

- the census: only matmul/conv weights quantize;
- the int8 rewrite: @QVAL int8 and @QSCALE f32 persistables behind a
  prepended dequantize_channel, the param a computed intermediate;
- the divergence gate: bf16 and int8 answers within divergence_bound of
  the fp32 engine's (max |q - f| / (max |f| + 1e-6) <= 5e-2), the fp32
  model files untouched;
- coalesced rows of an int8 engine equal run_direct's at the same
  bucket, bit for bit (one device, one shape, the same arithmetic);
- rejections: an unknown dtype, an in-memory program, int8 with tp, a
  param missing from the scope;
- parity: apply_weights_dtype("int8") in both packages on the same fp32
  weights gives bit-equal @QVAL and @QSCALE (the same numpy arithmetic),
  and the port's int8 answers equal the JAX int8 engine's within
  rtol = atol = 1e-5 (fp32 products in another order).
"""
import glob
import hashlib
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.serving.engine import InferenceEngine as JaxEngine

import paddle_tpu_torch as fluid
from paddle_tpu_torch.ops import quant_ops
from paddle_tpu_torch.serving.engine import InferenceEngine
from paddle_tpu_torch.serving.quantize import (QSCALE_SUFFIX, QVAL_SUFFIX,
                                               apply_weights_dtype,
                                               divergence_bound,
                                               quantizable_params)

rng = np.random.RandomState(17)
PARITY_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _save_mlp(tmp_path, feat=10, classes=3, seed=5, fl=jfluid):
    """fc(16, relu) -> fc(softmax), initialized and saved by `fl`."""
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = seed
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[feat], dtype="float32")
        h = fl.layers.fc(input=x, size=16, act="relu")
        pred = fl.layers.fc(input=h, size=classes, act="softmax")
    exe = fl.Executor(fl.CPUPlace())
    d = str(tmp_path / "mlp")
    with fl.scope_guard(fl.Scope()):
        exe.run(startup)
        fl.io.save_inference_model(d, ["x"], [pred], exe, main)
    return d, feat


def _engine(d, **kw):
    return InferenceEngine(d, device="cpu", **kw)


def test_quantizable_params_census():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = fluid.layers.data(name="w", shape=[1], dtype="int64",
                                  lod_level=1)
        emb = fluid.layers.embedding(input=words, size=[30, 8])
        pool = fluid.layers.sequence_pool(input=emb, pool_type="sum")
        fluid.layers.fc(input=pool, size=4)
    census = quantizable_params(main)
    names = sorted(census)
    assert len(names) == 1 and names[0].startswith("fc_")
    assert census[names[0]] == 1  # mul weight: per-output-column scales


def test_int8_rewrite_shapes_and_scope(tmp_path):
    d, feat = _save_mlp(tmp_path, fl=fluid)
    eng = _engine(d, weights_dtype="int8", warmup=False)
    try:
        rep = eng.quantize_report
        assert rep["mode"] == "int8" and len(rep["params"]) == 2
        assert rep["bytes_after"] < rep["bytes_before"] / 2
        block = eng.program.global_block()
        for name in rep["params"]:
            qv = block.var(name + QVAL_SUFFIX)
            qs = block.var(name + QSCALE_SUFFIX)
            assert qv.dtype == "int8" and qv.persistable
            assert qs.dtype == "float32" and qs.persistable
            assert not block.var(name).persistable
            vals = eng._scope.get(name + QVAL_SUFFIX)
            assert vals.dtype == torch.int8
            assert int(vals.abs().max()) <= 127
            assert eng._scope.get(name) is None
            scales = eng._scope.get(name + QSCALE_SUFFIX).numpy()
            assert scales.shape == (qv.shape[-1],)
            assert (scales > 0).all()
        assert block.ops[0].type == "dequantize_channel"
        assert eng.describe()["weights_dtype"] == "int8"
    finally:
        eng.close(drain=False)


@pytest.mark.parametrize("wd", ["bf16", "int8"])
def test_quantized_engine_divergence_gate(tmp_path, wd):
    d, feat = _save_mlp(tmp_path)
    before = {p: hashlib.sha256(open(p, "rb").read()).hexdigest()
              for p in sorted(glob.glob(os.path.join(d, "*")))}
    ref = _engine(d, max_batch_size=4)
    eng = _engine(d, weights_dtype=wd, max_batch_size=4)
    try:
        if wd == "bf16":
            assert eng.program._amp
            w = eng.quantize_report["params"][0]
            assert eng._scope.get(w).dtype == torch.bfloat16
        feed = {"x": rng.randn(3, feat).astype("float32")}
        want = ref.infer(feed)
        got = eng.infer(feed)
        for name in want:
            div = (np.abs(got[name].astype(np.float64)
                          - want[name].astype(np.float64)).max()
                   / (np.abs(want[name]).max() + 1e-6))
            assert div <= divergence_bound(wd), (name, div)
        after = {p: hashlib.sha256(open(p, "rb").read()).hexdigest()
                 for p in sorted(glob.glob(os.path.join(d, "*")))}
        assert after == before
    finally:
        eng.close(drain=False)
        ref.close(drain=False)


def test_quantized_engine_batched_bit_identical_to_direct(tmp_path):
    d, feat = _save_mlp(tmp_path)
    eng = _engine(d, weights_dtype="int8", batch_buckets=[1, 4],
                  max_batch_size=4, max_queue_delay_ms=20)
    try:
        feeds = [{"x": rng.randn(1, feat).astype("float32")}
                 for _ in range(4)]
        futures = [None] * 4

        def fire(i):
            futures[i] = eng.submit(feeds[i])

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, fut in enumerate(futures):
            got = fut.result(60).numpy()
            want, _ = eng.run_direct(feeds[i], batch_bucket=fut.bucket[0],
                                     seq_bucket=fut.bucket[1])
            for name in eng.fetch_names:
                assert np.array_equal(got[name], want[name]), (i, name)
    finally:
        eng.close(drain=False)


def test_int8_rejects_tensor_parallel(tmp_path):
    """int8 weights are refused with tp (with or without a mesh); bf16
    weights compose with it."""
    d, _ = _save_mlp(tmp_path)
    with pytest.raises(ValueError, match="int8"):
        _engine(d, weights_dtype="int8", tp=1, warmup=False)
    with pytest.raises(ValueError, match="int8"):
        _engine(d, weights_dtype="int8", tp=1, mesh_devices=["cpu"],
                warmup=False)
    eng = _engine(d, weights_dtype="bf16", tp=1, mesh_devices=["cpu"],
                  warmup=False)
    try:
        assert (eng.tp, eng.device_span()) == (1, ["cpu"])
    finally:
        eng.close(drain=False)


def test_bad_weights_dtype_rejected(tmp_path):
    d, _ = _save_mlp(tmp_path)
    with pytest.raises(ValueError, match="weights_dtype"):
        _engine(d, weights_dtype="fp8", warmup=False)


def test_inmemory_program_weights_dtype_rejected():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        pred = fluid.layers.fc(input=x, size=2)
    with pytest.raises(ValueError, match="in-memory program"):
        InferenceEngine(program=main, feed_names=["x"], fetch_vars=[pred],
                        weights_dtype="int8", warmup=False, device="cpu")


def test_apply_weights_dtype_missing_param_raises():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        fluid.layers.fc(input=x, size=2)
    with pytest.raises(ValueError, match="not initialized"):
        apply_weights_dtype(main, fluid.Scope(), "int8")


def test_divergence_bound_env_override(monkeypatch):
    assert divergence_bound("int8") == 0.05
    monkeypatch.setenv("PADDLE_TPU_QUANT_BOUND", "0.005")
    assert divergence_bound("int8") == 0.005
    assert divergence_bound("bf16") == 0.005


def test_dequantize_channel_rule_matches_jax():
    """The op rule on its own, both axes: exact (one product a value)."""
    from test_torch_ops import _run_both
    q = rng.randint(-127, 128, (6, 5)).astype(np.int8)
    for axis, n in ((-1, 5), (0, 6)):
        scale = rng.rand(n).astype(np.float32)
        jout, tout = _run_both("dequantize_channel",
                               {"X": [q], "Scale": [scale]}, {"axis": axis})
        np.testing.assert_array_equal(tout["Out"][0], jout["Out"][0])
    assert quant_ops.DEQUANTIZE_SLOTS == {"X": "int8", "Scale": "float32"}


def test_int8_parity_with_the_jax_package(tmp_path):
    """One model saved by the JAX package, quantized by each package's
    engine: bit-equal @QVAL and @QSCALE, answers within PARITY_TOL."""
    d, feat = _save_mlp(tmp_path, seed=9)
    jeng = JaxEngine(d, weights_dtype="int8", max_batch_size=4,
                     warmup=False)
    teng = _engine(d, weights_dtype="int8", max_batch_size=4, warmup=False)
    try:
        assert teng.quantize_report["params"] == \
            jeng.quantize_report["params"]
        for name in teng.quantize_report["params"]:
            for suffix in (QVAL_SUFFIX, QSCALE_SUFFIX):
                want = np.asarray(jeng._scope.get(name + suffix))
                got = teng._scope.get(name + suffix).numpy()
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
        feed = {"x": rng.randn(4, feat).astype("float32")}
        want, _ = jeng.run_direct(feed)
        got, _ = teng.run_direct(feed)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], **PARITY_TOL)
    finally:
        jeng.close(drain=False)
        teng.close(drain=False)
