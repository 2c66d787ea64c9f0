"""Serving from training snapshots and from era-wire directories in the
port (InferenceEngine.from_checkpoint, model_format "reference" / "auto",
ModelServer over both) against the JAX package, on the CPU.

Mirrors tests/unittests/test_checkpoint_manager.py::
test_engine_from_checkpoint and the engine's model_format branch
(paddle_tpu/serving/engine.py:425-543):
- from_checkpoint serves the newest valid snapshot, bit-equal to an engine
  over save_inference_model of the same state and within 1e-5 of the JAX
  package's from_checkpoint on the same snapshot (one the JAX package
  wrote, too); a corrupt newest snapshot is skipped, a pinned corrupt one
  raises; `checkpoint_step`; weights_dtype "bf16" applied after the fp32
  arrays land; a mixed-precision training program's pruned program keeps
  its mixed precision in both packages; a reader-fed program serves with
  its records as feeds;
- model_format "reference" and "auto" load an era-wire directory, "auto"
  a native one; a ModelServer `:predict` answers over a from_checkpoint
  engine and over an era-wire engine as run_direct does.
"""
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.checkpoint import CheckpointManager as JManager
from paddle_tpu.serving.engine import InferenceEngine as JEngine

import paddle_tpu_torch as fluid
from paddle_tpu_torch.checkpoint import CheckpointManager, load_manifest
from paddle_tpu_torch.observability import registry as obsreg
from paddle_tpu_torch.serving import InferenceEngine, ModelServer

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _forget(engine):
    """Drop the engine's entries from the registry's weak tables."""
    b = engine._batcher
    objs = {id(b), id(b._window)}
    with obsreg._note_lock:
        for table in (obsreg._live_windows, obsreg._live_batchers,
                      obsreg._live_decoders):
            for label in [k for k, v in table.items() if id(v) in objs]:
                del table[label]


def _close(*engines):
    for e in engines:
        e.close(drain=False)
        _forget(e)


def _build(f, amp=False):
    """fc -> tanh -> fc regression trained by SGD: (main, startup, loss,
    pred)."""
    main, startup = f.Program(), f.Program()
    main.random_seed = startup.random_seed = 4
    if amp:
        main.enable_mixed_precision()
    with f.unique_name.guard(), f.program_guard(main, startup):
        x = f.layers.data(name="x", shape=[6], dtype="float32")
        y = f.layers.data(name="y", shape=[1], dtype="float32")
        h = f.layers.fc(input=x, size=8, act="tanh")
        pred = f.layers.fc(input=h, size=1)
        loss = f.layers.mean(
            x=f.layers.square_error_cost(input=pred, label=y))
        f.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss, pred


def _train_and_save(ck, steps=(1, 2), amp=False, seed=8):
    main, startup, loss, pred = _build(fluid, amp)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    xb = np.random.RandomState(seed).rand(4, 6).astype("f")
    with CheckpointManager(ck, async_save=False) as mgr:
        for s in steps:
            exe.run(main, feed={"x": xb, "y": xb[:, :1]},
                    fetch_list=[loss], scope=scope)
            mgr.save(s, program=main, scope=scope)
    return main, exe, scope, pred


def _engine_kw():
    return dict(batch_buckets=[4], max_batch_size=4, device="cpu")


def test_from_checkpoint_equals_save_inference_model_and_jax(tmp_path):
    ck = str(tmp_path / "ck")
    main, exe, scope, pred = _train_and_save(ck)
    q = np.random.RandomState(1).rand(3, 6).astype("f")
    eng = InferenceEngine.from_checkpoint(ck, fetch_list=[pred.name],
                                          **_engine_kw())
    d = str(tmp_path / "native")
    fluid.io.save_inference_model(d, ["x"], [pred], exe, main, scope=scope)
    ref = InferenceEngine(d, **_engine_kw())
    jeng = JEngine.from_checkpoint(ck, fetch_list=[pred.name],
                                   batch_buckets=[4], max_batch_size=4)
    try:
        assert eng.checkpoint_step == 2 and eng.feed_names == ["x"]
        assert eng.name == "ckpt-step-2"
        got, bucket = eng.run_direct({"x": q})
        want, _ = ref.run_direct({"x": q})
        np.testing.assert_array_equal(got[pred.name], want[pred.name])
        jwant, _ = jeng.run_direct({"x": q})
        np.testing.assert_allclose(got[pred.name], jwant[pred.name], **TOL)
        assert bucket == (4, None)
        for name in eng._scope.names():
            t = eng._scope.get(name)
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    finally:
        _close(eng, ref)
        jeng.close(drain=False)


def test_from_checkpoint_walks_back_past_a_corrupt_snapshot(tmp_path):
    ck = str(tmp_path / "ck")
    _, _, _, pred = _train_and_save(ck)
    m = load_manifest(os.path.join(ck, "step_2"))
    victim = next(e["file"] for e in m.values() if e.get("is_param"))
    with open(os.path.join(ck, "step_2", victim), "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    eng = InferenceEngine.from_checkpoint(ck, fetch_list=[pred.name],
                                          warmup=False, **_engine_kw())
    try:
        assert eng.checkpoint_step == 1
    finally:
        _close(eng)
    with pytest.raises(ValueError, match="hash mismatch"):
        InferenceEngine.from_checkpoint(ck, fetch_list=[pred.name], step=2,
                                        warmup=False, **_engine_kw())
    with pytest.raises(FileNotFoundError):
        InferenceEngine.from_checkpoint(str(tmp_path / "none"),
                                        fetch_list=[pred.name],
                                        **_engine_kw())


def test_from_checkpoint_serves_a_jax_snapshot(tmp_path):
    ck = str(tmp_path / "ck")
    main, startup, loss, pred = _build(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    xb = np.random.RandomState(2).rand(4, 6).astype("f")
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        exe.run(main, feed={"x": xb, "y": xb[:, :1]}, fetch_list=[loss])
        with JManager(ck, async_save=False) as mgr:
            mgr.save(1, program=main)
    q = np.random.RandomState(3).rand(2, 6).astype("f")
    eng = InferenceEngine.from_checkpoint(ck, fetch_list=[pred.name],
                                          **_engine_kw())
    jeng = JEngine.from_checkpoint(ck, fetch_list=[pred.name],
                                   batch_buckets=[4], max_batch_size=4)
    try:
        got, _ = eng.run_direct({"x": q})
        want, _ = jeng.run_direct({"x": q})
        np.testing.assert_allclose(got[pred.name], want[pred.name], **TOL)
    finally:
        _close(eng)
        jeng.close(drain=False)


def test_from_checkpoint_weights_dtype_and_mixed_precision(tmp_path):
    """weights_dtype applies after the fp32 arrays land (the snapshot
    stays fp32); the pruned program of a mixed-precision training program
    keeps mixed precision, as the JAX package's does."""
    ck = str(tmp_path / "ck")
    main, exe, scope, pred = _train_and_save(ck)
    q = np.random.RandomState(5).rand(4, 6).astype("f")
    eng = InferenceEngine.from_checkpoint(ck, fetch_list=[pred.name],
                                          weights_dtype="bf16",
                                          **_engine_kw())
    d = str(tmp_path / "native")
    fluid.io.save_inference_model(d, ["x"], [pred], exe, main, scope=scope)
    ref = InferenceEngine(d, weights_dtype="bf16", **_engine_kw())
    try:
        assert eng.weights_dtype == "bf16" and eng.program._amp
        assert eng.quantize_report["params"] == \
            ref.quantize_report["params"]
        for n in eng.quantize_report["params"]:
            assert eng._scope.get(n).dtype == torch.bfloat16
        got, _ = eng.run_direct({"x": q})
        want, _ = ref.run_direct({"x": q})
        np.testing.assert_array_equal(got[pred.name], want[pred.name])
    finally:
        _close(eng, ref)
    for e in load_manifest(os.path.join(ck, "step_2")).values():
        assert e["dtype"] in ("float32", "int64")

    amp_ck = str(tmp_path / "amp")
    _, _, _, apred = _train_and_save(amp_ck, steps=(1,), amp=True)
    eng = InferenceEngine.from_checkpoint(amp_ck, fetch_list=[apred.name],
                                          warmup=False, **_engine_kw())
    jeng = JEngine.from_checkpoint(amp_ck, fetch_list=[apred.name],
                                   batch_buckets=[4], max_batch_size=4,
                                   warmup=False)
    try:
        assert eng.program._amp and jeng.program._amp
        assert eng.weights_dtype == "fp32"
        got, _ = eng.run_direct({"x": q})
        want, _ = jeng.run_direct({"x": q})
        np.testing.assert_allclose(got[apred.name], want[apred.name],
                                   rtol=2e-2, atol=2e-2)
    finally:
        _close(eng)
        jeng.close(drain=False)


def test_from_checkpoint_of_a_reader_fed_program(tmp_path):
    """The pruned program of a reader-fed training program keeps its
    `read` op; from_checkpoint drops it and serves the records' vars as
    feeds, equal to the feed-fed program's engine on the same state."""
    def gen():
        r = np.random.RandomState(6)
        for _ in range(4):
            xs = r.rand(4, 6).astype("float32")
            yield xs, xs[:, :1].copy()
    path = str(tmp_path / "data.recordio")
    fluid.recordio_writer.convert_reader_to_recordio_file(path, gen)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 4
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        rdr = fluid.layers.open_recordio_file(
            filename=path, shapes=[[-1, 6], [-1, 1]], lod_levels=[0, 0],
            dtypes=["float32", "float32"])
        x, y = fluid.layers.read_file(fluid.layers.double_buffer(rdr))
        h = fluid.layers.fc(input=x, size=8, act="tanh")
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, fetch_list=[loss], scope=scope, steps=2)
    ck = str(tmp_path / "ck")
    with CheckpointManager(ck, async_save=False) as mgr:
        mgr.save(2, program=main, scope=scope)
    fmain, _, _, fpred = _build(fluid)
    d = str(tmp_path / "native")
    fluid.io.save_inference_model(d, ["x"], [fpred], exe, fmain,
                                  scope=scope)
    eng = InferenceEngine.from_checkpoint(ck, fetch_list=[pred.name],
                                          **_engine_kw())
    ref = InferenceEngine(d, **_engine_kw())
    try:
        assert eng.feed_names == [x.name]
        assert not any(op.type == "read"
                       for op in eng.program.global_block().ops)
        q = np.random.RandomState(7).rand(3, 6).astype("f")
        got, _ = eng.run_direct({x.name: q})
        want, _ = ref.run_direct({"x": q})
        np.testing.assert_array_equal(got[pred.name], want[fpred.name])
    finally:
        _close(eng, ref)
        scope.get(main.global_block().ops[0].inputs["Reader"][0]).close()


def _era_and_native_dirs(tmp_path):
    main, startup, _, pred = _build(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    era, native = str(tmp_path / "era"), str(tmp_path / "native")
    fluid.io.save_reference_model(era, ["x"], [pred], exe,
                                  main_program=main, scope=scope)
    fluid.io.save_inference_model(native, ["x"], [pred], exe, main,
                                  scope=scope)
    return era, native, pred


def test_model_format_reference_and_auto(tmp_path):
    era, native, pred = _era_and_native_dirs(tmp_path)
    q = np.random.RandomState(9).rand(3, 6).astype("f")
    engines = {fmt_dir: InferenceEngine(fmt_dir[1], model_format=fmt_dir[0],
                                        **_engine_kw())
               for fmt_dir in (("reference", era), ("auto", era),
                               ("auto", native), ("native", native))}
    jeng = JEngine(era, model_format="reference", batch_buckets=[4],
                   max_batch_size=4)
    try:
        want, _ = engines[("native", native)].run_direct({"x": q})
        for eng in engines.values():
            assert eng.feed_names == ["x"] and eng.fetch_names == [pred.name]
            got, _ = eng.run_direct({"x": q})
            np.testing.assert_array_equal(got[pred.name], want[pred.name])
        jwant, _ = jeng.run_direct({"x": q})
        np.testing.assert_allclose(want[pred.name], jwant[pred.name], **TOL)
        with pytest.raises(ValueError, match="wire type"):
            # a native directory read as the era wire: JSON is no protobuf
            InferenceEngine(native, model_format="reference",
                            **_engine_kw())
        with pytest.raises(ValueError, match="model_format"):
            InferenceEngine(native, model_format="onnx", **_engine_kw())
    finally:
        _close(*engines.values())
        jeng.close(drain=False)


def _post(url, payload):
    return json.loads(urllib.request.urlopen(urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}), timeout=30).read())


def test_model_server_predicts_over_both_engines(tmp_path):
    ck = str(tmp_path / "ck")
    _, _, _, pred = _train_and_save(ck)
    era, _, epred = _era_and_native_dirs(tmp_path)
    ckpt = InferenceEngine.from_checkpoint(
        ck, fetch_list=[pred.name], name="ckpt", max_queue_delay_ms=1,
        **_engine_kw())
    wire = InferenceEngine(era, name="era", model_format="reference",
                           max_queue_delay_ms=1, **_engine_kw())
    server = ModelServer({"ckpt": ckpt, "era": wire}, port=0).start()
    base = "http://%s" % server.address
    try:
        q = np.random.RandomState(10).rand(2, 6).astype("f")
        for eng, fetch in ((ckpt, pred.name), (wire, epred.name)):
            resp = _post(base + "/v1/models/%s:predict" % eng.name,
                         {"inputs": {"x": q.tolist()}})
            direct, _ = eng.run_direct({"x": q}, batch_bucket=4)
            np.testing.assert_array_equal(
                np.asarray(resp["outputs"][fetch], dtype="f"),
                direct[fetch])
        models = json.loads(urllib.request.urlopen(
            base + "/v1/models").read())
        assert sorted(m["name"] for m in models["models"]) == \
            ["ckpt", "era"]
    finally:
        server.shutdown()
        _forget(ckpt)
        _forget(wire)
