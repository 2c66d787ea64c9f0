"""The port's serving slice against the JAX package, end to end on the CPU.

The JAX package builds a small Transformer scoring model (2+2 layers,
4 heads, d_key 16, d_model 64, d_inner 128, vocab 100, T=32) with fused
attention and saves it with save_inference_model. Its InferenceEngine
answers three requests with its Pallas kernels in interpret mode
(FLAGS_flash_min_seq=0, PADDLE_TPU_PALLAS=1). The port's
InferenceEngine(device="cpu") loads the same directory and answers the
same requests through its kernel wrappers' plain versions.

Tolerance for logits: rtol = atol = 1e-4 — 12 fp32 layers on each side,
summed in a different order. Coalesced answers against run_direct at the
same bucket: bit for bit (one device, one shape, the same arithmetic).
Inputs and requests are made with numpy from a seed.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import serving as jserving
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops import cuda_kernels as ck
from paddle_tpu_torch.serving import InferenceEngine
from paddle_tpu_torch.serving.batcher import (DeadlineExceededError,
                                              RequestTooLargeError)
from paddle_tpu_torch.serving.engine import InvalidRequestError

VOCAB, T = 100, 32
CFG = dict(n_layer=2, n_head=4, d_key=16, d_value=16, d_model=64,
           d_inner_hid=128)
TOL = dict(rtol=1e-4, atol=1e-4)
# every counted kernel wrapper (K1-K5)
_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkdv",
            "flash_attention_bwd_dq", "softmax_xent_fwd", "layer_norm_fwd")
FEEDS = ttr.SCORING_FEED_NAMES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes are tiny: one intra-op thread does, and leaves the other
    test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(seed, n=3):
    """n one-row scoring requests with source and target lengths 5-32."""
    rng = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        src = rng.randint(3, VOCAB, rng.randint(5, T + 1)).tolist()
        trg = rng.randint(3, VOCAB, rng.randint(5, T + 1)).tolist()
        reqs.append(ttr.prepare_batch([src], [trg], T))
    return reqs


def _jax_build():
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        _, _, predict = jtr.transformer(VOCAB, VOCAB, T,
                                        use_fused_attention=True, **CFG)
    return main, startup, predict


def _port_build():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        _, _, predict = ttr.transformer(VOCAB, VOCAB, T, **CFG)
    return main, startup, predict


def _saved_arrays(model_dir):
    """{name: array} of a save_inference_model directory's parameters."""
    with open(os.path.join(model_dir, "manifest.json")) as f:
        manifest = json.load(f)
    return {name: np.load(os.path.join(model_dir, meta["file"]))
            for name, meta in manifest.items()}


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """The JAX package's saved scoring model and its engine's answers to
    _requests(0): (model_dir, pruned program, fetch name, answers)."""
    model_dir = str(tmp_path_factory.mktemp("jax_transformer"))
    main, startup, predict = _jax_build()
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        program = jfluid.io.save_inference_model(model_dir, FEEDS, [predict],
                                                 exe, main)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLAGS_flash_min_seq", "0")
        mp.setenv("PADDLE_TPU_PALLAS", "1")
        engine = jserving.InferenceEngine(model_dir, batch_buckets=[4],
                                          pipeline_depth=0)
        try:
            futures = [engine.submit(r) for r in _requests(0)]
            answers = [f.result(120).numpy()[predict.name] for f in futures]
        finally:
            engine.close()
    return model_dir, program, predict.name, answers


@pytest.fixture(scope="module")
def port_engine(jax_model):
    engine = InferenceEngine(jax_model[0], device="cpu",
                             batch_buckets=[1, 4])
    yield engine
    engine.close()


def test_port_engine_answers_like_the_jax_engine(jax_model, port_engine):
    _, _, fetch, want = jax_model
    futures = [port_engine.submit(r) for r in _requests(0)]
    for fut, w in zip(futures, want):
        got = fut.result(120).numpy()[fetch]
        assert got.shape == w.shape == (1, T, VOCAB)
        np.testing.assert_allclose(got, w, **TOL)


def test_port_engine_ran_both_kernel_ops_through_their_wrappers(
        jax_model, port_engine):
    """The loaded program holds 3 fused_attention and 5+2 layer_norm ops
    per layer pair; on the CPU the wrappers take their plain versions and
    launch no kernel."""
    ops = port_engine.program.global_block().ops
    assert sum(op.type == "fused_attention" for op in ops) == 3 * 2
    assert sum(op.type == "layer_norm" for op in ops) == 5 * 2 + 2
    ck.reset_launch_counts()
    port_engine.run_direct(_requests(1, 1)[0])
    assert ck.launch_counts() == dict.fromkeys(_KERNELS, 0)


def test_jax_saved_int_feeds_load_in_the_port(jax_model, port_engine):
    """With x64 off the JAX package declares the int64 token feeds int32;
    the port takes the declaration as it stands and still accepts int64
    request arrays."""
    _, program, _, _ = jax_model
    declared = {n: program.global_block().var(n).dtype for n in FEEDS}
    for n in FEEDS:
        assert str(port_engine._feed_vars[n].dtype) == str(declared[n])
    req = _requests(2, 1)[0]
    assert req["src_word"].dtype == np.int64
    out = port_engine.infer(req)
    assert np.isfinite(out[port_engine.fetch_names[0]]).all()


@pytest.mark.parametrize("buckets", [[4], [1, 2, 4]])
def test_coalesced_answers_equal_run_direct_bit_for_bit(jax_model, buckets):
    engine = InferenceEngine(jax_model[0], device="cpu",
                             batch_buckets=buckets, max_queue_delay_ms=50)
    try:
        reqs = _requests(3)
        futures = [engine.submit(r) for r in reqs]
        got = [f.result(120).numpy() for f in futures]
        for req, fut, g in zip(reqs, futures, got):
            direct, bucket = engine.run_direct(req,
                                               batch_bucket=fut.bucket[0])
            assert bucket == fut.bucket
            for name in engine.fetch_names:
                np.testing.assert_array_equal(direct[name], g[name])
        snap = engine.metrics.snapshot()
        assert snap["responses_total"] == len(reqs)
        assert snap["errors_total"] == 0
    finally:
        engine.close()


def test_port_builder_matches_the_jax_builder():
    """Same op sequence (types, slots, argument names, attrs) and the same
    parameter names and shapes in the pruned scoring programs."""
    jmain, _, jpred = _jax_build()
    tmain, _, tpred = _port_build()
    assert tpred.name == jpred.name
    jprog = jmain.prune([jpred.name], for_test=True)
    tprog = tmain.prune([tpred.name], for_test=True)
    jops, tops = jprog.global_block().ops, tprog.global_block().ops
    assert [op.type for op in tops] == [op.type for op in jops]
    for j, t in zip(jops, tops):
        assert t.inputs == j.inputs, t.type
        assert t.outputs == j.outputs, t.type
        assert set(t.attrs) == set(j.attrs), t.type
        for key, jval in j.attrs.items():
            tval = t.attrs[key]
            if isinstance(jval, np.ndarray):
                np.testing.assert_array_equal(tval, jval)
            else:
                assert tval == jval, (t.type, key)
    jparams = {p.name: tuple(p.shape) for p in jmain.all_parameters()}
    tparams = {p.name: tuple(p.shape) for p in tmain.all_parameters()}
    assert tparams == jparams


def test_port_saved_model_loads_in_the_jax_package(tmp_path, jax_model):
    """The port's save_inference_model writes the JAX package's format:
    the JAX package loads it and scores like the port does."""
    main, startup, predict = _port_build()
    exe = tfluid.Executor("cpu")
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tio.save_inference_model(str(tmp_path), FEEDS, [predict], exe, main,
                             scope=scope)
    req = _requests(4, 1)[0]
    engine = InferenceEngine(str(tmp_path), device="cpu", batch_buckets=[1])
    try:
        got = engine.infer(req)[predict.name]
    finally:
        engine.close()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope), pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLAGS_flash_min_seq", "0")
        mp.setenv("PADDLE_TPU_PALLAS", "1")
        program, feed_names, fetch_vars = jfluid.io.load_inference_model(
            str(tmp_path), jexe)
        assert feed_names == FEEDS
        want, = jexe.run(program, feed=req, fetch_list=fetch_vars)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_scope_from_numpy_carries_jax_weights_to_the_port(jax_model):
    """The port's own builder, run with the JAX model's weights carried
    across by name, scores like the JAX engine."""
    model_dir, _, fetch, want = jax_model
    main, _, predict = _port_build()
    scope = tio.scope_from_numpy(_saved_arrays(model_dir), "cpu",
                                 program=main)
    assert scope.get(fetch) is None
    main = main.prune([predict.name], for_test=True)  # drop the loss
    exe = tfluid.Executor("cpu")
    for req, w in zip(_requests(0), want):
        got, = exe.run(main, feed=req, fetch_list=[predict], scope=scope)
        np.testing.assert_allclose(got, w, **TOL)


def test_scope_from_numpy_checks_names_and_shapes(jax_model):
    main, _, _ = _port_build()
    arrays = _saved_arrays(jax_model[0])
    scope = tio.scope_from_numpy(arrays, "cpu", program=main)
    emb = scope.get("embedding_0.w_0")
    assert emb.device.type == "cpu" and emb.dtype == torch.float32
    np.testing.assert_array_equal(emb.numpy(), arrays["embedding_0.w_0"])
    missing = dict(arrays)
    del missing["fc_0.w_0"]
    with pytest.raises(ValueError, match="fc_0.w_0: missing"):
        tio.scope_from_numpy(missing, "cpu", program=main)
    wrong = dict(arrays, **{"fc_0.w_0": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="fc_0.w_0: shape"):
        tio.scope_from_numpy(wrong, "cpu", program=main)


def test_engine_rejects_malformed_requests(port_engine):
    req = _requests(5, 1)[0]
    with pytest.raises(InvalidRequestError, match="missing feeds"):
        port_engine.submit({k: v for k, v in req.items() if k != "trg_len"})
    with pytest.raises(InvalidRequestError, match="unknown feeds"):
        port_engine.submit(dict(req, extra=np.zeros((1, 1))))
    with pytest.raises(InvalidRequestError, match="per-row shape"):
        port_engine.submit(dict(req, src_word=req["src_word"][:, :5]))
    with pytest.raises(InvalidRequestError, match="batch rows"):
        port_engine.submit(dict(req, src_pos=np.repeat(req["src_pos"], 2, 0)))
    with pytest.raises(RequestTooLargeError):
        port_engine.submit({k: np.repeat(v, 5, 0) for k, v in req.items()})
    with pytest.raises(InvalidRequestError, match="cannot hold"):
        port_engine.run_direct({k: np.repeat(v, 2, 0)
                                for k, v in req.items()}, batch_bucket=1)


def test_expired_deadline_never_reaches_the_device(jax_model):
    engine = InferenceEngine(jax_model[0], device="cpu", batch_buckets=[1],
                             warmup=False, max_queue_delay_ms=1)
    try:
        fut = engine.submit(_requests(6, 1)[0], deadline_ms=-1)
        with pytest.raises(DeadlineExceededError):
            fut.result(60)
        snap = engine.metrics.snapshot()
        assert snap["deadline_expired"] == 1 and snap["batches_total"] == 0
    finally:
        engine.close()


def test_pipelined_dispatch_is_not_ported_yet(jax_model):
    with pytest.raises(NotImplementedError, match="pipeline_depth"):
        InferenceEngine(jax_model[0], device="cpu", batch_buckets=[1],
                        warmup=False, pipeline_depth=2)
