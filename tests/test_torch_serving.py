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

The sequence half: the JAX package saves the sentiment conv net
(dictionary 50, embedding 8, 16 filters, SQRT pools) and answers LoD
requests with its masked-pool kernel in interpret mode; the port's engine
serves the same directory with LoD feeds and (batch, seq) buckets.

The engine's own surface: warmup(buckets=), the in-memory form
(program=, feed_names=, fetch_vars=) under the JAX test's per-fetch row
policy with describe() and submit_normalized(), and the options that
raise naming the item they wait for (validate=True: A11; the era-wire
format: A8; tp: A10).
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
# every counted kernel (K1-K9, K1-K3's bf16 instantiations, the while
# node's set_while_condition)
_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkdv",
            "flash_attention_bwd_dq", "softmax_xent_fwd", "layer_norm_fwd",
            "fused_lstm", "fused_lstmp", "masked_softmax", "masked_pool",
            "flash_attention_fwd_bf16", "flash_attention_bwd_dkdv_bf16",
            "flash_attention_bwd_dq_bf16", "set_while_condition")
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
        _, _, predict = ttr.transformer(VOCAB, VOCAB, T,
                                        use_fused_attention=True, **CFG)
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


# ---------------------------------------------------------------------------
# sequence (LoD) feeds: the sentiment conv net (dictionary 50, emb 8,
# 16 filters) saved by the JAX package
# ---------------------------------------------------------------------------

SEQ_DICT = 50


def _seq_requests(seed, lens=(3, 7, 12, 1)):
    """One-review requests as lists of [len, 1] int64 id arrays."""
    rng = np.random.RandomState(seed)
    return [{"words": [rng.randint(0, SEQ_DICT, (n, 1)).astype("int64")]}
            for n in lens]


@pytest.fixture(scope="module")
def jax_seq_model(tmp_path_factory):
    """The JAX package's saved conv sentiment model and its engine's
    answers to _seq_requests(0) (masked-pool kernel in interpret mode)."""
    from paddle_tpu.models import understand_sentiment as jsent
    model_dir = str(tmp_path_factory.mktemp("jax_sentiment"))
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        words = jfluid.layers.data(name="words", shape=[1], dtype="int64",
                                   lod_level=1)
        pred = jsent.convolution_net(words, SEQ_DICT, 2, 8, 16)
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        jfluid.io.save_inference_model(model_dir, ["words"], [pred], exe,
                                       main)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_PALLAS", "seq")
        engine = jserving.InferenceEngine(model_dir, batch_buckets=[4],
                                          seq_buckets=[8, 16],
                                          pipeline_depth=0)
        try:
            futures = [engine.submit(r) for r in _seq_requests(0)]
            answers = [f.result(120).numpy()[pred.name] for f in futures]
        finally:
            engine.close()
    return model_dir, pred.name, answers


def test_jax_saved_sequence_model_serves_in_the_port(jax_seq_model):
    model_dir, fetch, want = jax_seq_model
    engine = InferenceEngine(model_dir, device="cpu", batch_buckets=[4],
                             seq_buckets=[8, 16])
    try:
        assert engine._seq_feeds == {"words"}
        futures = [engine.submit(r) for r in _seq_requests(0)]
        for fut, w in zip(futures, want):
            got = fut.result(120).numpy()[fetch]
            assert got.shape == w.shape == (1, 2)
            np.testing.assert_allclose(got, w, **TOL)
    finally:
        engine.close()


def test_seq_bucket_choice(jax_seq_model, port_engine):
    """The default seq buckets (none for a model with no sequence feed),
    explicit ones sorted, and the covering (batch, seq) bucket of a
    request; a sequence longer than the largest bucket is refused at
    submit."""
    assert port_engine.seq_buckets == []
    assert port_engine._pick_buckets(3, 0) == (4, None)
    engine = InferenceEngine(jax_seq_model[0], device="cpu",
                             batch_buckets=[1, 2, 4], warmup=False)
    try:
        assert engine.seq_buckets == [16, 32, 64, 128, 256]
        assert engine._pick_buckets(3, 17) == (4, 32)
        assert engine._pick_buckets(1, 16) == (1, 16)
        assert engine._pick_buckets(2, 0) == (2, 16)
        req = _seq_requests(1, lens=(40,))[0]
        _, bucket = engine.run_direct(req)
        assert bucket == (1, 64)
        with pytest.raises(InvalidRequestError, match="sequence length"):
            engine.submit(_seq_requests(1, lens=(257,))[0])
        with pytest.raises(InvalidRequestError, match="cannot hold"):
            engine.run_direct(req, seq_bucket=32)
    finally:
        engine.close()
    explicit = InferenceEngine(jax_seq_model[0], device="cpu",
                               batch_buckets=[1], warmup=False,
                               seq_buckets=[32, 8, 8])
    try:
        assert explicit.seq_buckets == [8, 32]
    finally:
        explicit.close()


@pytest.mark.parametrize("buckets", [[4], [1, 2, 4]])
def test_coalesced_sequence_answers_equal_run_direct(jax_seq_model,
                                                     buckets):
    """Ragged requests, of one and of several sequences, coalesce into one
    (batch, seq) bucket; each equals run_direct at its recorded buckets,
    bit for bit."""
    engine = InferenceEngine(jax_seq_model[0], device="cpu",
                             batch_buckets=buckets, seq_buckets=[8, 16],
                             max_queue_delay_ms=50)
    try:
        rng = np.random.RandomState(4)
        reqs = _seq_requests(2, lens=(3, 12)) + [{"words": [
            rng.randint(0, SEQ_DICT, (n, 1)).astype("int64")
            for n in (5, 2)]}]
        futures = [engine.submit(r) for r in reqs]
        for req, fut in zip(reqs, futures):
            got = fut.result(120).numpy()
            direct, bucket = engine.run_direct(req, *fut.bucket)
            assert bucket == fut.bucket and bucket[1] in (8, 16)
            for name in engine.fetch_names:
                assert got[name].shape[0] == len(req["words"])
                np.testing.assert_array_equal(direct[name], got[name])
        assert engine.metrics.snapshot()["errors_total"] == 0
    finally:
        engine.close()


def test_lodtensor_and_list_feeds_agree(jax_seq_model):
    from paddle_tpu_torch.core.lod import LoDTensor
    engine = InferenceEngine(jax_seq_model[0], device="cpu",
                             batch_buckets=[2], seq_buckets=[8],
                             max_queue_delay_ms=1)
    try:
        rng = np.random.RandomState(7)
        seqs = [rng.randint(0, SEQ_DICT, (n, 1)).astype("int64")
                for n in (4, 6)]
        a = engine.infer({"words": seqs})
        b = engine.infer({"words": LoDTensor.from_sequences(seqs)})
        for name in engine.fetch_names:
            np.testing.assert_array_equal(a[name], b[name])
    finally:
        engine.close()


def test_pad_rows_carry_length_one_over_zeros(jax_seq_model):
    engine = InferenceEngine(jax_seq_model[0], device="cpu",
                             batch_buckets=[4], seq_buckets=[8, 16],
                             warmup=False)
    try:
        norm = engine.normalize_feed(_seq_requests(3, lens=(5,))[0])
        feed = engine._pad_batch([norm], 4, 8)
        assert feed["words"].shape == (4, 8, 1)
        np.testing.assert_array_equal(feed["words@SEQLEN"], [5, 1, 1, 1])
        assert feed["words@SEQLEN"].dtype == np.int32
        assert not feed["words"][1:].any() and not feed["words"][0, 5:].any()
    finally:
        engine.close()


def test_malformed_sequence_requests_are_refused(jax_seq_model):
    from paddle_tpu_torch.core.lod import LoDTensor
    engine = InferenceEngine(jax_seq_model[0], device="cpu",
                             batch_buckets=[4], seq_buckets=[8, 16],
                             warmup=False)
    ok = np.zeros((3, 1), np.int64)
    try:
        with pytest.raises(InvalidRequestError, match="empty sequence"):
            engine.submit({"words": [ok, np.zeros((0, 1), np.int64)]})
        with pytest.raises(InvalidRequestError, match="zero sequences"):
            engine.submit({"words": []})
        nested = LoDTensor(np.zeros((4, 1), np.int64), [[0, 1, 2], [0, 2, 4]])
        with pytest.raises(InvalidRequestError, match="multi-level"):
            engine.submit({"words": nested})
        with pytest.raises(InvalidRequestError, match="per-token shape"):
            engine.submit({"words": [np.zeros((3, 2), np.int64)]})
        with pytest.raises(InvalidRequestError, match="LoDTensor"):
            engine.submit({"words": np.zeros((1, 3, 1), np.int64)})
        assert engine.metrics.snapshot()["batches_total"] == 0
    finally:
        engine.close()


def test_warmup_covers_the_batch_by_seq_lattice(jax_seq_model,
                                                monkeypatch):
    shapes = []
    real = InferenceEngine._run

    def spy(self, feed):
        shapes.append((feed["words"].shape, tuple(feed["words@SEQLEN"])))
        return real(self, feed)

    monkeypatch.setattr(InferenceEngine, "_run", spy)
    engine = InferenceEngine(jax_seq_model[0], device="cpu",
                             batch_buckets=[1, 2], seq_buckets=[8, 16, 32])
    try:
        assert sorted(s for s, _ in shapes) == sorted(
            (b, t, 1) for b in (1, 2) for t in (8, 16, 32))
        assert all(set(lens) == {1} for _, lens in shapes)
        del shapes[:]
        assert engine.warmup() == 6 and len(shapes) == 6
    finally:
        engine.close()


def test_warmup_takes_explicit_buckets(jax_seq_model, monkeypatch):
    """warmup(buckets=) runs only the (batch, seq) pairs it is given."""
    shapes = []
    real = InferenceEngine._run

    def spy(self, feed):
        shapes.append(feed["words"].shape[:2])
        return real(self, feed)

    engine = InferenceEngine(jax_seq_model[0], device="cpu",
                             batch_buckets=[1, 2], seq_buckets=[8, 16],
                             warmup=False)
    monkeypatch.setattr(InferenceEngine, "_run", spy)
    try:
        assert engine.warmup(buckets=[(2, 16), (1, 8)]) == 2
        assert shapes == [(2, 16), (1, 8)]
    finally:
        engine.close()


def test_in_memory_program_fetch_row_policy():
    """The in-memory form (program=, feed_names=, fetch_vars=), with the
    JAX test's per-fetch row policy: a fetched PARAMETER whose leading
    dim equals the bucket comes back whole, a batch output ("rows") and a
    non-persistable fetch with a concrete leading dim equal to the bucket
    ("dynamic") come back as the request's rows. describe() and
    submit_normalized() serve it as they serve a loaded model."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[6], dtype="float32")
        pred = tfluid.layers.fc(input=x, size=3, bias_attr=False,
                                param_attr=tfluid.ParamAttr(name="w_fc"))
        fixed = tfluid.layers.fill_constant(shape=[6, 2], dtype="float32",
                                            value=3.0)
    engine = InferenceEngine(
        program=main, feed_names=["x"],
        fetch_vars=[pred, main.global_block().var("w_fc"), fixed],
        batch_buckets=[6], max_queue_delay_ms=1, warmup=False,
        validate=False, device="cpu")
    try:
        tfluid.Executor("cpu").run(startup, scope=engine._scope)
        engine.warmup()
        rng = np.random.RandomState(2)
        out = engine.infer({"x": rng.rand(2, 6).astype("f")})
        assert out[engine.fetch_names[0]].shape == (2, 3)   # rows
        assert out["w_fc"].shape == (6, 3)                  # whole
        assert out[fixed.name].shape == (2, 2)              # dynamic
        norm = engine.normalize_feed({"x": rng.rand(1, 6).astype("f")})
        got = engine.submit_normalized(norm).result(30).numpy()
        assert got[engine.fetch_names[0]].shape == (1, 3)
        d = engine.describe()
        assert d["name"] == "model" and d["devices"] == ["cpu"]
        assert d["weights_dtype"] == "fp32" and d["tp"] is None
        assert d["feeds"] == [{"name": "x", "shape": [-1, 6],
                               "dtype": "float32", "sequence": False}]
        assert d["metrics"]["responses_total"] == 2
    finally:
        engine.close()


def test_engine_options_waiting_for_later_items(jax_model):
    """validate=True (the analysis tier, A11), the era-wire format (A8)
    and tp (A10) raise naming their item; a program without fetches it
    names is refused."""
    with pytest.raises(NotImplementedError, match="A11"):
        InferenceEngine(jax_model[0], device="cpu", validate=True)
    with pytest.raises(NotImplementedError, match="A8"):
        InferenceEngine(jax_model[0], device="cpu", model_format="reference")
    with pytest.raises(NotImplementedError, match="A10"):
        InferenceEngine(jax_model[0], device="cpu", tp=2)
    with pytest.raises(ValueError, match="in-memory program needs"):
        InferenceEngine(program=tfluid.Program(), device="cpu")
