"""The port's iteration-level continuous decode (serving.DecodeEngine and
DecodeBatcher) on the CPU, mirroring tests/unittests/test_decode_serving.py
with the same decoder, slots, widths and seeds, and held to the JAX
package's DecodeEngine on models the JAX package saved.

The contract: each stream's tokens equal a solo decode of that stream
(row independence at the fixed [slots] shape, and admit rewriting EVERY
slot var's row); incremental delivery with admits mid-decode (trace-span
evidence); typed deadline / queue-full / closed errors; hard close
without a hang; drain completing every stream; the registry's decode
gauges; the solo clone sharing the weight tensors and no slot state.

Tolerances: tokens exact everywhere (argmax of the same fp32 logits on
one device, and across packages for these seeds); across packages the
final hidden rows within rtol 1e-5 / atol 1e-6 (fp32 products and tanh in
another order). build_slot_update_fn: the other rows bit-equal.

Global state each test restores: the trace ring (cleared) and the
registry's live decoders, batchers and windows (every engine a test makes
is unregistered when it closes).
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import serving as jserving

import paddle_tpu_torch as fluid
from paddle_tpu_torch import serving
from paddle_tpu_torch.core.lowering import build_slot_update_fn
from paddle_tpu_torch.observability import registry as obsreg
from paddle_tpu_torch.observability import trace

SLOTS, D, V, EOS = 4, 8, 16, 0
HIDDEN_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unregister(engine):
    """Drop an engine's decoder and window from the registry's live
    tables (they hold weak references; a closed engine a test still
    holds would otherwise stay on /metrics)."""
    b = engine._batcher
    for table, obj in ((obsreg._live_decoders, b),
                       (obsreg._live_windows, b._window)):
        with obsreg._note_lock:
            for label in [k for k, v in table.items() if v is obj]:
                del table[label]


def _close(engine):
    engine.close(drain=False)
    _unregister(engine)


def build_decoder(fl, slots=SLOTS, seed=7, layers=1, width=D, vocab=V,
                  layer_norm=False):
    """A decode-step program (the JAX test's build_decoder; `layers` tanh
    fcs, each followed by layer_norm when asked): carried token and
    hidden rows per slot, greedy argmax feedback, finished = (token ==
    EOS). One Executor.run = one decode iteration for every slot."""
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = seed
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        tok = fl.layers.create_global_var([slots, 1], 0, "int64",
                                          persistable=True, name="tok")
        h = fl.layers.create_global_var([slots, width], 0.0, "float32",
                                        persistable=True, name="h")
        ctx = fl.layers.create_global_var([slots, width], 0.0, "float32",
                                          persistable=True, name="ctx")
        z = fl.layers.concat([fl.layers.cast(tok, "float32"), h, ctx],
                             axis=1)
        for _ in range(layers):
            z = fl.layers.fc(input=z, size=width, act="tanh")
            if layer_norm:
                z = fl.layers.layer_norm(z, begin_norm_axis=1)
        logits = fl.layers.fc(input=z, size=vocab)
        nxt = fl.layers.reshape(fl.layers.argmax(logits, axis=1),
                                shape=[slots, 1])
        fin = fl.layers.equal(
            nxt, fl.layers.fill_constant([slots, 1], "int64", EOS))
        fl.layers.assign(nxt, output=tok)
        fl.layers.assign(z, output=h)
    return main, startup, nxt, fin


def make_engine(name, slots=SLOTS, **kw):
    main, startup, nxt, fin = build_decoder(fluid, slots=slots)
    return serving.DecodeEngine(program=main, startup_program=startup,
                                token_var=nxt, finished_var=fin,
                                max_slots=slots, name=name,
                                place=fluid.CPUPlace(), **kw)


def stream_feed(i, rng, width=D, vocab=V):
    return {"tok": np.array([i % (vocab - 1) + 1], dtype="int64"),
            "ctx": rng.randn(width).astype("float32")}


@pytest.fixture(scope="module")
def eng():
    e = make_engine("dec-test", default_max_new_tokens=12)
    yield e
    _close(e)


@pytest.fixture(scope="module")
def solo(eng):
    s = eng.solo_clone(name="dec-test-solo")
    yield s
    _close(s)


def toks(result):
    return np.asarray(result).reshape(-1)


def test_slot_vars_inferred_from_program_state(eng):
    # tok/h are written persistables, ctx a slot-shaped read-only
    # persistable: all three are rewritten at admit
    assert sorted(eng.slot_vars) == ["ctx", "h", "tok"]
    d = eng.describe()
    assert d["mode"] == "decode" and d["max_slots"] == SLOTS
    assert {s["name"]: s["row_shape"] for s in d["slot_vars"]} == {
        "tok": [1], "h": [D], "ctx": [D]}
    assert d["devices"] == ["cpu"]


def test_mixed_streams_bit_exact_vs_solo(eng, solo):
    """More concurrent streams than slots, mixed token budgets: pending
    waits, retires mid-flight and slot reuse. Every stream equals its
    solo decode exactly."""
    rng = np.random.RandomState(0)
    feeds = [stream_feed(i, rng) for i in range(7)]
    budgets = [3 + (i * 2) % 7 for i in range(7)]
    before = eng.decode_stats()
    streams = [None] * len(feeds)

    def client(i):
        streams[i] = eng.submit(feeds[i], max_new_tokens=budgets[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(feeds))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = [toks(s.result(60)) for s in streams]
    for i, g in enumerate(got):
        want = toks(solo.decode(feeds[i], max_new_tokens=budgets[i]))
        np.testing.assert_array_equal(g, want, err_msg="stream %d" % i)
        assert len(g) <= budgets[i]

    after = eng.decode_stats()
    assert after["streams_completed"] - before["streams_completed"] == \
        len(feeds)
    iters = after["iterations"] - before["iterations"]
    assert max(len(g) for g in got) <= iters < sum(len(g) for g in got)
    assert after["mean_slot_occupancy"] > 1.0


def test_incremental_delivery_and_admit_mid_decode(eng, solo):
    """Tokens arrive per iteration, and a stream submitted while another
    decodes is admitted at an iteration boundary: a decode_step span
    carries both stream ids after earlier ones carried only the first."""
    trace.clear()
    try:
        rng = np.random.RandomState(1)
        fa, fb = stream_feed(3, rng), stream_feed(9, rng)
        a = eng.submit(fa, max_new_tokens=10)
        first = a.next_token(timeout=30)
        assert first is not None and not a.done()
        a_count_at_b = a.token_count()
        b = eng.submit(fb, max_new_tokens=4)
        got_a = toks(a.result(60))
        got_b = toks(b.result(60))
        assert a_count_at_b < len(got_a)
        np.testing.assert_array_equal(got_a[0],
                                      np.asarray(first).reshape(-1))
        np.testing.assert_array_equal(
            got_a, toks(solo.decode(fa, max_new_tokens=10)))
        np.testing.assert_array_equal(
            got_b, toks(solo.decode(fb, max_new_tokens=4)))

        deadline = time.monotonic() + 10   # execute spans close async
        while time.monotonic() < deadline and trace.dump()["open"]:
            time.sleep(0.02)
        events = trace.dump()["events"]
        steps = [e for e in events if e["name"] == "serving/decode_step"]
        ids = {a.stream_id, b.stream_id}
        shared = [e for e in steps if ids <= set(e["args"]["streams"])]
        alone = [e for e in steps
                 if set(e["args"]["streams"]) == {a.stream_id}]
        assert shared and alone, "no iteration carried both streams"
        admits = [e for e in events if e["name"] == "serving/decode_admit"]
        assert {e["args"]["stream"] for e in admits} >= ids
        roots = {e["trace"] for e in events
                 if e["name"] == "serving/stream"}
        assert {a.trace, b.trace} <= roots
        step_traces = set()
        for e in steps:
            step_traces.update(e["args"]["traces"])
        assert {a.trace, b.trace} <= step_traces
        assert any(e["name"] == "serving/decode_execute" for e in events)
    finally:
        trace.clear()


def test_pending_deadline_expires_typed(eng):
    rng = np.random.RandomState(2)
    residents = [eng.submit(stream_feed(i, rng), max_new_tokens=8)
                 for i in range(SLOTS)]
    victim = eng.submit(stream_feed(11, rng), max_new_tokens=4,
                        deadline_ms=1)
    with pytest.raises(serving.DeadlineExceededError):
        victim.result(30)
    for s in residents:
        assert len(toks(s.result(60))) >= 1


def test_invalid_feed_rejected_typed(eng):
    with pytest.raises(serving.InvalidRequestError):
        eng.submit({"nonsense": np.zeros(3, dtype="float32")})
    with pytest.raises(serving.InvalidRequestError):
        eng.submit({"ctx": np.zeros(D + 1, dtype="float32")})


def test_drain_completes_all_streams(eng):
    rng = np.random.RandomState(3)
    streams = [eng.submit(stream_feed(i, rng), max_new_tokens=5)
               for i in range(6)]
    assert eng.drain(timeout=60)
    for s in streams:
        assert s.done()
        assert len(toks(s.result(1))) >= 1
    st = eng.decode_stats()
    assert st["occupied_slots"] == 0 and st["pending_streams"] == 0


def test_registry_exports_decode_gauges(eng):
    text = obsreg.REGISTRY.render_prometheus()
    assert "ptpu_decode_slots" in text
    assert 'decoder="dec-test' in text   # labels carry a #N suffix
    assert "ptpu_decode_tokens_total" in text


def test_queue_full_and_hard_close_typed_no_hang():
    e = make_engine("dec-close", slots=2, queue_capacity=1,
                    default_max_new_tokens=4096)
    try:
        rng = np.random.RandomState(4)
        residents = []
        for i in range(2):
            residents.append(e.submit(stream_feed(i, rng)))
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if e.decode_stats()["occupied_slots"] == i + 1:
                    break
                time.sleep(0.01)
            assert e.decode_stats()["occupied_slots"] == i + 1
        pending = e.submit(stream_feed(7, rng))
        with pytest.raises(serving.QueueFullError):
            e.submit(stream_feed(8, rng))
        while residents[0].token_count() < 3:
            time.sleep(0.005)
        t0 = time.monotonic()
        e.close(drain=False)
        assert time.monotonic() - t0 < 10, "hard close hung"
        for s in residents + [pending]:
            with pytest.raises(serving.ServingClosedError):
                s.result(5)
        assert residents[0].token_count() >= 3
        assert len(residents[0].tokens()) == residents[0].token_count()
        with pytest.raises(serving.ServingClosedError):
            e.submit(stream_feed(9, rng))
    finally:
        _close(e)


def test_solo_clone_shares_weights_not_state(eng, solo):
    """The clone's scope holds the engine's weight tensors themselves and
    slot tensors of its own; its decodes repeat and equal the engine's."""
    for n in eng._state_ro:
        if n not in eng.slot_vars:
            assert solo._scope.get(n) is eng._scope.get(n), n
    for n in eng.slot_vars:
        assert solo._scope.get(n).untyped_storage().data_ptr() != \
            eng._scope.get(n).untyped_storage().data_ptr(), n
    rng = np.random.RandomState(5)
    f = stream_feed(6, rng)
    a = toks(solo.decode(f, max_new_tokens=6))
    b = toks(solo.decode(f, max_new_tokens=6))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        a, toks(eng.decode(f, max_new_tokens=6)))


def test_validate_true_names_a11_and_default_checks_run():
    main, startup, nxt, fin = build_decoder(fluid)
    with pytest.raises(NotImplementedError, match="A11"):
        serving.DecodeEngine(program=main, startup_program=startup,
                             token_var=nxt, finished_var=fin,
                             max_slots=SLOTS, place="cpu", validate=True)
    with pytest.raises(ValueError, match="no variable"):
        serving.DecodeEngine(program=main, startup_program=startup,
                             token_var="absent", finished_var=fin,
                             max_slots=SLOTS, place="cpu")
    with pytest.raises(ValueError, match="leading dim"):
        serving.DecodeEngine(program=main, startup_program=startup,
                             token_var=nxt, finished_var=fin,
                             max_slots=SLOTS + 1, place="cpu",
                             slot_vars=["h"])


# ------------------------------------------------- build_slot_update_fn --

def test_slot_update_writes_one_row_in_place():
    """One row rewritten; every other row's bits and the tensor objects
    and storages stay (a graph that holds the pointer keeps seeing it)."""
    rng = np.random.RandomState(8)
    state = (torch.from_numpy(rng.randn(4, 3).astype("float32")),
             torch.from_numpy(rng.randint(0, 9, (4, 1)).astype("int64")))
    before = [s.clone() for s in state]
    ptrs = [s.untyped_storage().data_ptr() for s in state]
    fn = build_slot_update_fn()
    rows = (np.array([9.0, 8.0, 7.0], "float32"), np.array([5], "int64"))
    out = fn(state, 2, rows)
    for s, o, b, p, r in zip(state, out, before, ptrs, rows):
        assert o is s and o.untyped_storage().data_ptr() == p
        np.testing.assert_array_equal(o[2].numpy(), r)
        keep = [0, 1, 3]
        np.testing.assert_array_equal(o[keep].numpy(), b[keep].numpy())


def test_slot_update_takes_a_non_contiguous_state():
    base = torch.zeros(3, 1).expand(3, 4)          # stride 0: no row write
    out, = build_slot_update_fn()((base,), 1, (np.ones(4, "float32"),))
    assert out is not base and out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(),
                                  [[0] * 4, [1] * 4, [0] * 4])


# ----------------------------------------------------- the JAX package --

def _save_jax_decoder(path, **kw):
    """A decode step built, initialized and saved by the JAX package,
    with the state assigns' outputs among the fetch targets (token and
    finished first), so save_inference_model keeps them."""
    main, startup, nxt, fin = build_decoder(jfluid, **kw)
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        block = main.global_block()
        jfluid.io.save_inference_model(
            path, [], [nxt, fin, block.var("tok"), block.var("h")], exe,
            main)


def _decode_one_at_a_time(engine, feeds, budget):
    """Each stream alone, then its slot's final hidden row."""
    out = []
    for f in feeds:
        s = engine.submit(f, max_new_tokens=budget)
        got = toks(s.result(120))
        h = np.asarray(engine._scope.get("h"))[s.slot]
        out.append((got, np.array(h, dtype="float32")))
    return out


@pytest.mark.parametrize("kw", [
    dict(),
    dict(layers=2, width=16, layer_norm=True, vocab=32),
], ids=["bench_step", "layer_norm_step"])
def test_decode_matches_the_jax_engine_on_its_saved_model(tmp_path, kw):
    """One decode step saved by the JAX package, served by the JAX
    DecodeEngine and by the port's DecodeEngine(model_dir): 8 seeded
    streams give the same tokens, and the final h rows agree within
    HIDDEN_TOL. The second case is chip_smoke.py's phase 31 (b) step (a
    layer_norm after each hidden fc) at 2 layers, width 16."""
    path = str(tmp_path / "decoder")
    _save_jax_decoder(path, **kw)
    width, vocab = kw.get("width", D), kw.get("vocab", V)
    rng = np.random.RandomState(10)
    feeds = [stream_feed(i, rng, width, vocab) for i in range(8)]
    jeng = jserving.DecodeEngine(path, max_slots=SLOTS, name="jax-dec")
    teng = serving.DecodeEngine(path, max_slots=SLOTS, name="port-dec",
                                place=fluid.CPUPlace())
    try:
        assert sorted(teng.slot_vars) == sorted(jeng.slot_vars) == \
            ["ctx", "h", "tok"]
        want = _decode_one_at_a_time(jeng, feeds, 10)
        got = _decode_one_at_a_time(teng, feeds, 10)
        for i, ((gt, gh), (wt, wh)) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(gt, wt, err_msg="stream %d" % i)
            np.testing.assert_allclose(gh, wh, err_msg="stream %d" % i,
                                       **HIDDEN_TOL)
        # continuous batching on the port gives the same tokens again
        streams = [teng.submit(f, max_new_tokens=10) for f in feeds]
        for i, s in enumerate(streams):
            np.testing.assert_array_equal(toks(s.result(120)), want[i][0])
    finally:
        jeng.close(drain=False)
        _close(teng)


def test_model_dir_format_and_fetch_checks(tmp_path):
    """A native directory read as the era wire fails in the wire parser,
    and "auto" on a directory with no __model_meta__.json reads it as an
    era-wire one (no __model__ there), as in the JAX package."""
    path = str(tmp_path / "decoder")
    _save_jax_decoder(path)
    for eng in (serving.DecodeEngine, jserving.DecodeEngine):
        with pytest.raises(ValueError, match="wire type"):
            eng(path, model_format="reference", place="cpu")
    os.makedirs(str(tmp_path / "empty"))
    for eng in (serving.DecodeEngine, jserving.DecodeEngine):
        with pytest.raises(FileNotFoundError, match="__model__"):
            eng(str(tmp_path / "empty"), place="cpu")
