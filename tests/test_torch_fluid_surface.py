"""The fluid surface of ROADMAP A12 on the port: Places, scopes, the rest
of `io`, DataFeeder, readers, WeightedAverage, metrics, evaluators and
the concurrency names, held to the JAX package's where both can run, and
the book's verbatim migration scripts run unmodified on the port.

`fluid.CPUPlace()` is the CPU because the caller asked for it;
`CUDAPlace(i)` and `TPUPlace(i)` are card i and raise where there is no
card, as the default device does. The four scripts of
tests/book/test_migration_verbatim.py run with `fluid` bound to
paddle_tpu_torch (their text untouched) and are held to that file's own
assertions, which its test functions make: only its `_run_script` is
swapped for one that binds the port. Inputs are made with numpy from a
seed.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import reader as jreader
from paddle_tpu.datasets import movielens as jmovielens
from paddle_tpu.models import recommender_system as jrec

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.models import recommender_system as trec

ROOT = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ places --

def test_places_name_devices():
    assert texecutor.resolve_device(tfluid.CPUPlace()) == torch.device("cpu")
    assert tfluid.Executor(tfluid.CPUPlace()).device.type == "cpu"
    assert tfluid.CUDAPlace(1).torch_device() == "cuda:1"
    assert tfluid.TPUPlace().torch_device() == "cuda:0"
    assert isinstance(tfluid.CUDAPlace(0), tfluid.TPUPlace)
    have = torch.cuda.is_available()
    assert tfluid.is_compiled_with_cuda() is have
    assert tfluid.is_compiled_with_tpu() is have


def test_card_places_raise_without_a_card(monkeypatch):
    """CUDAPlace, TPUPlace and the default all mean the card: with none,
    each raises; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for place in (tfluid.CUDAPlace(0), tfluid.TPUPlace(), None):
        with pytest.raises(RuntimeError, match="CUDA device"):
            tfluid.Executor(place)
    assert tfluid.is_compiled_with_cuda() is False


def test_create_lod_tensor_takes_a_place():
    t = tfluid.create_lod_tensor(np.arange(5).reshape(5, 1), [[2, 3]],
                                 tfluid.CPUPlace())
    assert t.lod == [[0, 2, 5]]


# ------------------------------------------------------------ scopes --

def _fit(fluid, lr=0.1):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        avg = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.Adam(learning_rate=lr).minimize(avg)
    return main, startup, avg


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(8, 3).astype(np.float32)
    return {"x": x, "y": x.sum(1, keepdims=True)}


def test_scope_guard_switch_scope_and_fetch_var():
    """Executor.run and fetch_var read the global scope scope_guard sets;
    switch_scope returns the scope it replaced; get_var finds a program's
    variable by name."""
    main, startup, avg = _fit(tfluid)
    outer = tfluid.global_scope()
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        assert tfluid.global_scope() is scope
        exe.run(startup)
        exe.run(main, feed=_feed(), fetch_list=[avg])
        w = tfluid.fetch_var("fc_0.w_0")
        assert w.shape == (3, 1)
        assert tfluid.fetch_var("fc_0.w_0", return_numpy=False).dtype == \
            torch.float32
        with pytest.raises(RuntimeError, match="cannot find variable"):
            tfluid.fetch_var("nothing")
    assert tfluid.global_scope() is outer
    assert not outer.has("fc_0.w_0")
    np.testing.assert_array_equal(tfluid.fetch_var("fc_0.w_0", scope), w)
    old = tfluid.switch_scope(scope)
    try:
        assert old is outer and tfluid.global_scope() is scope
    finally:
        tfluid.switch_scope(old)
    assert tfluid.get_var("fc_0.w_0", main) is main.global_block().var(
        "fc_0.w_0")
    with pytest.raises(TypeError):
        tfluid.get_var("fc_0.w_0", "not a program")


def test_kid_scopes_and_default_scope_funcs():
    """A kid scope sees its parents' vars and shadows them; the
    thread-local stack of default_scope_funcs behaves as the JAX
    package's."""
    seen = []
    for fluid in (jfluid, tfluid):
        dsf = fluid.default_scope_funcs
        root = fluid.Scope()
        root.set("a", np.ones(2, np.float32))
        kid = root.new_scope()
        assert kid.parent() is root and kid.find_var("a") is not None
        kid.var("b").set(np.zeros(3, np.float32))
        assert root.find_var("b") is None and kid.has("a")
        got = []

        def body():
            dsf.var("t").set(np.full(2, 7.0, np.float32))
            got.append(np.asarray(dsf.find_var("t").get_tensor()).tolist())
            got.append(dsf.find_var("missing") is None)

        with fluid.scope_guard(root):
            dsf.scoped_function(body)
            got.append(dsf.find_var("t") is None)
        seen.append(got)
    assert seen[0] == seen[1] == [[7.0, 7.0], True, True]


# ---------------------------------------------------------------- io --

def test_persistables_round_trip(tmp_path):
    """save_persistables keeps the Adam moments, beta pows and learning
    rate; load_persistables into a fresh scope gives the same next step;
    the JAX package loads the port's files and its next step agrees."""
    main, startup, avg = _fit(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        for s in range(3):
            exe.run(main, feed=_feed(s), fetch_list=[avg])
        tfluid.save_persistables(exe, str(tmp_path), main)
        want = exe.run(main, feed=_feed(9), fetch_list=[avg])[0]
    names = {v.name for v in main.list_vars() if v.persistable}
    assert any("moment" in n for n in names)
    fresh = tfluid.Scope()
    with tfluid.scope_guard(fresh):
        tfluid.load_persistables(exe, str(tmp_path), main)
        assert set(fresh.names()) == names
        got = exe.run(main, feed=_feed(9), fetch_list=[avg])[0]
    np.testing.assert_array_equal(got, want)
    jmain, _, javg = _fit(jfluid)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jfluid.load_persistables(jexe, str(tmp_path), jmain)
        jgot = jexe.run(jmain, feed=_feed(9), fetch_list=[javg])[0]
    np.testing.assert_allclose(np.ravel(jgot), np.ravel(want), rtol=1e-5)


def test_io_keywords_and_partial_saves(tmp_path):
    """filename and params_filename are taken as in the JAX package; a
    var with no value or no file raises unless allow_missing=True."""
    main, startup, avg = _fit(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        with pytest.raises(RuntimeError, match="allow_missing"):
            tfluid.save_params(exe, str(tmp_path / "p"), main)
        tfluid.save_params(exe, str(tmp_path / "p"), main, filename=None,
                           allow_missing=True)
        exe.run(startup)
        tfluid.save_params(exe, str(tmp_path / "p"), main)
        with pytest.raises(RuntimeError, match="not in the manifest"):
            tfluid.load_persistables(exe, str(tmp_path / "p"), main)
        tfluid.load_persistables(exe, str(tmp_path / "p"), main,
                                 allow_missing=True)
        tfluid.load_params(exe, str(tmp_path / "p"), main, filename=None)
        tfluid.save_inference_model(str(tmp_path / "m"), ["x"], [avg], exe,
                                    main, params_filename=None)
        prog, feeds, fetches = tfluid.load_inference_model(
            str(tmp_path / "m"), exe, params_filename=None)
    assert feeds == ["x"] and [f.name for f in fetches] == [avg.name]


def test_inference_program_and_parameter_values():
    main, startup, _ = _fit(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        w = main.global_block().var("fc_0.w_0")
        val = tio.get_parameter_value(w, exe)
        np.testing.assert_array_equal(
            val, tio.get_parameter_value_by_name("fc_0.w_0", exe, main))
        np.testing.assert_array_equal(val, scope.get("fc_0.w_0").numpy())
        with pytest.raises(TypeError, match="not a Parameter"):
            tio.get_parameter_value_by_name(
                main.global_block().ops[0].outputs["Out"][0], exe, main)
    with pytest.raises(ValueError, match="not initialized"):
        tio.get_parameter_value(w, exe, scope=tfluid.Scope())
    test = tio.get_inference_program([], main)
    assert test is not main
    assert [op.type for op in test.global_block().ops] == \
        [op.type for op in main.global_block().ops]


def test_top_level_io_names():
    for name in ("save_inference_model", "load_inference_model",
                 "save_params", "load_params", "save_persistables",
                 "load_persistables"):
        assert getattr(tfluid, name) is getattr(tio, name)


# ------------------------------------------------- feeding and metrics --

def test_data_feeder_feeds_the_book_recommender():
    """DataFeeder over the recommender's feed list (dense ids and LoD
    categories and titles) gives the JAX package's arrays and LoDTensors
    for the same movielens rows, and one SGD step of the port's
    recommender on that feed matches the JAX package's."""
    data = list(jmovielens.train()())[:16]
    feeds, progs = [], []
    for fluid, rec in ((jfluid, jrec), (tfluid, trec)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            _, avg = rec.model(emb_dim=8, fc_dim=16)
            fluid.optimizer.SGD(learning_rate=0.2).minimize(avg)
            feeder = fluid.DataFeeder(
                feed_list=[main.global_block().var(n)
                           for n in rec.FEED_ORDER],
                place=fluid.CPUPlace(), program=main)
        feeds.append(feeder.feed(data))
        progs.append((main, startup, avg))
    jfeed, tfeed = feeds
    assert sorted(jfeed) == sorted(tfeed)
    for name in jfeed:
        if isinstance(jfeed[name], jfluid.LoDTensor):
            assert tfeed[name].lod == jfeed[name].lod
            np.testing.assert_array_equal(tfeed[name].data,
                                          jfeed[name].data)
        else:
            np.testing.assert_array_equal(tfeed[name], jfeed[name])
            assert tfeed[name].dtype == jfeed[name].dtype
    (jmain, jstartup, javg), (tmain, _, tavg) = progs
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        state = {v.name: np.array(jscope.get(v.name))
                 for v in jmain.list_vars() if v.persistable}
        want = jexe.run(jmain, feed=jfeed, fetch_list=[javg])[0]
    tscope = tio.scope_from_numpy(state, tfluid.CPUPlace(), program=tmain)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=tfeed, fetch_list=[tavg], scope=tscope)[0]
    np.testing.assert_allclose(np.ravel(got), np.ravel(want), rtol=1e-5)


def _samples():
    return lambda: iter([(i, i * i) for i in range(7)])


@pytest.mark.parametrize("deco", [
    lambda r, m: m.batch(r, 3), lambda r, m: m.batch(r, 3, drop_last=True),
    lambda r, m: m.firstn(r, 4), lambda r, m: m.chain(r, r),
    lambda r, m: m.compose(r, r), lambda r, m: m.buffered(r, 2),
    lambda r, m: m.map_readers(lambda a: a[0] + a[1], r),
    lambda r, m: m.xmap_readers(lambda a: a[1], r, 2, 4, order=True),
    lambda r, m: m.skip(r, 2)],
    ids=["batch", "batch_drop_last", "firstn", "chain", "compose",
         "buffered", "map_readers", "xmap_readers", "skip"])
def test_reader_decorators(deco):
    assert list(deco(_samples(), tfluid.reader)()) == \
        list(deco(_samples(), jreader)())
    assert tfluid.batch is tfluid.reader.batch


def test_weighted_average_and_metrics():
    """WeightedAverage and the host metrics give the JAX package's values
    on the same updates."""
    rng = np.random.RandomState(3)
    preds = rng.rand(40, 2).astype(np.float32)
    labels = rng.randint(0, 2, (40, 1))
    got = []
    for fluid in (jfluid, tfluid):
        avg = fluid.average.WeightedAverage()
        for v, w in ((0.5, 2), (1.5, 1), (np.array([3.0]), 3)):
            avg.add(v, w)
        acc = fluid.metrics.Accuracy()
        acc.update(0.75, 8)
        acc.update(0.25, 4)
        auc = fluid.metrics.Auc(num_thresholds=50)
        auc.update(preds, labels)
        chunk = fluid.metrics.ChunkEvaluator()
        chunk.update(10, 12, 7)
        edit = fluid.metrics.EditDistance()
        edit.update(np.array([[0.0], [2.0], [1.0]]), 3)
        got.append([np.ravel(avg.eval()).tolist(), acc.eval(), auc.eval(),
                    list(chunk.eval()), list(np.ravel(edit.eval()))])
    assert got[0] == got[1]
    with pytest.raises(ValueError):
        tfluid.WeightedAverage().eval()


def test_accuracy_evaluator_accumulates():
    """evaluator.Accuracy: the states sum each batch's correct and total
    on the device; eval gives the running accuracy, reset zeroes it."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        label = tfluid.layers.data(name="label", shape=[1], dtype="int64")
        ev = tfluid.evaluator.Accuracy(input=x, label=label, k=1)
    exe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(1)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        hits = total = 0
        for n in (5, 7):
            xs = rng.rand(n, 4).astype(np.float32)
            ys = rng.randint(0, 4, (n, 1)).astype(np.int64)
            batch, = exe.run(main, feed={"x": xs, "label": ys},
                             fetch_list=ev.metrics)
            ok = int((xs.argmax(1) == ys[:, 0]).sum())
            np.testing.assert_allclose(batch, [ok / n], rtol=1e-6)
            hits, total = hits + ok, total + n
            np.testing.assert_allclose(ev.eval(exe), [hits / total],
                                       rtol=1e-6)
        ev.reset(exe)
        assert ev.eval(exe)[0] == 0.0


def test_concurrency_raises_the_curated_error():
    for name in ("make_channel", "channel_send", "channel_recv",
                 "channel_close"):
        fn = getattr(tfluid.concurrency, name)
        args = (None,) * (fn.__code__.co_argcount
                          - len(fn.__defaults__ or ()))
        with pytest.raises(NotImplementedError) as got:
            fn(*args)
        with pytest.raises(NotImplementedError) as want:
            getattr(jfluid.concurrency, name)(*args)
        assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="scope cut"):
        tfluid.Select()


# ---------------------------------------------- the verbatim scripts --

def _verbatim_module():
    path = os.path.join(ROOT, "book", "test_migration_verbatim.py")
    spec = importlib.util.spec_from_file_location("migration_verbatim", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_on_port(src):
    """test_migration_verbatim._run_script with `fluid` bound to the
    port: the script text as it is."""
    scope = tfluid.Scope()
    main, startup = tfluid.Program(), tfluid.Program()
    env = {"fluid": tfluid}
    with tfluid.unique_name.guard(), tfluid.scope_guard(scope), \
            tfluid.program_guard(main, startup):
        exec(src, env)
    return env["result"]


@pytest.mark.parametrize("test", ["test_fit_a_line_verbatim",
                                  "test_recognize_digits_verbatim",
                                  "test_word2vec_verbatim",
                                  "test_sentiment_lstm_verbatim"])
def test_migration_scripts_run_verbatim_on_the_port(monkeypatch, test):
    mod = _verbatim_module()
    monkeypatch.setattr(mod, "_run_script", _run_on_port)
    getattr(mod, test)()
