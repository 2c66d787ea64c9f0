"""In-graph readers, recordio and the host-io prefetcher (ROADMAP A8) in
the port against the JAX package, on the CPU.

Mirrors the single-device cases of the JAX package's tests:
- tests/unittests/test_reader_layers.py: open_recordio_file + read_file,
  EOF and reset, the shuffle (the same seeded order in both packages),
  double-buffer and multi-pass decorators, open_files over two files
  (thread order, so the multiset), a missing file raising rather than
  hanging, a reset mid-stream, and training from a file a DataFeeder
  wrote until EOF (the ParallelExecutor cases wait for ROADMAP A10);
- test_recordio.py: round trips, the native and pure-Python writers
  byte-identical, a corrupt file detected, lodpack's native packer equal
  to numpy and refusing malformed input;
- test_multi_step_executor.py:356-450: reader-fed steps=K equal to K
  sequential runs, a mid-block EOF and a ragged block consuming nothing,
  reader creation in the main block refused under steps=K;
- test_pipelined_dispatch.py:289-690: prefetch=True bit-exact against the
  serial pre-pass (steps 1 and K, with and without a double buffer), a
  feed-fed program never arming the prefetcher, and the refunds: on a
  raise after the kick, on a signature change, on an error staged for
  another signature, and the quiesce hook.
The readers' records are equal to the JAX package's exactly; a
reader-fed training run from the JAX package's initial state gives its
losses within rtol = atol = 1e-5 (fp32 sums in another order).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.native import lodpack as jlodpack

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import recordio as trio
from paddle_tpu_torch.core.dispatch import rollback_all_staged
from paddle_tpu_torch.core.readers import (DoubleBufferReader,
                                           IteratorReader, MultiPassReader)
from paddle_tpu_torch.native import lodpack as tlodpack

BATCH = 8
N_BATCHES = 6
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_recordio(tmp_path, name="data.recordio", n_batches=N_BATCHES,
                   seed=0, fluid=tfluid):
    """A file of n_batches records, each one batched (x[8,4], y[8,1])."""
    rng = np.random.RandomState(seed)
    w = rng.randn(4, 1).astype("float32")

    def reader():
        for _ in range(n_batches):
            xs = rng.rand(BATCH, 4).astype("float32")
            yield xs, (xs @ w).astype("float32")

    path = str(tmp_path / name)
    assert fluid.recordio_writer.convert_reader_to_recordio_file(
        path, reader) == n_batches
    return path


def _exe(fluid):
    return fluid.Executor(fluid.CPUPlace())


def _open(fluid, path):
    return fluid.layers.open_recordio_file(
        filename=path, shapes=[[-1, 4], [-1, 1]], lod_levels=[0, 0],
        dtypes=["float32", "float32"])


def _sum_program(fluid, path, decorate=None):
    """(main, startup, reader var, reduce_sum(x))."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        reader = _open(fluid, path)
        if decorate is not None:
            reader = decorate(fluid, reader)
        x, _ = fluid.layers.read_file(reader)
        s = fluid.layers.reduce_sum(x)
    return main, startup, reader, s


def _drain(fluid, path, decorate=None, reset_after=None):
    """reduce_sum(x) of every record until eof() (then, with reset_after,
    a reset and a second drain)."""
    main, startup, reader, s = _sum_program(fluid, path, decorate)
    exe = _exe(fluid)
    out = []
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        while not reader.eof():
            out.append(float(np.asarray(
                exe.run(main, fetch_list=[s])[0]).reshape(-1)[0]))
        if reset_after:
            with pytest.raises(fluid.EOFException):
                exe.run(main, fetch_list=[s])
            reader.reset()
            while not reader.eof():
                out.append(float(np.asarray(
                    exe.run(main, fetch_list=[s])[0]).reshape(-1)[0]))
    return out


DECORATORS = {
    "plain": None,
    "shuffle": lambda f, r: f.layers.create_shuffle_reader(
        r, buffer_size=4, seed=3),
    "double_buffer": lambda f, r: f.layers.create_double_buffer_reader(
        r, capacity=2),
    "multi_pass": lambda f, r: f.layers.create_multi_pass_reader(
        r, pass_num=3),
    "shuffle_multi_pass_double_buffer": lambda f, r:
        f.layers.double_buffer(f.layers.multi_pass(
            f.layers.shuffle(r, buffer_size=3, seed=1), pass_num=2)),
}


@pytest.mark.parametrize("name", sorted(DECORATORS))
def test_reader_chain_records_match_the_jax_package(tmp_path, name):
    """Every record, in order (the shuffle's seeded order included), and
    the reset's second pass."""
    path = _make_recordio(tmp_path)
    got = _drain(tfluid, path, DECORATORS[name], reset_after=True)
    want = _drain(jfluid, path, DECORATORS[name], reset_after=True)
    per_pass = 3 * N_BATCHES if name == "multi_pass" else \
        2 * N_BATCHES if name.endswith("double_buffer") and \
        "multi" in name else N_BATCHES
    assert len(got) == 2 * per_pass
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got[:per_pass], got[per_pass:], rtol=1e-6)


def test_open_files_reads_every_record(tmp_path):
    p1 = _make_recordio(tmp_path, "a.recordio", n_batches=3, seed=1)
    p2 = _make_recordio(tmp_path, "b.recordio", n_batches=4, seed=2)

    def multi(fluid, _):
        return fluid.layers.open_files(
            filenames=[p1, p2], thread_num=2, shapes=[[-1, 4], [-1, 1]],
            lod_levels=[0, 0], dtypes=["float32", "float32"])
    got = _drain(tfluid, p1, multi)
    want = _drain(jfluid, p1, multi)
    assert len(got) == 7
    np.testing.assert_allclose(sorted(got), sorted(want), rtol=1e-6)


def test_open_files_missing_file_raises_not_hangs(tmp_path):
    p1 = _make_recordio(tmp_path, "ok.recordio", n_batches=2)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        reader = tfluid.layers.open_files(
            filenames=[p1, str(tmp_path / "missing.recordio")],
            thread_num=2, shapes=[[-1, 4], [-1, 1]], lod_levels=[0, 0],
            dtypes=["float32", "float32"])
        x, _ = tfluid.layers.read_file(reader)
        s = tfluid.layers.reduce_sum(x)
    exe = _exe(tfluid)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        with pytest.raises(Exception) as ei:
            for _ in range(4):   # the good file's records may come first
                exe.run(main, fetch_list=[s])
        assert not isinstance(ei.value, tfluid.EOFException)


def test_reset_mid_stream(tmp_path):
    """A reset before the stream drains neither deadlocks (workers parked
    on a full queue) nor loses the new pass's first record."""
    p1 = _make_recordio(tmp_path, "a.recordio", n_batches=5, seed=1)
    p2 = _make_recordio(tmp_path, "b.recordio", n_batches=5, seed=2)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        reader = tfluid.layers.open_files(
            filenames=[p1, p2], thread_num=2, shapes=[[-1, 4], [-1, 1]],
            lod_levels=[0, 0], dtypes=["float32", "float32"])
        reader = tfluid.layers.create_double_buffer_reader(reader)
        x, _ = tfluid.layers.read_file(reader)
        s = tfluid.layers.reduce_sum(x)
    exe = _exe(tfluid)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        exe.run(main, fetch_list=[s])
        reader.reset()
        n = 0
        while not reader.eof():
            exe.run(main, fetch_list=[s])
            n += 1
    assert n == 10


def _feeder_file(fluid, tmp_path, n=20):
    """The book pattern: batches through a DataFeeder into a recordio
    file (the same bytes from both packages)."""
    prog = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog,
                                                        fluid.Program()):
        fx = fluid.layers.data(name="fx", shape=[4], dtype="float32")
        fy = fluid.layers.data(name="fy", shape=[1], dtype="float32")
        feeder = fluid.DataFeeder(feed_list=[fx, fy], program=prog)
    rng = np.random.RandomState(0)
    w_true = rng.randn(4, 1).astype("float32")

    def batched_reader():
        for _ in range(n):
            rows = []
            for _ in range(BATCH):
                xr = rng.rand(4).astype("float32")
                rows.append((xr, (xr @ w_true).astype("float32")))
            yield rows

    path = str(tmp_path / ("train_%s.recordio" % fluid.__name__))
    assert fluid.recordio_writer.convert_reader_to_recordio_file(
        path, batched_reader, feeder=feeder) == n
    return path


def _train_program(fluid, path, passes=5):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        reader = _open(fluid, path)
        reader = fluid.layers.create_multi_pass_reader(reader,
                                                       pass_num=passes)
        reader = fluid.layers.create_double_buffer_reader(reader)
        x, y = fluid.layers.read_file(reader)
        pred = fluid.layers.fc(input=x, size=1)
        cost = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    return main, startup, reader, cost


def test_train_from_recordio_matches_the_jax_package(tmp_path):
    jpath = _feeder_file(jfluid, tmp_path)
    tpath = _feeder_file(tfluid, tmp_path)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    jmain, jstartup, jreader, jcost = _train_program(jfluid, jpath)
    exe = _exe(jfluid)
    jscope = jfluid.Scope()
    jlosses = []
    with jfluid.scope_guard(jscope):
        exe.run(jstartup)
        init = {n: np.array(jscope.get(n)) for n in jscope.names()
                if not hasattr(jscope.get(n), "next")}
        while not jreader.eof():
            jlosses.append(float(np.asarray(
                exe.run(jmain, fetch_list=[jcost])[0]).reshape(-1)[0]))
    tmain, tstartup, treader, tcost = _train_program(tfluid, tpath)
    exe = _exe(tfluid)
    tscope = tfluid.Scope()
    tlosses = []
    with tfluid.scope_guard(tscope):
        exe.run(tstartup)
        for n, v in init.items():
            tscope.set(n, torch.from_numpy(v))
        while not treader.eof():
            tlosses.append(float(exe.run(
                tmain, fetch_list=[tcost])[0].reshape(-1)[0]))
        assert tscope.get(treader.name).state_dict()["consumed"] == 100
    assert len(tlosses) == 100
    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    assert tlosses[-1] < tlosses[0] * 0.05


def test_save_persistables_skips_reader_vars(tmp_path):
    """Reader vars are persistable but hold host-side readers: save and
    load pass over them, as the JAX package's io does."""
    path = _make_recordio(tmp_path)
    main, startup, reader, cost = _train_program(tfluid, path)
    exe = _exe(tfluid)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, fetch_list=[cost], scope=scope)
    d = str(tmp_path / "ckpt")
    tfluid.io.save_persistables(exe, d, main_program=main, scope=scope)
    with open(os.path.join(d, "manifest.json")) as f:
        saved = f.read()
    assert "fc_0.w_0" in saved and reader.name not in saved
    tfluid.io.load_persistables(exe, d, main_program=main, scope=scope)


# -------------------------------------------------------------- recordio --

@pytest.mark.parametrize("comp", [0, 2])
def test_native_and_python_recordio_are_byte_identical(tmp_path, comp):
    assert trio._native() is not None
    recs = [os.urandom(n) for n in (0, 1, 7, 300, 5000)] * 40
    paths = {}
    for native in (True, False):
        p = str(tmp_path / ("r%d.rio" % native))
        trio.write_records(p, recs, compressor=comp, max_num_records=17,
                           use_native=native)
        paths[native] = p
        for read_native in (True, False):
            assert trio.read_records(p, use_native=read_native) == recs
    with open(paths[True], "rb") as a, open(paths[False], "rb") as b:
        port = a.read()
        assert port == b.read()
    jp = str(tmp_path / "jax.rio")
    jfluid.recordio.write_records(jp, recs, compressor=comp,
                                  max_num_records=17)
    with open(jp, "rb") as f:
        assert f.read() == port


def test_corrupt_recordio_is_detected(tmp_path):
    p = str(tmp_path / "c.rio")
    trio.write_records(p, [b"abc" * 100] * 10)
    raw = bytearray(open(p, "rb").read())
    raw[40] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    for native in (True, False):
        with pytest.raises(IOError):
            trio.read_records(p, use_native=native)


def test_lodpack_native_matches_numpy_and_the_jax_package():
    assert tlodpack.available()
    rng = np.random.RandomState(0)
    lens = [3, 0, 5, 1]
    data = rng.randn(sum(lens), 2, 3).astype("float32")
    offs = np.concatenate([[0], np.cumsum(lens)])
    out = np.zeros((4, 8, 2, 3), "float32")
    assert tlodpack.pack_into(data, offs, out)
    want = np.zeros_like(out)
    for i, n in enumerate(lens):
        want[i, :n] = data[offs[i]:offs[i + 1]]
    np.testing.assert_array_equal(out, want)
    jout = np.zeros_like(out)
    assert jlodpack.pack_into(data, offs, jout)
    np.testing.assert_array_equal(out, jout)
    # malformed: offsets of the wrong arity
    assert not tlodpack.pack_into(data, offs[:-1], out)
    seqs = [data[offs[i]:offs[i + 1]] for i in range(4)]
    padded, got_lens = tfluid.LoDTensor.from_sequences(seqs).to_padded()
    np.testing.assert_array_equal(padded, want)
    np.testing.assert_array_equal(got_lens, lens)


# ------------------------------------------------------------ steps = K --

def _reader_trainer(fluid, path, double_buffer=False, dropout=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        r = _open(fluid, path)
        if double_buffer:
            r = fluid.layers.create_double_buffer_reader(r, capacity=2)
        x, y = fluid.layers.read_file(r)
        h = fluid.layers.fc(input=x, size=16, act="relu")
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=0.3)
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _state(scope):
    return {n: scope.get(n).numpy() for n in scope.names()
            if isinstance(scope.get(n), torch.Tensor)}


def test_reader_fed_steps_match_sequential_and_the_jax_package(tmp_path):
    """Two steps=4 calls stack [K, batch, ...] per reader field and slice
    one step at a time: 8 losses and the weights equal 8 sequential runs
    (and the JAX package's two steps=4 calls from the same state)."""
    path = _make_recordio(tmp_path, n_batches=8)
    jmain, jstartup, jloss = _reader_trainer(jfluid, path)
    jscope = jfluid.Scope()
    exe = _exe(jfluid)
    with jfluid.scope_guard(jscope):
        exe.run(jstartup)
        init = {n: np.array(jscope.get(n)) for n in jscope.names()
                if not hasattr(jscope.get(n), "next")}
        jout = np.concatenate([np.asarray(
            exe.run(jmain, fetch_list=[jloss], steps=4)[0]).ravel()
            for _ in range(2)])
    runs = {}
    for steps in (1, 4):
        main, startup, loss = _reader_trainer(tfluid, path)
        scope, exe = tfluid.Scope(), _exe(tfluid)
        with tfluid.scope_guard(scope):
            exe.run(startup)
            for n, v in init.items():
                scope.set(n, torch.from_numpy(v.copy()))
            out = [exe.run(main, fetch_list=[loss], steps=steps)[0].ravel()
                   for _ in range(8 // steps)]
            runs[steps] = (np.concatenate(out), _state(scope))
    np.testing.assert_array_equal(runs[4][0], runs[1][0])
    for n, v in runs[1][1].items():
        np.testing.assert_array_equal(runs[4][1][n], v, err_msg=n)
    np.testing.assert_allclose(runs[4][0], jout, **TOL)


def test_reader_eof_mid_block_consumes_nothing(tmp_path):
    path = _make_recordio(tmp_path, n_batches=8)
    main, startup, loss = _reader_trainer(tfluid, path, double_buffer=True)
    exe = _exe(tfluid)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        for _ in range(2):
            exe.run(main, fetch_list=[loss], steps=3)   # 6 of 8 consumed
        with pytest.raises(tfluid.EOFException):
            exe.run(main, fetch_list=[loss], steps=3)   # only 2 left
        out = exe.run(main, fetch_list=[loss], steps=2)
        assert out[0].shape[0] == 2
        # the mid-block EOF took the double buffer's one-shot sentinel;
        # with the tail drained, EOF again (no hang on the dead worker)
        with pytest.raises(tfluid.EOFException):
            exe.run(main, fetch_list=[loss])


def test_reader_ragged_block_consumes_nothing(tmp_path):
    rng = np.random.RandomState(0)

    def reader():
        for i in range(4):
            xs = rng.rand(8 if i != 2 else 6, 4).astype("float32")
            yield xs, xs[:, :1].copy()

    path = str(tmp_path / "ragged.recordio")
    tfluid.recordio_writer.convert_reader_to_recordio_file(path, reader)
    main, startup, loss = _reader_trainer(tfluid, path)
    exe = _exe(tfluid)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        with pytest.raises(Exception):
            exe.run(main, fetch_list=[loss], steps=4)
        for _ in range(4):   # nothing consumed: all 4 drain one at a time
            exe.run(main, fetch_list=[loss])


def test_main_block_reader_creation_rejected_under_steps(tmp_path):
    path = _make_recordio(tmp_path)
    main = tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, main):
        r = _open(tfluid, path)
        x, _ = tfluid.layers.read_file(r)
        s = tfluid.layers.reduce_sum(x)
    exe = _exe(tfluid)
    with tfluid.scope_guard(tfluid.Scope()):
        with pytest.raises(RuntimeError, match="once per CALL"):
            exe.run(main, fetch_list=[s], steps=2)


def test_next_many_is_atomic():
    r = IteratorReader(lambda: iter([(np.float32(i),) for i in range(5)]))
    assert [float(x[0]) for x in r.next_many(2)] == [0.0, 1.0]
    with pytest.raises(ValueError):
        r.next_many(2, validate=lambda rec: (_ for _ in ()).throw(
            ValueError("bad")) if float(rec[0]) == 3.0 else None)
    assert r.state_dict()["consumed"] == 2
    with pytest.raises(tfluid.EOFException):
        r.next_many(4)
    assert [float(x[0]) for x in r.next_many(3)] == [2.0, 3.0, 4.0]


# -------------------------------------------------------------- prefetch --

def _train_to_eof(path, prefetch, steps=1, double_buffer=False):
    main, startup, loss = _reader_trainer(tfluid, path, double_buffer,
                                          dropout=True)
    exe, scope = _exe(tfluid), tfluid.Scope()
    outs = []
    with tfluid.scope_guard(scope):
        exe.run(startup)
        while True:
            try:
                outs.append(exe.run(main, fetch_list=[loss], steps=steps,
                                    prefetch=prefetch)[0])
            except tfluid.EOFException:
                break
        return outs, _state(scope), exe


@pytest.mark.parametrize("steps,double_buffer", [(1, False), (3, False),
                                                 (1, True), (4, True)])
def test_training_prefetch_bit_exact(tmp_path, steps, double_buffer):
    """The prefetched pre-pass equals the serial one bit for bit: fetch
    stream, parameters, Adam moments (dropout's seeds included)."""
    path = _make_recordio(tmp_path, n_batches=12)
    o_ser, s_ser, _ = _train_to_eof(path, False, steps, double_buffer)
    o_pre, s_pre, exe = _train_to_eof(path, True, steps, double_buffer)
    assert exe._prefetcher is not None
    assert len(o_ser) == len(o_pre) >= 2
    for a, b in zip(o_ser, o_pre):
        np.testing.assert_array_equal(a, b)
    assert sorted(s_ser) == sorted(s_pre)
    for n in s_ser:
        np.testing.assert_array_equal(s_ser[n], s_pre[n], err_msg=n)


def test_feed_fed_prefetch_never_arms():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(input=x, size=1))
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    feed = {"x": np.random.RandomState(0).rand(4, 4).astype("f")}
    outs = []
    for prefetch in (False, True):
        exe, scope = _exe(tfluid), tfluid.Scope()
        exe.run(startup, scope=scope)
        scope.set("fc_0.w_0", torch.full((4, 1), 0.1))
        outs.append([exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scope, prefetch=prefetch)[0]
                     for _ in range(3)])
        assert exe._prefetcher is None
    np.testing.assert_array_equal(outs[0], outs[1])


def _overflow_trainer(path):
    """A reader-fed step whose array write overflows on a record whose
    x sums above 30: an in-graph assertion raised after the run (and so
    after prefetch's kick)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x, _ = tfluid.layers.read_file(_open(tfluid, path))
        s = tfluid.layers.reduce_sum(x)
        arr = tfluid.layers.create_array("float32", capacity=2)
        big = tfluid.layers.cast(tfluid.layers.greater_than(
            s, tfluid.layers.fill_constant([1], "float32", 30.0)), "int64")
        idx = tfluid.layers.scale(big, scale=5.0)
        tfluid.layers.array_write(s, idx, arr)
    return main, startup, s


def test_raise_after_kick_refunds_the_staged_block(tmp_path):
    """A run that raises after prefetch's kick leaves the stream right
    after its own record: the staged next record goes back."""
    rng = np.random.RandomState(1)
    data = [rng.rand(8, 4).astype("f") * (2.0 if i == 2 else 0.5)
            for i in range(5)]
    path = str(tmp_path / "o.recordio")
    tfluid.recordio_writer.convert_reader_to_recordio_file(
        path, lambda: ((d, d[:, :1]) for d in data))
    streams = []
    for prefetch in (False, True):
        main, startup, s = _overflow_trainer(path)
        exe, scope = _exe(tfluid), tfluid.Scope()
        got = []
        with tfluid.scope_guard(scope):
            exe.run(startup)
            for _ in range(5):
                try:
                    got.append(float(exe.run(main, fetch_list=[s],
                                             prefetch=prefetch)[0][0]))
                except RuntimeError as e:
                    assert "overflowed its capacity 2" in str(e)
                    got.append(None)
        streams.append(got)
    assert streams[0] == streams[1]
    assert streams[0][2] is None and None not in streams[0][3:]
    np.testing.assert_allclose(streams[0][3], data[3].sum(), rtol=1e-6)


def test_signature_change_refunds_staged_block(tmp_path):
    path = _make_recordio(tmp_path, n_batches=12)

    def leg(prefetch):
        main, startup, loss = _reader_trainer(tfluid, path)
        exe, scope = _exe(tfluid), tfluid.Scope()
        outs = []
        with tfluid.scope_guard(scope):
            exe.run(startup)
            try:
                while True:
                    outs.append(exe.run(main, fetch_list=[loss],
                                        prefetch=prefetch)[0])
                    outs.append(exe.run(main, fetch_list=[loss], steps=2,
                                        fetch_reduce="last",
                                        prefetch=prefetch)[0])
            except tfluid.EOFException:
                pass
            return outs, _state(scope)

    (o1, s1), (o2, s2) = leg(False), leg(True)
    assert len(o1) == len(o2) == 8
    for a, b in zip(o1, o2):
        np.testing.assert_array_equal(a, b)
    for n in s1:
        np.testing.assert_array_equal(s1[n], s2[n], err_msg=n)


def test_staged_error_for_other_signature_does_not_leak(tmp_path):
    """An EOF staged by a steps=2 kick (one record left) consumed nothing
    and must not fail a steps=1 tail pass through the same executor."""
    path = _make_recordio(tmp_path, n_batches=7)

    def leg(prefetch):
        main, startup, loss = _reader_trainer(tfluid, path)
        exe, scope = _exe(tfluid), tfluid.Scope()
        outs = []
        with tfluid.scope_guard(scope):
            exe.run(startup)
            for _ in range(3):
                outs.append(exe.run(main, fetch_list=[loss], steps=2,
                                    fetch_reduce="last",
                                    prefetch=prefetch)[0])
            try:
                while True:
                    outs.append(exe.run(main, fetch_list=[loss],
                                        prefetch=prefetch)[0])
            except tfluid.EOFException:
                pass
            return outs

    o_ser, o_pre = leg(False), leg(True)
    assert len(o_ser) == len(o_pre) == 4
    for a, b in zip(o_ser, o_pre):
        np.testing.assert_array_equal(a, b)


def test_double_buffer_pin_place():
    """A pin sets the staging device once; an explicit place wins; chains
    forward the pin to the buffering decorator. With no card the records
    pass through as they are."""
    def creator():
        for i in range(4):
            yield (np.full((2, 3), i, dtype="float32"),)

    cpu = torch.device("cpu")
    r = DoubleBufferReader(IteratorReader(creator), capacity=2)
    try:
        assert r._device is None
        r.pin_place(cpu)
        assert r._device == cpu
        r.pin_place(torch.device("cuda", 0))    # later pins never override
        assert r._device == cpu
        assert float(r.next()[0][0, 0]) == 0.0
    finally:
        r.close()
    r2 = DoubleBufferReader(IteratorReader(creator), place=tfluid.CPUPlace())
    try:
        r2.pin_place(torch.device("cuda", 0))
        assert r2._device == cpu
    finally:
        r2.close()
    inner = DoubleBufferReader(IteratorReader(creator), capacity=2)
    outer = MultiPassReader(inner, 2)
    try:
        outer.pin_place(cpu)
        assert inner._device == cpu
    finally:
        inner.close()


def test_rollback_all_staged_is_idempotent(tmp_path):
    rollback_all_staged()
    rollback_all_staged(scope=tfluid.Scope())
    path = _make_recordio(tmp_path, n_batches=6)
    main, startup, loss = _reader_trainer(tfluid, path)
    exe, scope = _exe(tfluid), tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        exe.run(main, fetch_list=[loss], prefetch=True)
        reader = scope.get(main.global_block().ops[0].inputs["Reader"][0])
        rollback_all_staged(scope=tfluid.Scope())   # a foreign scope
        assert exe._prefetcher.has_work()
        rollback_all_staged(scope=scope)
        rollback_all_staged(scope=scope)
        assert reader.state_dict()["consumed"] == 1
        out = exe.run(main, fetch_list=[loss])[0]
        assert np.isfinite(out).all()
        assert reader.state_dict()["consumed"] == 2
