"""The port's era-wire format (paddle_tpu_torch/reference_format.py,
io.save_reference_model / load_reference_model) against the JAX
package's, on the CPU.

Mirrors tests/unittests/test_reference_model_load.py:
- the bytes: for the same program and values, serialize_program_desc and
  the LoDTensor stream writers (one tensor, with LoD, combined) of both
  packages write equal bytes;
- the JAX tests' hand-written reference-era directories (the MLP, the
  conv net, the LSTM, the bidirectional LSTM and the GRU, written by that
  file's own proto2 writer) load in the port and give the JAX package's
  outputs;
- export from each package loads in the other: the MLP, the conv net with
  two feeds, a sequence model, an LSTM, a dense Transformer encoder, an
  embedding model and combined params (params_filename);
- the three faults ADVICE.md found in the module, fixed in the JAX copy
  and kept here: feed/fetch carriers persistable, ints past int32 as LONG,
  an unknown dtype raising; fused_attention refused ("no era
  registration"), topk on the wire as top_k; the layout adapter's
  refusals.
Outputs agree within rtol 1e-4, atol 1e-5 (the JAX tests' tolerance).
"""
import importlib.util
import io as _pyio
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import reference_format as jrf
from paddle_tpu.core.lod import LoDTensor as JLoDTensor

import paddle_tpu_torch as fluid
from paddle_tpu_torch import reference_format as rf
from paddle_tpu_torch.core.lod import LoDTensor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)


def _load_jax_tests():
    """The JAX package's era-wire test module (its proto2 writer and its
    hand-written era directories), imported under a name of its own."""
    path = os.path.join(REPO, "tests", "unittests",
                        "test_reference_model_load.py")
    spec = importlib.util.spec_from_file_location(
        "jax_reference_model_load_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jt = _load_jax_tests()
# the JAX file's fixtures, used here by name
reference_model_dir = jt.reference_model_dir
reference_conv_model_dir = jt.reference_conv_model_dir
reference_lstm_model_dir = jt.reference_lstm_model_dir


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_port(d, feed, **load_kw):
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    program, feeds, fetches = fluid.io.load_reference_model(
        d, exe, scope=scope, **load_kw)
    for v in program.list_vars():
        if v.persistable:   # tensors on the executor's device, not numpy
            assert isinstance(scope.get(v.name), torch.Tensor)
    out, = exe.run(program, feed=_port_feed(feed), fetch_list=fetches,
                   scope=scope)
    return feeds, [v.name for v in fetches], np.asarray(out)


def _run_jax(d, feed, **load_kw):
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        program, feeds, fetches = jfluid.io.load_reference_model(
            d, exe, **load_kw)
        out, = exe.run(program, feed=_jax_feed(feed), fetch_list=fetches)
    return feeds, [v.name for v in fetches], np.asarray(out)


def _port_feed(feed):
    return {n: LoDTensor.from_sequences(v) if isinstance(v, list) else v
            for n, v in feed.items()}


def _jax_feed(feed):
    return {n: JLoDTensor.from_sequences(v) if isinstance(v, list) else v
            for n, v in feed.items()}


def _same_outputs(d, feed, **load_kw):
    jfeeds, jfetch, want = _run_jax(d, feed, **load_kw)
    feeds, fetch, got = _run_port(d, feed, **load_kw)
    assert (feeds, fetch) == (jfeeds, jfetch)
    np.testing.assert_allclose(got, want, **TOL)
    return got


# ---------------------------------------------- the JAX tests' era dirs --
def test_reference_mlp_dir_loads_in_the_port(reference_model_dir):
    d, w, b = reference_model_dir
    xs = np.random.RandomState(0).rand(6, 4).astype("float32")
    got = _same_outputs(d, {"x": xs})
    h = np.maximum(xs @ w + b, 0)
    e = np.exp(h - h.max(-1, keepdims=True))
    np.testing.assert_allclose(got, e / e.sum(-1, keepdims=True), **TOL)


def test_reference_conv_dir_loads_in_the_port(reference_conv_model_dir):
    d, _, _ = reference_conv_model_dir
    img = np.random.RandomState(4).rand(3, 1, 6, 6).astype("float32")
    _same_outputs(d, {"image": img})


def test_reference_lstm_dir_loads_in_the_port(reference_lstm_model_dir):
    d, params = reference_lstm_model_dir
    rng = np.random.RandomState(3)
    seqs = [rng.randint(0, 10, (n, 1)).astype("int64") for n in (4, 2, 5)]
    got = _same_outputs(d, {"words": seqs})
    for i, s in enumerate(seqs):
        np.testing.assert_allclose(
            got[i], jt._np_reference_lstm_model(s.ravel(), params), **TOL)


def _write_era_dir(d, varz, ops, params):
    os.makedirs(d)
    with open(os.path.join(d, "__model__"), "wb") as f:
        f.write(jt._ld(1, jt.block_desc(0, -1, varz, ops)))
    for name, arr in params.items():
        jt.lod_tensor_file(os.path.join(d, name), arr)


def _era_lstm_op(win, bin_, hout, cout, reverse):
    a = jt.attr
    return jt.op_desc(
        "lstm", [("Input", ["x"]), ("Weight", [win]), ("Bias", [bin_])],
        [("Hidden", [hout]), ("Cell", [cout])],
        [a("use_peepholes", 6, False), a("is_reverse", 6, reverse),
         a("gate_activation", 2, "sigmoid"), a("cell_activation", 2, "tanh"),
         a("candidate_activation", 2, "tanh")])


def test_reference_bidirectional_lstm_dir_loads_in_the_port(tmp_path):
    """The JAX test's forward + reverse lstm -> concat(axis=1) ->
    sequence_pool LAST era program."""
    E, H = 3, 2
    rng = np.random.RandomState(21)
    lw_f = (rng.randn(H, 4 * H) * 0.4).astype("float32")
    lw_b = (rng.randn(H, 4 * H) * 0.4).astype("float32")
    zb = np.zeros((1, 4 * H), dtype="float32")
    v = jt.var_desc
    varz = [v("feed", 0, [], var_type=9), v("fetch", 0, [], var_type=10),
            v("x", 5, [-1, 4 * H], lod_level=1),
            v("lstm_f.w", 5, [H, 4 * H], persistable=True),
            v("lstm_f.b", 5, [1, 4 * H], persistable=True),
            v("lstm_b.w", 5, [H, 4 * H], persistable=True),
            v("lstm_b.b", 5, [1, 4 * H], persistable=True),
            v("h_f", 5, [-1, H], lod_level=1),
            v("c_f", 5, [-1, H], lod_level=1),
            v("h_b", 5, [-1, H], lod_level=1),
            v("c_b", 5, [-1, H], lod_level=1),
            v("cat", 5, [-1, 2 * H], lod_level=1), v("last", 5, [-1, 2 * H])]
    ops = [jt.op_desc("feed", [("X", ["feed"])], [("Out", ["x"])],
                      [jt.attr("col", 0, 0)]),
           _era_lstm_op("lstm_f.w", "lstm_f.b", "h_f", "c_f", False),
           _era_lstm_op("lstm_b.w", "lstm_b.b", "h_b", "c_b", True),
           jt.op_desc("concat", [("X", ["h_f", "h_b"])],
                      [("Out", ["cat"])], [jt.attr("axis", 0, 1)]),
           jt.op_desc("sequence_pool", [("X", ["cat"])],
                      [("Out", ["last"])], [jt.attr("pooltype", 2, "LAST")]),
           jt.op_desc("fetch", [("X", ["last"])], [("Out", ["fetch"])],
                      [jt.attr("col", 0, 0)])]
    d = str(tmp_path / "ref_bilstm")
    _write_era_dir(d, varz, ops, {"lstm_f.w": lw_f, "lstm_f.b": zb,
                                  "lstm_b.w": lw_b, "lstm_b.b": zb})
    seqs = [rng.randn(n, 4 * H).astype("float32") * 0.5 for n in (3, 5)]
    assert _same_outputs(d, {"x": seqs}).shape == (2, 2 * H)


def test_reference_gru_dir_loads_in_the_port(tmp_path):
    """The JAX test's ids -> lookup_table -> fc -> gru -> LAST era
    program."""
    V, E, H = 12, 3, 2
    rng = np.random.RandomState(29)
    emb = (rng.randn(V, E) * 0.5).astype("float32")
    fcw = (rng.randn(E, 3 * H) * 0.4).astype("float32")
    gw = (rng.randn(H, 3 * H) * 0.4).astype("float32")
    v, a = jt.var_desc, jt.attr
    varz = [v("feed", 0, [], var_type=9), v("fetch", 0, [], var_type=10),
            v("ids", 3, [-1, 1], lod_level=1),
            v("emb.w", 5, [V, E], persistable=True),
            v("emb.t", 5, [-1, E], lod_level=1),
            v("fc.w", 5, [E, 3 * H], persistable=True),
            v("fc.t", 5, [-1, 3 * H], lod_level=1),
            v("gru.w", 5, [H, 3 * H], persistable=True),
            v("gru.h", 5, [-1, H], lod_level=1), v("last", 5, [-1, H])]
    ops = [jt.op_desc("feed", [("X", ["feed"])], [("Out", ["ids"])],
                      [a("col", 0, 0)]),
           jt.op_desc("lookup_table", [("W", ["emb.w"]), ("Ids", ["ids"])],
                      [("Out", ["emb.t"])]),
           jt.op_desc("mul", [("X", ["emb.t"]), ("Y", ["fc.w"])],
                      [("Out", ["fc.t"])],
                      [a("x_num_col_dims", 0, 1), a("y_num_col_dims", 0, 1)]),
           jt.op_desc("gru", [("Input", ["fc.t"]), ("Weight", ["gru.w"])],
                      [("Hidden", ["gru.h"])],
                      [a("gate_activation", 2, "sigmoid"),
                       a("activation", 2, "tanh"), a("is_reverse", 6, False)]),
           jt.op_desc("sequence_pool", [("X", ["gru.h"])],
                      [("Out", ["last"])], [a("pooltype", 2, "LAST")]),
           jt.op_desc("fetch", [("X", ["last"])], [("Out", ["fetch"])],
                      [a("col", 0, 0)])]
    d = str(tmp_path / "ref_gru")
    _write_era_dir(d, varz, ops, {"emb.w": emb, "fc.w": fcw, "gru.w": gw})
    seqs = [rng.randint(0, V, (n, 1)).astype("int64") for n in (4, 2)]
    _same_outputs(d, {"ids": seqs})


# ------------------------------------------------------- export models --
def _mlp(f):
    x = f.layers.data(name="x", shape=[6], dtype="float32")
    h = f.layers.fc(input=x, size=8, act="relu")
    return [x], f.layers.fc(input=h, size=3, act="softmax")


def _conv_multifeed(f):
    img = f.layers.data(name="img", shape=[2, 8, 8], dtype="float32")
    extra = f.layers.data(name="extra", shape=[3], dtype="float32")
    c = f.layers.conv2d(input=img, num_filters=4, filter_size=3, padding=1,
                        act="relu")
    p = f.layers.pool2d(input=c, pool_size=2, pool_stride=2,
                        pool_type="max")
    logits = f.layers.fc(input=p, size=3)
    return [img, extra], f.layers.softmax(
        f.layers.elementwise_add(logits, extra))


def _sequence(f):
    w = f.layers.data(name="w", shape=[4], dtype="float32", lod_level=1)
    h = f.layers.fc(input=w, size=6, act="tanh")
    pooled = f.layers.sequence_pool(input=h, pool_type="sum")
    return [w], f.layers.fc(input=pooled, size=2, act="softmax")


def _lstm(f):
    w = f.layers.data(name="w", shape=[4], dtype="float32", lod_level=1)
    proj = f.layers.fc(input=w, size=12)
    hidden, _ = f.layers.dynamic_lstm(input=proj, size=12)
    pooled = f.layers.sequence_pool(input=hidden, pool_type="last")
    return [w], f.layers.fc(input=pooled, size=2, act="softmax")


ENC = dict(n_head=2, d_model=16, seq=10)


def _encoder(f):
    if f is fluid:
        from paddle_tpu_torch.models import transformer as T
    else:
        from paddle_tpu.models import transformer as T
    n_head, d_model, seq = ENC["n_head"], ENC["d_model"], ENC["seq"]
    src = f.layers.data(name="src", shape=[seq, 1], dtype="int64")
    pos = f.layers.data(name="pos", shape=[seq, 1], dtype="int64")
    bias = f.layers.data(name="bias", shape=[n_head, seq, seq],
                         dtype="float32")
    enc_in = T.prepare_encoder(src, pos, 32, d_model, seq)
    enc = T.encoder(enc_in, bias, n_layer=2, n_head=n_head, d_key=8,
                    d_value=8, d_model=d_model, d_inner_hid=32)
    pooled = f.layers.reduce_mean(enc, dim=[1])
    return [src, pos, bias], f.layers.fc(input=pooled, size=4,
                                         act="softmax")


def _embedding(f):
    a = f.layers.data(name="a", shape=[1], dtype="int64")
    b = f.layers.data(name="b", shape=[1], dtype="int64")
    ea = f.layers.embedding(a, size=[50, 8], is_sparse=True,
                            param_attr="shared_emb")
    eb = f.layers.embedding(b, size=[50, 8], is_sparse=True,
                            param_attr="shared_emb")
    cat = f.layers.concat([ea, eb], axis=1)
    return [a, b], f.layers.fc(input=cat, size=5, act="softmax")


def _feed(name, rng):
    if name in ("mlp", "combined"):
        return {"x": rng.rand(3, 6).astype("float32")}
    if name == "conv_multifeed":
        return {"img": rng.rand(2, 2, 8, 8).astype("float32"),
                "extra": rng.rand(2, 3).astype("float32")}
    if name in ("sequence", "lstm"):
        return {"w": [rng.randn(n, 4).astype("float32") * 0.5
                      for n in (3, 5, 1)]}
    if name == "encoder":
        seq, n_head = ENC["seq"], ENC["n_head"]
        return {"src": rng.randint(1, 32, (3, seq, 1)).astype("int64"),
                "pos": np.tile(np.arange(seq).reshape(1, seq, 1),
                               (3, 1, 1)).astype("int64"),
                "bias": np.zeros((3, n_head, seq, seq), "float32")}
    return {"a": rng.randint(0, 50, (6, 1)).astype("int64"),
            "b": rng.randint(0, 50, (6, 1)).astype("int64")}


MODELS = {"mlp": _mlp, "conv_multifeed": _conv_multifeed,
          "sequence": _sequence, "lstm": _lstm, "encoder": _encoder,
          "embedding": _embedding, "combined": _mlp}


def _program(f, name):
    main, startup = f.Program(), f.Program()
    main.random_seed = startup.random_seed = 3
    with f.unique_name.guard(), f.program_guard(main, startup):
        feeds, target = MODELS[name](f)
    return main, startup, [v.name for v in feeds], target


def _export(f, name, d):
    """Build `name` in package f, initialize it and save it in the era
    layout; returns (host params by name, the inference program)."""
    main, startup, feeds, target = _program(f, name)
    kw = {"params_filename": "__params__"} \
        if name in ("combined", "encoder") else {}
    exe = f.Executor(f.CPUPlace())
    if f is fluid:
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        infer = fluid.io.save_reference_model(d, feeds, [target], exe,
                                              main_program=main,
                                              scope=scope, **kw)
        params = {v.name: scope.get(v.name).numpy()
                  for v in infer.list_vars() if v.persistable}
    else:
        with jfluid.scope_guard(jfluid.Scope()):
            exe.run(startup)
            infer = jfluid.io.save_reference_model(d, feeds, [target], exe,
                                                   main_program=main, **kw)
            scope = jfluid.global_scope()
            params = {v.name: np.asarray(scope.get(v.name))
                      for v in infer.list_vars() if v.persistable}
    return params, kw


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_era_export_loads_in_the_other_package(tmp_path, name, writer):
    """Saved by one package, loaded by both: the same outputs; the
    writer's own native run agrees too."""
    f = fluid if writer == "port" else jfluid
    d = str(tmp_path / "era")
    params, kw = _export(f, name, d)
    if name == "combined":
        assert sorted(os.listdir(d)) == ["__model__", "__params__"]
    if name == "embedding":
        assert sorted(n for n in os.listdir(d) if "emb" in n) == \
            ["shared_emb"]
    feed = _feed(name, np.random.RandomState(7))
    _same_outputs(d, feed, **kw)


def _stream_bytes(mod, arr, lod=None):
    buf = _pyio.BytesIO()
    mod._write_lod_tensor_stream(buf, arr, lod)
    return buf.getvalue()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_era_bytes_equal_across_packages(tmp_path, name):
    """The same program (built by each package's layers) and the same
    values give the same __model__ bytes and the same param files."""
    jmain, _, jfeeds, jtarget = _program(jfluid, name)
    tmain, _, tfeeds, ttarget = _program(fluid, name)
    jinf = jmain.prune([jtarget.name], for_test=True)
    tinf = tmain.prune([ttarget.name], for_test=True)
    jraw = jrf.serialize_program_desc(jinf, jfeeds, [jtarget.name])
    traw = rf.serialize_program_desc(tinf, tfeeds, [ttarget.name])
    assert traw == jraw

    # the JAX package's values, written by both packages' writers
    d = str(tmp_path / "jax")
    params, kw = _export(jfluid, name, d)
    tdir = str(tmp_path / "port")
    os.makedirs(tdir)
    if kw:
        rf.write_combined_lod_tensor_file(
            os.path.join(tdir, "__params__"), params)
    else:
        for n, arr in params.items():
            rf.write_lod_tensor_file(os.path.join(tdir, n), arr)
    for n in sorted(os.listdir(tdir)):
        with open(os.path.join(tdir, n), "rb") as a, \
                open(os.path.join(d, n), "rb") as b:
            assert a.read() == b.read(), n


def test_lod_tensor_streams_equal_and_round_trip(tmp_path):
    rng = np.random.RandomState(5)
    cases = [(rng.rand(3, 4).astype("float32"), None),
             (rng.randint(0, 9, (7, 1)).astype("int64"), [[0, 2, 7]]),
             (rng.rand(2, 3, 4).astype("float64"), [[0, 1, 2], [0, 1, 3]]),
             (np.array([True, False]), None)]
    for arr, lod in cases:
        raw = _stream_bytes(rf, arr, lod)
        assert raw == _stream_bytes(jrf, arr, lod)
        got, got_lod, end = rf._read_lod_tensor_stream(raw, 0)
        np.testing.assert_array_equal(got, arr)
        assert got_lod == (lod or []) and end == len(raw)
    p = str(tmp_path / "t")
    rf.write_lod_tensor_file(p, cases[1][0], cases[1][1])
    got, lod = jrf.read_lod_tensor_file(p)
    np.testing.assert_array_equal(got, cases[1][0])
    assert lod == [[0, 2, 7]]
    combined = str(tmp_path / "c")
    rf.write_combined_lod_tensor_file(combined, {"b": cases[0][0],
                                                 "a": cases[1][0]})
    out = jrf.read_combined_lod_tensor_file(combined, ["a", "b"])
    np.testing.assert_array_equal(out["b"], cases[0][0])
    with open(combined, "r+b") as f:
        f.truncate(10)
    with pytest.raises(Exception):
        rf.read_combined_lod_tensor_file(combined, ["a", "b"])


# ------------------------------------------------- ADVICE.md's three faults --
def test_feed_fetch_carriers_are_persistable():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        out = fluid.layers.scale(x, scale=2.0)
    raw = rf.serialize_program_desc(main, ["x"], [out.name])
    _, _, varz, _ = rf._parse_blocks(raw)[0]
    assert {n: p for n, _, p in varz if n in ("feed", "fetch")} == \
        {"feed": True, "fetch": True}
    prog = rf.parse_program_desc(raw)
    assert "feed" not in prog.global_block().vars
    assert "fetch" not in prog.global_block().vars


def test_int_attr_past_int32_goes_on_the_wire_as_long():
    big = 5_000_000_000
    for v in (big, -big):
        enc = rf._encode_wire_attr("n", v)
        assert enc == jrf._encode_wire_attr("n", v)
        assert [x for fld, _, x in rf._fields(enc) if fld == 2] == [9]
        assert rf._parse_attr(enc) == ("n", v)
    for v in ((1 << 31) - 1, -(1 << 31)):
        enc = rf._encode_wire_attr("k", v)
        assert [x for fld, _, x in rf._fields(enc) if fld == 2] == [0]
        assert rf._parse_attr(enc) == ("k", v)


def test_unknown_var_dtype_raises():
    class _V:
        name, dtype, shape, persistable, lod_level = \
            "img_u8", "uint8", (-1, 3, 8, 8), False, 0
    with pytest.raises(ValueError, match="uint8"):
        rf._encode_wire_var(_V())
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[4], dtype="uint8")
        out = fluid.layers.cast(img, "float32")
    with pytest.raises(ValueError, match="uint8"):
        rf.serialize_program_desc(main, ["img"], [out.name])


# ---------------------------------------------------- refusals, aliases --
def test_fused_attention_refused_and_topk_aliased(tmp_path):
    exe = fluid.Executor(fluid.CPUPlace())
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        q = fluid.layers.data(name="q", shape=[4, 2, 8], dtype="float32")
        out = fluid.layers.fused_attention(q, q, q, causal=True)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match="no era registration"):
        fluid.io.save_reference_model(str(tmp_path / "na"), ["q"], [out],
                                      exe, main_program=main, scope=scope)

    main2, startup2 = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main2, startup2):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        vals, _ = fluid.layers.topk(x, k=2)
    d = str(tmp_path / "tk")
    scope2 = fluid.Scope()
    exe.run(startup2, scope=scope2)
    fluid.io.save_reference_model(d, ["x"], [vals], exe, main_program=main2,
                                  scope=scope2)
    raw = open(os.path.join(d, "__model__"), "rb").read()
    assert b"\x1a\x05top_k" in raw and b"\x1a\x04topk" not in raw
    xs = np.random.RandomState(3).rand(3, 6).astype("float32")
    got = _same_outputs(d, {"x": xs})
    np.testing.assert_allclose(got, -np.sort(-xs, axis=1)[:, :2], rtol=1e-6)


def test_export_refusals_and_the_adapter_refusals(tmp_path):
    """Graph-level ops and sequence ops outside the adapter's set refuse
    to export; a padded time-axis concat has no era preimage; a loaded
    desc with a segmentation-restructuring op refuses to adapt."""
    exe = fluid.Executor(fluid.CPUPlace())

    def refuse(build, feeds, match):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            out = build()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        with pytest.raises(ValueError, match=match):
            fluid.io.save_reference_model(str(tmp_path / match[:4]), feeds,
                                          [out], exe, main_program=main,
                                          scope=scope)

    def arrays():
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        i = fluid.layers.fill_constant([1], "int64", 0)
        return fluid.layers.array_read(fluid.layers.array_write(x, i), i)

    def lod_reset():
        w = fluid.layers.data(name="w", shape=[4], dtype="float32",
                              lod_level=1)
        r = fluid.layers.lod_reset(x=w, target_lod=[0, 2, 4])
        return fluid.layers.fc(
            input=fluid.layers.sequence_pool(input=r, pool_type="sum"),
            size=2)

    def time_concat():
        a = fluid.layers.data(name="a", shape=[4], dtype="float32",
                              lod_level=1)
        b = fluid.layers.data(name="b", shape=[4], dtype="float32",
                              lod_level=1)
        cat = fluid.layers.concat([a, b], axis=1)
        return fluid.layers.fc(
            input=fluid.layers.sequence_pool(input=cat, pool_type="sum"),
            size=2)

    refuse(arrays, ["x"], "dense inference|graph-level")
    refuse(lod_reset, ["w"], "handled set")
    refuse(time_concat, ["a", "b"], "TIME axis")

    v = jt.var_desc
    for t in ("lod_reset", "sequence_concat", "sequence_pad"):
        raw = jt._ld(1, jt.block_desc(0, -1, [
            v("words", 5, [-1, 4], lod_level=1),
            v("out", 5, [-1, 4], lod_level=1)],
            [jt.op_desc(t, [("X", ["words"])], [("Out", ["out"])])]))
        with pytest.raises(ValueError, match="restructures sequence"):
            rf.adapt_sequence_layout(rf.parse_program_desc(raw), ["words"])


def test_attr_types_survive_the_wire():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.scale(x, scale=-2.5, bias=0.5)
        y = fluid.layers.reduce_sum(y, dim=[-1], keep_dim=True)
        out = fluid.layers.dropout(y, dropout_prob=0.0, is_test=True)
    raw = rf.serialize_program_desc(main, ["x"], [out.name])
    assert rf.strip_feed_fetch(raw) == (["x"], [out.name])
    ops = {op.type: op for op in rf.parse_program_desc(raw)
           .global_block().ops}
    assert ops["scale"].attrs["scale"] == -2.5
    assert ops["reduce_sum"].attrs["dim"] == [-1]
    assert ops["reduce_sum"].attrs["keep_dim"] is True
    assert ops["dropout"].attrs["is_test"] is True
