"""The numerical guards and FLAGS_check_nan_inf against the JAX package,
on the CPU.

Both packages build the same small Adam MLP; the JAX package's startup
state is carried into the port by `io.scope_from_numpy`, and both run the
same seeded numpy feeds. The cases:
- a NaN feed at step 3 raises NumericalGuardError in both, naming the
  same sorted vars; the port's scope after the trip equals its pre-step
  state exactly, and the next 3 steps stay within 1e-5 of the JAX
  package (losses and every persistable);
- a NaN in a gradient but not in the loss; gate_updates=False;
  granular=False; check_params; a program with nothing to watch;
- a vector flag under FLAGS_tensor_array_safety=0 still raises, in one
  flag read a run;
- steps=4 with a NaN record at step 2 (reader-fed, dropout on): the call
  raises, and its state is bit-equal to 4 sequential steps=1 runs;
- last_stats["grad_norm"] within 1e-5 relative of the JAX package's, the
  block's max under steps=K, and within bf16's tolerance under AMP;
- check_finite_guard's reduction on NaN, +inf, -inf and 3e38 in one
  element of a bf16 and an fp32 tensor (exact);
- FLAGS_check_nan_inf: an explosion named by var, a healthy run, the env
  flag.
"""
import re

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import resilience as jrz

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import resilience as trz
from paddle_tpu_torch.ops.guard_ops import finite_checks

_PKG = {"jax": jfluid, "port": tfluid}
_RZ = {"jax": jrz, "port": trz}
R = np.random.RandomState(7)
DATA = [R.rand(8, 6).astype("f") for _ in range(8)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feed(i, x=None):
    x = DATA[i % len(DATA)] if x is None else x
    return {"x": x, "y": DATA[i % len(DATA)][:, :1]}


def _mlp(fluid, opt="adam", lr=0.01):
    x = fluid.layers.data(name="x", shape=[6], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(input=x, size=8, act="tanh")
    p = fluid.layers.fc(input=h, size=1)
    loss = fluid.layers.mean(
        x=fluid.layers.square_error_cost(input=p, label=y))
    if opt == "adam":
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    else:
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    return loss


def _build(pkg, body=_mlp, amp=False, **guard_kw):
    fluid = _PKG[pkg]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = body(fluid)
    if amp:
        main.enable_mixed_precision()
    _RZ[pkg].install_numeric_guards(main, loss=loss, **guard_kw)
    return main, startup, loss


class _Pair(object):
    """One program in both packages, the port starting from the JAX
    package's startup state."""

    def __init__(self, body=_mlp, amp=False, **guard_kw):
        self.j = _build("jax", body, amp, **guard_kw)
        self.t = _build("port", body, amp, **guard_kw)
        self.jexe = jfluid.Executor(jfluid.CPUPlace())
        self.jscope = jfluid.Scope()
        with jfluid.scope_guard(self.jscope):
            self.jexe.run(self.j[1])
        arrays = {n: np.asarray(self.jscope.get(n))
                  for n in self.jscope.names()}
        self.texe = tfluid.Executor("cpu")
        self.tscope = tio.scope_from_numpy(arrays, "cpu", program=self.t[0])

    def run_jax(self, feed, steps=1):
        with jfluid.scope_guard(self.jscope):
            return self.jexe.run(self.j[0], feed=feed, fetch_list=[self.j[2]],
                                 steps=steps, fetch_reduce="last")

    def run_port(self, feed, steps=1):
        return self.texe.run(self.t[0], feed=feed, fetch_list=[self.t[2]],
                             scope=self.tscope, steps=steps,
                             fetch_reduce="last")

    def state(self, pkg):
        if pkg == "jax":
            return {n: np.asarray(self.jscope.get(n)).copy()
                    for n in self.jscope.names()}
        return {n: self.tscope.get(n).detach().float().numpy().copy()
                for n in self.tscope.names()}


def _names(err):
    """The vars a guard error names, sorted."""
    return sorted(re.findall(r"non-finite value detected in '([^']+)'",
                             str(err)))


def _trip(run, feed):
    with pytest.raises(RuntimeError) as ei:
        run(feed)
    assert type(ei.value).__name__ == "NumericalGuardError", ei.value
    return ei.value


def _close(a, b, tol=1e-5):
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    for n in a:
        np.testing.assert_allclose(a[n], b[n], rtol=tol, atol=tol,
                                   err_msg=n)


def test_nan_feed_trip_names_gates_and_resumes_like_jax():
    pair = _Pair()
    for i in range(3):
        np.testing.assert_allclose(pair.run_port(_feed(i))[0],
                                   pair.run_jax(_feed(i))[0], rtol=1e-5)
    before = {n: v.clone() for n, v in pair.tscope._vars.items()}
    bad = DATA[3].copy()
    bad[0, 0] = np.nan
    ej = _trip(pair.run_jax, _feed(3, bad))
    et = _trip(pair.run_port, _feed(3, bad))
    assert _names(et) == _names(ej) and _names(et)
    assert "fc_0.w_0@GRAD" in _names(et)
    for n, v in before.items():
        assert torch.equal(pair.tscope.get(n), v), n
    for i in range(4, 7):
        np.testing.assert_allclose(pair.run_port(_feed(i))[0],
                                   pair.run_jax(_feed(i))[0], rtol=1e-5)
    _close(pair.state("port"), pair.state("jax"))


def _sqrt_body(fluid):
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    p = fluid.layers.fc(input=x, size=1, bias_attr=False)
    loss = fluid.layers.mean(x=fluid.layers.sqrt(p))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def test_nan_in_grad_not_loss_names_the_grads():
    """sqrt(x @ w) at x = 0: the loss is 0, its gradient infinite."""
    pair = _Pair(_sqrt_body)
    zeros = {"x": np.zeros((4, 4), "f")}
    ej = _trip(pair.run_jax, zeros)
    et = _trip(pair.run_port, zeros)
    assert _names(et) == _names(ej) == ["fc_0.w_0@GRAD"]


def test_detect_only_and_combined_message_match_jax():
    bad = _feed(0, np.full((8, 6), np.nan, "f"))
    for granular in (True, False):
        pair = _Pair(granular=granular, gate_updates=False)
        assert pair.t[0]._numeric_guards["gated"] == []
        ej = _trip(pair.run_jax, bad)
        et = _trip(pair.run_port, bad)
        assert str(et) == str(ej)
        # detect-only: the poisoned update landed in both
        assert not np.isfinite(pair.state("port")["fc_0.w_0"]).all()
        assert not np.isfinite(pair.state("jax")["fc_0.w_0"]).all()
    # re-installing is a no-op
    main, _, loss = pair.t
    assert trz.install_numeric_guards(main, loss=loss) is \
        main._numeric_guards


def test_check_params_names_the_overflowing_parameter():
    """Finite gradients, an update that overflows the parameter: only
    check_params sees it, and the gate keeps the old value."""
    def body(fluid):
        return _mlp(fluid, opt="sgd", lr=3e38)
    pair = _Pair(body, check_params=True)
    big = _feed(0, DATA[0] * 1e3)
    ej = _trip(pair.run_jax, big)
    before = {n: v.clone() for n, v in pair.tscope._vars.items()}
    et = _trip(pair.run_port, big)
    assert _names(et) == _names(ej)
    assert any("@GRAD" not in n for n in _names(et))
    for n, v in before.items():
        assert torch.equal(pair.tscope.get(n), v), n


def test_nothing_to_watch_raises_in_both():
    for pkg in ("jax", "port"):
        fluid = _PKG[pkg]
        with pytest.raises(ValueError):
            _RZ[pkg].install_numeric_guards(fluid.Program())


def test_vector_flag_raises_without_array_safety(monkeypatch):
    monkeypatch.setenv("FLAGS_tensor_array_safety", "0")
    pair = _Pair()
    assert not pair.texe._array_safety
    pair.run_port(_feed(0))
    assert pair.texe.flag_reads == 1
    bad = DATA[1].copy()
    bad[2, 3] = np.inf
    ej = _trip(pair.run_jax, _feed(1, bad))
    et = _trip(pair.run_port, _feed(1, bad))
    assert _names(et) == _names(ej)
    assert pair.texe.flag_reads == 2


def _reader_program(fluid, path):
    x, y = fluid.layers.read_file(fluid.layers.open_recordio_file(
        filename=path, shapes=[[-1, 6], [-1, 1]], lod_levels=[0, 0],
        dtypes=["float32", "float32"]))
    h = fluid.layers.fc(input=x, size=8, act="tanh")
    h = fluid.layers.dropout(h, dropout_prob=0.2)
    p = fluid.layers.fc(input=h, size=1)
    loss = fluid.layers.mean(
        x=fluid.layers.square_error_cost(input=p, label=y))
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


def test_kblock_nan_at_step_2_is_sticky_and_bit_equal_to_sequential(
        tmp_path):
    path = str(tmp_path / "data.recordio")

    def gen():
        r = np.random.RandomState(3)
        for _ in range(16):
            xs = r.rand(4, 6).astype("float32")
            yield xs, xs[:, :1].copy()

    tfluid.recordio_writer.convert_reader_to_recordio_file(path, gen)

    def run(k):
        main, startup = tfluid.Program(), tfluid.Program()
        main.random_seed = startup.random_seed = 9
        with tfluid.unique_name.guard(), \
                tfluid.program_guard(main, startup):
            loss = _reader_program(tfluid, path)
        trz.install_numeric_guards(main, loss=loss)
        exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
        exe.run(startup, scope=scope)
        trips = 0
        with trz.FaultPlan(["reader_nan@2"]):
            for _ in range(4 // k):
                try:
                    exe.run(main, fetch_list=[loss], scope=scope, steps=k,
                            fetch_reduce="last")
                except trz.NumericalGuardError:
                    trips += 1
        return trips, {n: v.clone() for n, v in scope._vars.items()
                       if isinstance(v, torch.Tensor)}

    trips1, seq = run(1)
    trips4, blk = run(4)
    assert trips1 == trips4 == 1
    assert set(seq) == set(blk)
    for n in seq:
        assert torch.equal(seq[n], blk[n]), n
        assert torch.isfinite(blk[n].float()).all(), n


def test_grad_norm_stat_matches_jax_and_is_the_block_max():
    pair = _Pair(grad_norm=True)
    for i in range(2):
        pair.run_jax(_feed(i))
        pair.run_port(_feed(i))
        gj = float(np.asarray(pair.jexe.last_stats["grad_norm"]))
        gt = pair.texe.last_stats["grad_norm"]
        assert isinstance(gt, float) and gt > 0
        np.testing.assert_allclose(gt, gj, rtol=1e-5)
    # steps=4 over one feed: the stat is the max of the 4 sequential norms
    reads = pair.texe.flag_reads
    seq = _Pair(grad_norm=True)
    norms = []
    for _ in range(4):
        seq.run_port(_feed(2))
        norms.append(seq.texe.last_stats["grad_norm"])
    blk = _Pair(grad_norm=True)
    blk.run_port(_feed(2), steps=4)
    assert blk.texe.flag_reads == 1
    np.testing.assert_allclose(blk.texe.last_stats["grad_norm"], max(norms),
                               rtol=1e-6)
    blk.run_jax(_feed(2), steps=4)
    np.testing.assert_allclose(
        blk.texe.last_stats["grad_norm"],
        float(np.asarray(blk.jexe.last_stats["grad_norm"])), rtol=1e-5)
    assert pair.texe.flag_reads == reads


def test_grad_norm_under_bf16_amp_within_bf16_tolerance():
    pair = _Pair(amp=True, grad_norm=True)
    pair.run_jax(_feed(0))
    pair.run_port(_feed(0))
    gj = float(np.asarray(pair.jexe.last_stats["grad_norm"]))
    np.testing.assert_allclose(pair.texe.last_stats["grad_norm"], gj,
                               rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf"), 3e38],
                         ids=["nan", "+inf", "-inf", "3e38"])
def test_check_finite_reduction_is_exactly_isfinite_all(dtype, value):
    g = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    big = torch.full((64,), 3e38).to(dtype)   # overflows a sum of squares
    g = g.to(dtype)
    g[17] = value
    want = not bool(torch.isfinite(g).all())
    flags, norms = finite_checks([big, g, torch.ones(3, dtype=dtype),
                                  torch.empty(0, dtype=dtype)])
    assert flags.tolist() == [False, want, False, False]
    assert all(n.dtype == torch.float32 for n in norms)


def _explosive(fluid, lr):
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(input=x, size=1)
    cost = fluid.layers.mean(
        fluid.layers.square_error_cost(input=pred, label=y))
    fluid.optimizer.SGD(learning_rate=lr).minimize(cost)
    return cost


def _nan_inf_session(lr):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        cost = _explosive(tfluid, lr)
    exe, scope = tfluid.Executor("cpu", check_nan_inf=True), tfluid.Scope()
    exe.run(startup, scope=scope)
    return exe, scope, main, cost


def test_check_nan_inf_names_the_exploding_var():
    exe, scope, main, cost = _nan_inf_session(1e12)
    rng = np.random.RandomState(0)
    xs = rng.rand(8, 4).astype("float32")
    ys = rng.rand(8, 1).astype("float32")
    with pytest.raises(RuntimeError) as ei:
        for _ in range(10):
            exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[cost],
                    scope=scope)
    msg = str(ei.value)
    assert "NaN" in msg or "Inf" in msg
    assert re.search(r"variable '[^']+' contains", msg), msg


def test_check_nan_inf_passes_a_healthy_run():
    exe, scope, main, cost = _nan_inf_session(0.01)
    rng = np.random.RandomState(0)
    for _ in range(5):
        loss, = exe.run(main, feed={"x": rng.rand(8, 4).astype("float32"),
                                    "y": rng.rand(8, 1).astype("float32")},
                        fetch_list=[cost], scope=scope)
    assert np.isfinite(loss).all()


def test_check_nan_inf_env_flag(monkeypatch):
    monkeypatch.setenv("FLAGS_check_nan_inf", "1")
    assert tfluid.Executor("cpu")._check_nan_inf
    assert not tfluid.Executor("cpu", check_nan_inf=False)._check_nan_inf
    monkeypatch.setenv("FLAGS_check_nan_inf", "0")
    assert not tfluid.Executor("cpu")._check_nan_inf


def test_gate_writes_backups_in_place_only_on_a_trip():
    """guard_restore's plain version (what the CPU runs, and what the
    card's kernel is held against): each updated value takes its backup
    where the flag is False, stays where it is True; the gate clones an
    updated value that shares memory with a backup or another one, or is
    a view, before writing it in place."""
    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.ops.guard_ops import _exclusive
    gen = torch.Generator().manual_seed(3)
    ys = [torch.randn(5, 3, generator=gen), torch.arange(4)]
    for flag in (True, False):
        xs = [torch.randn(5, 3, generator=gen), torch.arange(4) * 7]
        want = [x.clone() for x in (xs if flag else ys)]
        ck.reset_launch_counts()
        ck.guard_restore(torch.tensor([flag]), xs, ys)
        assert all(torch.equal(a, b) for a, b in zip(xs, want))
        assert ck.launch_counts()["guard_restore"] == 0
    base = torch.randn(8)
    shared = [ys[0], base[:4], base, base]
    got = _exclusive(shared, ys)
    assert got[0] is not ys[0] and torch.equal(got[0], ys[0])
    assert got[1] is not shared[1] and got[2] is shared[2]
    assert got[3] is not base and torch.equal(got[3], base)
