"""K6 (fused LSTM, a thread-block cluster per group of rows) and K8 (masked
softmax, one read into registers) on the CPU: the launch plan, a torch
emulation of each kernel's decomposition held against the JAX package's
Pallas kernels in interpret mode, and the sources' structure. The CUDA
kernels run only on the card (chip_smoke.py holds them against their
plain versions there).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the LSTM emulation 1e-5 (fp32 on both sides, sums in another
order, through 16 steps of a recurrence whose forget gate is below 1);
the softmax emulation 1e-6 (its values are at most 1 and each is one
exponential over a sum of at most T terms).
"""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import cuda_kernels as ck

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "paddle_tpu_torch", "csrc")
LSTM_TOL = dict(rtol=1e-5, atol=1e-5)
SOFTMAX_TOL = dict(rtol=1e-6, atol=1e-6)
SMEM_LIMIT = 232448


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


# ---------------------------------------------------------------------------
# K6's launch plan
# ---------------------------------------------------------------------------

def _check_plan(plan, bsz, d):
    cs, rows = plan["cs"], plan["rows"]
    assert 1 <= cs <= 16 and cs <= d
    assert plan["grid"] % cs == 0 and plan["grid"] == plan["clusters"] * cs
    # the unit slices cover D exactly once, block by block
    units = plan["units"]
    assert len(units) == cs and units[0][0] == 0 and units[-1][1] == d
    assert all(a[1] == b[0] for a, b in zip(units, units[1:]))
    assert all(u1 > u0 for u0, u1 in units)
    assert max(u1 - u0 for u0, u1 in units) == plan["ku"] == -(-d // cs)
    # R rows a cluster cover B, and no cluster is empty
    assert plan["clusters"] * rows >= bsz > (plan["clusters"] - 1) * rows
    assert plan["rg"] in (4, 8) and plan["rp"] % plan["rg"] == 0
    assert rows <= plan["rp"] < rows + plan["rg"]
    assert 1 <= plan["ks"] <= d
    assert plan["smem"] == 4 * ck._lstm_smem_floats(
        d, rows, plan["ku"], plan["rp"], plan["ks"], plan["resident"],
        plan["prefetch"])
    assert plan["smem"] < SMEM_LIMIT
    assert plan["threads"] == ck.LSTM_THREADS
    assert plan["waves"] >= 1


@pytest.mark.parametrize("sm", [132, 114])
@pytest.mark.parametrize("bsz", [1, 4, 8, 128])
def test_lstm_launch_plan_path_widths(sm, bsz):
    """At the path's D = 128 (batch buckets 1, 4, 8 and the training batch
    of 128): a resident plan whose clusters all run at once."""
    plan = ck.lstm_launch_plan(bsz, 128, sm)
    _check_plan(plan, bsz, 128)
    assert plan["resident"] and plan["prefetch"]
    assert plan["waves"] == 1 and plan["grid"] <= sm


@pytest.mark.parametrize("bsz", [1, 8, 128])
def test_lstm_launch_plan_streams_wide_weights(bsz):
    """D = 512: W is 4 MB, 256 KB a block even over 16 blocks, so the
    slices are read from L2 at every step."""
    plan = ck.lstm_launch_plan(bsz, 512, 132)
    _check_plan(plan, bsz, 512)
    assert not plan["resident"]


@pytest.mark.parametrize("d", [1, 37, 100])
@pytest.mark.parametrize("bsz", [1, 5, 128])
def test_lstm_launch_plan_odd_widths(d, bsz):
    _check_plan(ck.lstm_launch_plan(bsz, d, 132), bsz, d)


def test_lstm_launch_plan_follows_what_the_card_runs():
    """The clusters the card runs at once decide the plan: a refused size
    is never taken, a size that runs fewer clusters needs more rows a
    cluster, and a plan that must run in waves says so."""
    no16 = ck.lstm_launch_plan(8, 128, 132,
                               active=lambda cs, *_: 0 if cs > 8 else 64)
    assert no16["cs"] <= 8
    _check_plan(no16, 8, 128)
    few = ck.lstm_launch_plan(128, 128, 132, active=lambda cs, *_: 2,
                              cs=8)
    assert few["clusters"] <= 2 or few["waves"] > 1
    _check_plan(few, 128, 128)
    with pytest.raises(ValueError, match="no cluster plan"):
        ck.lstm_launch_plan(8, 128, 132, active=lambda *_: 0)


def test_lstm_launch_plan_pins_and_refusals():
    plan = ck.lstm_launch_plan(128, 128, 132, cs=8, rows=8)
    assert (plan["cs"], plan["rows"]) == (8, 8)
    _check_plan(plan, 128, 128)
    for args in ((0, 128, 132), (8, 0, 132), (8, 128, 0), (-1, 8, 132)):
        with pytest.raises(ValueError, match="positive"):
            ck.lstm_launch_plan(*args)
    with pytest.raises(ValueError, match="cluster of 4"):
        ck.lstm_launch_plan(8, 3, 132, cs=4)


# ---------------------------------------------------------------------------
# K6's decomposition against the JAX Pallas kernel
# ---------------------------------------------------------------------------

def _emulate_k6(x, w, b, h0, c0, lens, reverse, plan):
    """K6's arithmetic as its plan lays it out, in torch: for each cluster
    of `rows` rows and each block of it, the gate product of the block's
    unit slice (columns unit-major, the four gates of a unit together)
    split into `ks` slices of D whose partial sums are added in slice
    order, then (x + sum) + b, the cell update and the masked carry of the
    block's units; the blocks' h slices are gathered into the next step's
    h_prev of the cluster. Within one slice the products are summed by
    torch's matmul, not in the kernel's k order."""
    bsz, t, four_d = x.shape
    d = four_d // 4
    rows, ks_n = plan["rows"], plan["ks"]
    kslice = -(-d // ks_n)
    hidden = torch.empty((bsz, t, d))
    cell = torch.empty((bsz, t, d))
    lens_t = torch.full((bsz,), t) if lens is None else lens.long()
    for row0 in range(0, bsz, rows):
        rs = slice(row0, min(bsz, row0 + rows))
        h = torch.zeros((rs.stop - row0, d)) if h0 is None else h0[rs].clone()
        c = torch.zeros_like(h) if c0 is None else c0[rs].clone()
        for k in range(t):
            s = t - 1 - k if reverse else k
            h_next = h.clone()
            for u0, u1 in plan["units"]:
                # the block's W slice, unit-major: column 4 u + g
                cols = [g * d + u for u in range(u0, u1) for g in range(4)]
                wj = w[:, cols]
                acc = torch.zeros((h.shape[0], len(cols)))
                for q in range(ks_n):
                    lo, hi = q * kslice, min(d, (q + 1) * kslice)
                    acc = acc + h[:, lo:hi] @ wj[lo:hi]
                gates = (x[rs, s][:, cols] + acc) + b[cols]
                gates = gates.reshape(-1, u1 - u0, 4)
                z = torch.tanh(gates[..., 0])
                ig, fg, og = (torch.sigmoid(gates[..., g]) for g in (1, 2, 3))
                c_prev, h_prev = c[:, u0:u1], h[:, u0:u1]
                c_new = fg * c_prev + ig * z
                h_new = og * torch.tanh(c_new)
                valid = (s < lens_t[rs])[:, None]
                h_next[:, u0:u1] = torch.where(valid, h_new, h_prev)
                c[:, u0:u1] = torch.where(valid, c_new, c_prev)
            h = h_next
            hidden[rs, s] = h
            cell[rs, s] = c
    return hidden, cell


def _lstm_inputs(b, t, d, seed, with_state):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, t, 4 * d) * 0.5).astype(np.float32)
    w = (rng.randn(d, 4 * d) * (0.8 / np.sqrt(d))).astype(np.float32)
    bias = (rng.randn(4 * d) * 0.1).astype(np.float32)
    h0 = (rng.randn(b, d) * 0.2).astype(np.float32) if with_state else None
    c0 = (rng.randn(b, d) * 0.2).astype(np.float32) if with_state else None
    lens = np.array([t, 0, 1, rng.randint(2, t)], dtype=np.int32)[:b]
    return x, w, bias, h0, c0, lens


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cs,rows", [(2, 4), (4, 2)])
@pytest.mark.parametrize("d", [8, 37])
def test_k6_decomposition_matches_jax_kernel(d, cs, rows, reverse,
                                             with_state):
    """The emulated cluster decomposition at x [4, 16, 4D] (one cluster of
    4 rows or two of 2) against the JAX fused_lstm in interpret mode,
    lengths T, 0, 1 and one between. The JAX kernel takes the length-0
    row as it is (every step masked), so no stand-in is needed; the row
    must come out as exactly h0 and c0 in both."""
    x, w, bias, h0, c0, lens = _lstm_inputs(4, 16, d, seed=60 + d,
                                            with_state=with_state)
    plan = ck.lstm_launch_plan(4, d, 132, cs=cs, rows=rows)
    assert len(plan["units"]) == cs and plan["clusters"] == 4 // rows
    hidden, cell = _emulate_k6(*(_t(a) for a in (x, w, bias, h0, c0, lens)),
                               reverse, plan)
    zeros = np.zeros((4, d), np.float32)
    jh, jc = pk.fused_lstm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                           jnp.asarray(zeros if h0 is None else h0),
                           jnp.asarray(zeros if c0 is None else c0),
                           jnp.asarray(lens), reverse=reverse,
                           interpret=True)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jh), **LSTM_TOL)
    np.testing.assert_allclose(cell.numpy(), np.asarray(jc), **LSTM_TOL)
    first = zeros[1] if h0 is None else h0[1]
    assert np.all(hidden.numpy()[1] == first)
    assert np.all(np.asarray(jh)[1] == first)
    # and the plain version, the card's yardstick, agrees with both
    ph, pc = ck.fused_lstm_plain(*(_t(a) for a in (x, w, bias, h0, c0,
                                                   lens)), reverse=reverse)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **LSTM_TOL)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), **LSTM_TOL)


# ---------------------------------------------------------------------------
# K8's passes against the JAX Pallas kernel
# ---------------------------------------------------------------------------

def _emulate_k8_online(x, lens):
    """K8 above its register cap, in torch fp32: lane l of a row's warp
    walks t = l, l + 32, ... < len keeping a running max m and a sum s of
    exp(x - m) (rescaled by exp(m_old - m) when m grows); the warp's max
    M and sum sum_l s_l exp(m_l - M) merge the lanes; then one pass
    writes exp(x - M) / max(sum, 1e-30), 0 past the length."""
    n, t = x.shape
    neg = torch.tensor(-1e30, dtype=torch.float32)
    y = torch.zeros((n, t), dtype=torch.float32)
    for r in range(n):
        ln = int(min(max(int(lens[r]), 0), t))
        ms, ss = [], []
        for lane in range(32):
            m, s = neg.clone(), torch.tensor(0.0)
            for i in range(lane, ln, 32):
                v = x[r, i]
                if v > m:
                    s = s * torch.exp(m - v) + 1.0
                    m = v
                else:
                    s = s + torch.exp(v - m)
            ms.append(m)
            ss.append(s)
        mw = torch.stack(ms).max()
        # the warp's sum by shuffles: a butterfly over the lanes
        parts = [s * torch.exp(m - mw) for m, s in zip(ms, ss)]
        width = 16
        while width:
            parts = [parts[i] + parts[i ^ width] for i in range(32)]
            width //= 2
        denom = torch.clamp_min(parts[0], 1e-30)
        if ln:
            y[r, :ln] = torch.exp(x[r, :ln] - mw) / denom
    return y


def test_k8_online_pass_matches_jax_kernel():
    """Rows of 1100 steps (above the 1024 the registers hold), lengths 0,
    1, T and random, at the scale of attention scores."""
    rng = np.random.RandomState(70)
    n, t = 5, 1100
    assert t > ck.SOFTMAX_REG_CAP
    x = (rng.randn(n, t) * 3).astype(np.float32)
    lens = np.array([t, 0, 1, rng.randint(2, t), rng.randint(2, t)],
                    dtype=np.int32)
    got = _emulate_k8_online(torch.from_numpy(x), torch.from_numpy(lens))
    want = pk.masked_softmax(jnp.asarray(x), jnp.asarray(lens),
                             interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SOFTMAX_TOL)
    assert np.all(got.numpy()[1] == 0.0)
    assert got.numpy()[2, 0] == 1.0 and np.all(got.numpy()[2, 1:] == 0.0)


# ---------------------------------------------------------------------------
# the sources
# ---------------------------------------------------------------------------

def _body(src, start, end):
    i = src.index(start)
    return src[i:src.index(end, i)]


def test_k6_source_is_a_cluster_with_one_barrier_a_step():
    src = _source("fused_lstm_fwd.cu")
    assert "cudaLaunchAttributeClusterDimension" in src
    assert "cudaLaunchAttributeCooperative" not in src
    assert "barrier.cluster.arrive.release" in src
    assert "barrier.cluster.wait.acquire" in src
    assert "st.shared::cluster.f32" in src and "mapa.shared::cluster" in src
    assert "cudaOccupancyMaxActiveClusters" in src
    assert "atomic" not in src.lower().replace("no atomics", "")
    kernel = _body(src, "fused_lstm_fwd_kernel(", "\ntemplate <")
    step = kernel[kernel.index("for (int k = 0; k < T; ++k)"):]
    # one cluster barrier a step, in its two halves, and one block barrier
    assert step.count("cluster_arrive()") == 1
    assert step.count("cluster_wait()") == 1
    assert step.count("__syncthreads()") == 1
    # h crosses to the peers at one place of a step
    assert step.count("st_peer(") == 1
    # the resident W slice is read from shared memory, never from w
    assert "w_s[i] = " in kernel


def test_k8_source_reads_x_once_in_registers():
    src = _source("masked_softmax_fwd.cu")
    reg = _body(src, "masked_softmax_reg_kernel(", "// Online path")
    # x is read in the one load loop only, and exp taken once an element
    assert len(re.findall(r"\bxr\[", reg)) == 1
    assert reg.count("reinterpret_cast<const float4*>(xr") == 1
    assert reg.count("expf(") == 1
    online = _body(src, "masked_softmax_online_kernel(", "template <")
    # above the cap: two passes over x, not three
    assert len(re.findall(r"\bxr\[", online)) == 2
    assert "T <= %d" % ck.SOFTMAX_REG_CAP in src


def _k6_ablation():
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import k6_ablation
    finally:
        sys.path.remove(root)
    return k6_ablation


@pytest.mark.parametrize("kernel", ["K6", "K8"])
def test_the_ablation_script_still_matches_the_sources(kernel):
    """k6_ablation.py (and chip_smoke.py's K6 step floor through it)
    replaces text of the kernel sources literally: each must be there
    once, or the variants time something else."""
    ab = _k6_ablation()
    if kernel == "K6":
        path, table = ab.K6_SRC, {**ab.PARTS, **ab.PADDED}
        variants = {**ab.VARIANTS, "padded launch": ["padded launch"]}
    else:
        path, table, variants = ab.K8_SRC, ab.K8_PARTS, ab.K8_VARIANTS
    src = _source(os.path.basename(path))
    for edits in table.values():
        for old, new in edits:
            assert src.count(old) == 1 and new not in src, old
    out = ab.variant_sources(path, table, variants)
    assert set(out) == set(variants) and out["base"] == src
    assert all(out[name] != src for name in variants if name != "base")


def test_wrappers_keep_the_plain_versions_on_the_cpu():
    """On CPU tensors both wrappers run their plain versions, launch
    nothing, and a length-0 row comes out exactly as its initial state
    (K6) or all 0 (K8)."""
    ck.reset_launch_counts()
    x, w, bias, h0, c0, lens = _lstm_inputs(4, 9, 8, seed=80,
                                            with_state=True)
    args = [_t(a) for a in (x, w, bias, h0, c0, lens)]
    for reverse in (False, True):
        hidden, cell = ck.fused_lstm(*args, reverse=reverse)
        want = ck.fused_lstm_plain(*args, reverse=reverse)
        assert torch.equal(hidden, want[0]) and torch.equal(cell, want[1])
        assert torch.equal(hidden[1], args[3][1].expand(9, -1))
        assert torch.equal(cell[1], args[4][1].expand(9, -1))
    sx = torch.from_numpy((np.random.RandomState(81).randn(3, 1100) * 3)
                          .astype(np.float32))
    sl = torch.tensor([1100, 0, 7], dtype=torch.int32)
    y = ck.masked_softmax(sx, sl)
    assert torch.equal(y, ck.masked_softmax_plain(sx, sl))
    assert torch.all(y[1] == 0)
    assert sum(ck.launch_counts().values()) == 0
