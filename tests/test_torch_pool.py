"""K9 (masked sequence pool) and the flash grid on the CPU: the launch plan
`cuda_kernels.pool_launch_plan`, an emulation of the kernel's
decomposition under every plan against the JAX package's Pallas kernel
(interpret mode), and the grid limit helper of the flash kernels
`cuda_kernels.flash_grid` (faults C6 and C7: the card takes the batches
the JAX package takes). The CUDA kernel itself runs only on the card
(chip_smoke.py holds it against masked_pool_plain there).

Inputs are multiples of 1/8 in [-4, 4] made with numpy from a seed: every
partial sum is exact in fp32, so each summation order gives the same bits
and a step counted twice or missed cannot hide in rounding. Tolerance
1e-6 absolute (the division and square root are correctly rounded on
both sides).
"""
import functools
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import cuda_kernels as ck

ATOL = 1e-6
SMS = 132   # the H100's SMs
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "paddle_tpu_torch", "csrc", "masked_pool_fwd.cu")

# (B, T, F, time stride, aligned) of the plan sweep
PLAN_SHAPES = [(b, t, f, sxt, aligned)
               for b, t, f in ((1, 1, 1), (8, 256, 32), (128, 256, 512),
                               (4, 4096, 512), (3, 7, 37), (70000, 8, 32),
                               (2, 0, 16), (5, 33, 3), (1, 100000, 4))
               for sxt, aligned in ((f, True), (2 * f, True), (f, False),
                                    (f + 1, True))]


def _plan(b, t, f, sxt, aligned, cs=None):
    return ck.pool_launch_plan(b, t, f, t * sxt, sxt, aligned, SMS, cs=cs)


@pytest.mark.parametrize("cs", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_puts_every_step_in_exactly_one_block(shape, cs):
    b, t, f, sxt, aligned = shape
    plan = _plan(b, t, f, sxt, aligned, cs=cs)
    assert plan["cs"] in ck.POOL_CLUSTERS and (cs is None or
                                               plan["cs"] == cs)
    assert len(plan["ranges"]) == plan["cs"]
    owners = np.zeros(t, dtype=int)
    for r0, r1 in plan["ranges"]:
        assert 0 <= r0 <= r1 <= t and r1 - r0 <= plan["chunk"]
        owners[r0:r1] += 1
    assert (owners == 1).all()
    assert plan["chunk"] * plan["cs"] >= t and plan["chunk"] >= 1
    lf = plan["lf"]
    assert lf & (lf - 1) == 0 and lf * plan["lt"] == ck.POOL_THREADS
    assert plan["tiles"] * lf >= plan["cols"] > (plan["tiles"] - 1) * lf
    assert plan["grid"] == (b * plan["cs"], plan["tiles"])
    assert plan["grid"][0] <= 2 ** 31 - 1 and plan["grid"][1] <= 65535


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_uses_float4_only_where_the_layout_allows(shape):
    b, t, f, sxt, aligned = shape
    plan = _plan(b, t, f, sxt, aligned)
    allowed = f % 4 == 0 and sxt % 4 == 0 and (t * sxt) % 4 == 0 \
        and aligned
    assert plan["vec"] == (4 if allowed else 1)
    assert plan["cols"] == -(-f // plan["vec"])


@pytest.mark.parametrize("cs", [None, 1, 2, 4, 8])
def test_plan_takes_any_batch(cs):
    """C6: rows (times CS) go on grid.x, so B = 70000 launches."""
    plan = ck.pool_launch_plan(70000, 8, 32, 256, 32, True, SMS, cs=cs)
    assert plan["grid"][0] == 70000 * plan["cs"] and plan["grid"][1] == 1


def test_plan_refuses_what_the_grid_cannot_take():
    # 4-byte columns, 32 a tile: 65536 tiles
    f = 65536 * ck.POOL_COLS
    with pytest.raises(ValueError, match="feature tiles"):
        ck.pool_launch_plan(2, 3, f, 3 * f, f, False, SMS)
    ck.pool_launch_plan(2, 3, f - ck.POOL_COLS, 3 * f, f, False, SMS)
    with pytest.raises(ValueError, match="grid limit"):
        ck.pool_launch_plan(2 ** 31 // 8 + 1, 2, 4, 8, 4, True, SMS, cs=8)
    with pytest.raises(ValueError, match="cluster"):
        ck.pool_launch_plan(2, 3, 4, 12, 4, True, SMS, cs=3)


def test_plan_sizes_clusters_from_the_span_and_the_card():
    # the conv net's serving bucket: one block a row covers its 32 KB
    assert _plan(8, 256, 32, 32, True)["cs"] == 1
    # a long row: the largest cluster, blocks of bounded span
    assert _plan(4, 4096, 512, 512, True)["cs"] == 8
    # many rows, short spans: no split
    assert _plan(70000, 8, 32, 32, True)["cs"] == 1
    # the wide shape: split from its 128 KB span, but not past one wave of
    # the blocks the card holds at once
    for per_sm, cs in ((8, 2), (5, 1)):
        wide = ck.pool_launch_plan(128, 256, 512, 256 * 512, 512, True, SMS,
                                   blocks_per_sm=per_sm)
        assert 128 * wide["tiles"] * wide["cs"] <= SMS * per_sm
        assert wide["cs"] == cs
    with pytest.raises(ValueError):
        ck.pool_launch_plan(1, 2, 4, 8, 4, True, SMS, blocks_per_sm=0)


def test_plan_constants_match_the_kernel_source():
    with open(CSRC) as f:
        src = f.read()

    def const(name):
        return int(re.search(r"constexpr int %s = (\d+);" % name,
                             src).group(1))
    assert const("kThreads") == ck.POOL_THREADS
    assert const("kMaxCluster") == max(ck.POOL_CLUSTERS)
    # one cluster launch a call, no atomics, no second pass
    assert not re.search(r"\batomic\w*\s*\(|\batom\.|\bred\.", src)
    assert src.count("cudaLaunchKernelEx(") == 1
    assert "cudaLaunchAttributeClusterDimension" in src


def _k9_ablation():
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import k9_ablation
    finally:
        sys.path.remove(root)
    return k9_ablation


@pytest.mark.parametrize("variant, marker", [
    ("bulk", "cp.async.bulk"), ("spec", "sum_spec("),
    ("unroll 16", "kUnroll = 16;"), ("8 blocks an SM", "(kThreads, 8)")])
def test_the_ablation_variants_still_match_the_source(variant, marker):
    """k9_ablation.py builds its variants by replacing text of the kernel
    source literally: each text must be there once."""
    ab = _k9_ablation()
    with open(CSRC) as f:
        src = f.read()
    for old, new in ab.EDITS[variant]:
        assert src.count(old) == 1 and new not in src, old
    out = ab.variant_source(variant, CSRC)
    assert marker in out and marker not in src


# -------------------------------------------- the plan's decomposition --

def _emulate(x, lens, ptype, plan):
    """What K9 computes under `plan`: each block sums its range of steps
    below the row's length, then rank 0 adds the blocks in rank order and
    scales. x [B, T, F] fp32, lens [B] int."""
    b, t, f = x.shape
    out = torch.zeros((b, f), dtype=torch.float32)
    for i in range(b):
        steps = min(max(int(lens[i]), 0), t)
        tot = torch.zeros(f, dtype=torch.float32)
        for r0, r1 in plan["ranges"]:
            tot = tot + x[i, r0:min(r1, steps)].float().sum(0)
        denom = torch.tensor(max(float(lens[i]), 1.0), dtype=torch.float32)
        if ptype == "AVERAGE":
            tot = tot / denom
        elif ptype == "SQRT":
            tot = tot / torch.sqrt(denom)
        out[i] = tot
    return out


# name -> (x's shape as allocated, a view of it, lengths)
CASES = {
    "ragged F=64": ((6, 13, 64), None, [13, 0, 1, 20, -2, 7]),
    "F=1": ((4, 9, 1), None, [9, 0, 3, 12]),
    "F=3": ((5, 11, 3), None, [-1, 11, 1, 0, 6]),
    "F=37": ((3, 17, 37), None, [17, 5, 40]),
    "T=1": ((4, 1, 8), None, [1, 0, 3, -4]),
    "B=1": ((1, 10, 16), None, [7]),
    "strided": ((4, 12, 32), lambda a: a[..., :16], [12, 0, 5, 30]),
    "unaligned": ((4, 12, 17), lambda a: a[..., 1:], [12, 1, 0, 9]),
}


def _case(name):
    shape, view, lens = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    base = torch.from_numpy(
        (rng.randint(-32, 33, size=shape) / 8.0).astype(np.float32))
    x = view(base) if view else base
    return x, np.array(lens, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _jax_pool(name, ptype):
    x, lens = _case(name)
    return np.asarray(pk.masked_pool(jnp.asarray(x.contiguous().numpy()),
                                     jnp.asarray(lens), ptype=ptype,
                                     interpret=True))


@pytest.mark.parametrize("cs", [1, 2, 4, 8])
@pytest.mark.parametrize("ptype", ["SUM", "AVERAGE", "SQRT"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_decomposition_matches_jax_kernel(name, ptype, cs):
    x, lens = _case(name)
    plan = ck.pool_launch_plan(*x.shape, x.stride(0), x.stride(1),
                               x.data_ptr() % 16 == 0, SMS, cs=cs)
    if name == "unaligned":
        assert plan["vec"] == 1
    if name == "strided":
        assert x.stride(1) == 2 * x.shape[2] and plan["vec"] == 4
    got = _emulate(x, lens, ptype, plan)
    want = _jax_pool(name, ptype)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        ck.masked_pool(x, torch.from_numpy(lens), ptype).numpy(), want,
        rtol=0, atol=ATOL)
    assert (got.numpy()[lens <= 0] == 0).all()


# ----------------------------------------------- the flash grid (C7) --

@pytest.mark.parametrize("b, h, t, grid", [
    (8193, 8, 16, (65544, 1)),          # C7: B*H over 65535
    (1, 1, 65535 * ck.FLASH_ROWS, (1, 65535)),
    (32, 8, 256, (256, 4)),
    (2 ** 31 - 1, 1, 1, (2 ** 31 - 1, 1)),
])
def test_flash_grid_takes_any_batch_times_heads(b, h, t, grid):
    assert ck.flash_grid(b, h, t) == grid


@pytest.mark.parametrize("b, h, t", [
    (1, 1, 65535 * ck.FLASH_ROWS + 1),  # T tiles over 65535 on grid.y
    (2 ** 28, 8, 16),                   # B*H over grid.x's 2^31 - 1
])
def test_flash_grid_refuses_what_the_grid_cannot_take(b, h, t):
    with pytest.raises(ValueError, match="grid limits"):
        ck.flash_grid(b, h, t, "flash_attention_fwd")


def test_flash_rows_match_the_kernel_sources():
    for name in ("flash_attention_fwd.cu", "flash_attention_bwd.cu"):
        with open(os.path.join(os.path.dirname(CSRC), name)) as f:
            src = f.read()
        warps = int(re.search(r"constexpr int kWarps = (\d+);",
                              src).group(1))
        assert re.search(r"constexpr int kRows = kWarps \* 16;", src)
        assert warps * 16 == ck.FLASH_ROWS
        # the three launches put B*H on grid.x and the row tiles on grid.y
        assert src.count("dim3 grid(B * H, (T + kRows - 1) / kRows);") \
            == (1 if "fwd" in name else 2)
