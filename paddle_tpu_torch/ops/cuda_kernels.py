"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

Counterpart of the JAX package's ops/pallas_kernels.py. Each TPU kernel
on the port's path becomes a CUDA C++ kernel in `paddle_tpu_torch/csrc/`
(see the note at the top of each source for what it replaces and what
bounds it). The sources build at first use with `nvcc` into one shared
library with a plain C interface (`build()`), loaded with ctypes.

Beside each kernel:
  * a wrapper (`flash_attention_fwd`, `flash_attention_bwd_dkdv`,
    `flash_attention_bwd_dq`, `softmax_xent_fwd`, `layer_norm_fwd`,
    `fused_lstm`, `fused_lstmp`, `masked_softmax`, `masked_pool`) whose
    dispatch rule is the tensor's device: `meta` returns empty outputs of
    the right shape (build-time shape inference), `cpu` runs the plain
    version, `cuda` launches the kernel or raises. Nothing falls back;
  * a plain PyTorch version (`*_plain`) of the same function — what the
    CPU runs, and what the card's kernel is held against;
  * a launch count per kernel (`launch_counts()`, keyed by
    `KERNEL_NAMES`), raised by one exactly where the kernel is launched,
    so a run can show the main path went through it (a CUDA graph's
    capture takes its counts back out and each replay adds them again:
    `take_launches`, `add_launches`). The flash wrappers
    (K1-K3) launch an fp32 or a bf16 kernel (in bf16 the wgmma kernels
    of flash_attention_fwd_bf16.cu, flash_attention_bwd_dkdv_bf16.cu and
    flash_attention_bwd_dq_bf16.cu), each counted under its own name (the
    bf16 one's ends in "_bf16").

Gradients: seven torch.autograd.Functions mirror the JAX package's
custom_vjps — `FlashAttention` (forward K1, backward K2 + K3, as
`_flash_core`), `LayerNorm` (forward K5, backward in torch, as
`_ln_core_bwd`), `SoftmaxXent` (forward K4, backward in torch, as
`_xent_core_bwd`), `FusedLSTM` (forward K6, backward the saved-state
reverse scan in torch, as `_lstm_seq_core_bwd`), `FusedLSTMP` (forward
K7, backward likewise, as `_lstmp_seq_core_bwd`), `MaskedSoftmax` (forward
K8, backward in torch, as `_masked_softmax_core_bwd`) and `MaskedPool`
(forward K9, backward in torch, as `_masked_pool_core_bwd`).
"""
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time

import torch

__all__ = ["build", "flash_attention_fwd", "flash_attention_fwd_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_bwd_dkdv", "flash_attention_bwd_dq",
           "softmax_xent_fwd", "softmax_xent_fwd_plain", "hard_label_index",
           "layer_norm_fwd", "layer_norm_fwd_plain", "fused_lstm",
           "fused_lstm_plain", "fused_lstm_bwd", "lstm_launch_plan",
           "fused_lstmp",
           "fused_lstmp_plain", "fused_lstmp_bwd", "lstmp_launch_plan",
           "masked_softmax", "masked_softmax_plain", "masked_pool",
           "masked_pool_plain", "pool_launch_plan", "flash_grid",
           "FlashAttention", "LayerNorm", "SoftmaxXent", "FusedLSTM",
           "FusedLSTMP", "MaskedSoftmax", "MaskedPool", "launch_counts",
           "reset_launch_counts", "take_launches", "add_launches",
           "add_device_launches", "launch_snapshot", "set_while_condition",
           "set_while_condition_plain", "graph_while_begin",
           "graph_while_end",
           "KERNEL_NAMES", "FLASH_HEAD_DIMS",
           "FLASH_DTYPES", "POOL_TYPES"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu",
           "flash_attention_fwd_bf16.cu", "flash_attention_bwd_dkdv_bf16.cu",
           "flash_attention_bwd_dq_bf16.cu", "softmax_xent_fwd.cu",
           "layer_norm_fwd.cu", "fused_lstm_fwd.cu", "fused_lstmp_fwd.cu",
           "masked_softmax_fwd.cu", "masked_pool_fwd.cu", "graph_while.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

FLASH_HEAD_DIMS = (16, 32, 64, 128)
# the element types of q, k, v, g and out the flash kernels take (one per
# call; lse and delta stay fp32), as the TPU kernels take f32 or bf16 tiles
FLASH_DTYPES = (torch.float32, torch.bfloat16)
FLASH_ROWS = 64   # query (K1, K3) or key (K2) rows a block (kRows in the .cu)
_NEG = -1e30  # the masked-score value and empty-row max (TPU kernel's _NEG)
_INT_MAX = 2 ** 31 - 1   # a grid's x dimension

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()
# the kernels a launch is counted under: each wrapper's, then the bf16
# instantiations of K1-K3
KERNEL_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dkdv",
                "flash_attention_bwd_dq", "softmax_xent_fwd",
                "layer_norm_fwd", "fused_lstm", "fused_lstmp",
                "masked_softmax", "masked_pool", "flash_attention_fwd_bf16",
                "flash_attention_bwd_dkdv_bf16", "flash_attention_bwd_dq_bf16",
                "set_while_condition")
_launches = dict.fromkeys(KERNEL_NAMES, 0)
# launches a replayed graph made inside its conditional while bodies:
# {(name, device): a 0-d int64 tensor on that device}, each a running
# total the replays' iteration counters are added into on the device and
# read when the counts are next read
_device_launches = {}


class BuildInfo(object):
    """What the last `build()` did: library path, seconds spent (0.0 when
    the library was already built for these sources) and the compiler's
    output (`ptxas -v` lines when built with verbose=True)."""
    path = None
    seconds = None
    log = ""


build_info = BuildInfo()


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "paddle_tpu_torch build from csrc/ at first use")


def _source_digest(flags):
    h = hashlib.sha256(" ".join(flags).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build(verbose=False):
    """Build (once per source digest) and load the kernel library.

    Each source compiles with its own `nvcc -c`, all started together;
    one `nvcc -shared` links them into `_build/libptt_kernels_<digest>.so`
    (written under a temporary name, then renamed). verbose=True adds
    `-Xptxas -v` and keeps the compiler output in `build_info.log`.
    Returns the ctypes library, with argtypes set on every entry point."""
    global _lib
    with _lib_lock:
        if _lib is not None and not verbose:
            return _lib
        flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
        digest = _source_digest(NVCC_FLAGS)
        path = os.path.join(BUILD_DIR, "libptt_kernels_%s.so" % digest)
        t0 = time.perf_counter()
        log = ""
        if verbose or not os.path.exists(path):
            log = _compile(flags, path)
        lib = ctypes.CDLL(path)
        _bind(lib)
        build_info.path = path
        build_info.seconds = time.perf_counter() - t0
        build_info.log = log
        _lib = lib
        return lib


def _compile(flags, path):
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = "%d.%d" % (os.getpid(), threading.get_ident())
    objs, procs = [], []
    for name in SOURCES:
        obj = os.path.join(BUILD_DIR, "%s.%s.o" % (name, tag))
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *flags, "-c", os.path.join(CSRC_DIR, name), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    failed = []
    for name, p in zip(SOURCES, procs):
        out, _ = p.communicate()
        logs.append("== %s\n%s" % (name, out.decode(errors="replace")))
        if p.returncode != 0:
            failed.append(name)
    try:
        if failed:
            raise RuntimeError("nvcc failed for %s:\n%s"
                               % (", ".join(failed), "\n".join(logs)))
        tmp = "%s.%s.tmp" % (path, tag)
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n%s"
                               % link.stdout.decode(errors="replace"))
        os.replace(tmp, path)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "\n".join(logs)


def _bind(lib):
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    F = ctypes.c_float
    _bind_flash_fwd(lib)
    _bind_flash_bwd(lib)
    _bind_flash_bf16(lib)
    lib.ptt_softmax_xent_fwd.argtypes = [P, P, P, P, I, I, I, P]
    lib.ptt_softmax_xent_fwd.restype = I
    lib.ptt_layer_norm_fwd.argtypes = [P, P, P, P, P, P, I, I, F, I, P]
    lib.ptt_layer_norm_fwd.restype = I
    _bind_lstm(lib)
    _bind_lstmp(lib)
    lib.ptt_masked_softmax_fwd.argtypes = [P, L, P, P, I, I, I, P]
    lib.ptt_masked_softmax_fwd.restype = I
    _bind_pool(lib)
    _bind_graph_while(lib)


def _bind_graph_while(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    U = ctypes.c_ulonglong
    lib.ptt_graph_while_begin.argtypes = [P, P, P, ctypes.POINTER(U)]
    lib.ptt_graph_while_begin.restype = I
    lib.ptt_graph_while_end.argtypes = [P]
    lib.ptt_graph_while_end.restype = I
    lib.ptt_set_while_condition.argtypes = [U, P, P]
    lib.ptt_set_while_condition.restype = I
    lib.ptt_cuda_error_string.argtypes = [I]
    lib.ptt_cuda_error_string.restype = ctypes.c_char_p


def _bind_pool(lib):
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ptt_masked_pool_fwd.argtypes = [P, L, L, P, P] + [I] * 8 + [P]
    lib.ptt_masked_pool_fwd.restype = I
    lib.ptt_masked_pool_blocks_per_sm.argtypes = [I, P]
    lib.ptt_masked_pool_blocks_per_sm.restype = I


def _bind_flash_fwd(lib):
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ptt_flash_attention_fwd.argtypes = (
        [P, P, P, P, P, P, I, I, I, I] + [L] * 9 + [ctypes.c_float, I, P])
    lib.ptt_flash_attention_fwd.restype = I


def _bind_flash_bf16(lib, parts=("fwd", "dkdv", "dq")):
    """The bf16 entries of K1-K3 (the fp32 entries' arguments), bound
    apart from those: a library built from one source alone (chip_smoke.py's
    earlier kernels, flash_bf16_variants.py's variants) binds the `parts`
    it holds."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if "fwd" in parts:
        lib.ptt_flash_attention_fwd_bf16.argtypes = (
            [P, P, P, P, P, P, I, I, I, I] + [L] * 9 + [ctypes.c_float, I, P])
        lib.ptt_flash_attention_fwd_bf16.restype = I
    for part, n_out in (("dkdv", 2), ("dq", 1)):
        if part not in parts:
            continue
        fn = getattr(lib, "ptt_flash_attention_bwd_%s_bf16" % part)
        fn.argtypes = [P] * (7 + n_out) + [I] * 4 + [L] * 12 + \
            [ctypes.c_float, I, P]
        fn.restype = I


def _bind_flash_bwd(lib):
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("ptt_flash_attention_bwd_dkdv", "ptt_flash_attention_bwd_dq"):
        n_out = 2 if name.endswith("dkdv") else 1
        fn = getattr(lib, name)
        fn.argtypes = [P] * (7 + n_out) + [I] * 4 + [L] * 12 + \
            [ctypes.c_float, I, P]
        fn.restype = I


def _bind_lstm(lib):
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ptt_fused_lstm_fwd.argtypes = [P, L, L] + [P] * 7 + [I] * 13 + [P]
    lib.ptt_fused_lstm_fwd.restype = I
    lib.ptt_fused_lstm_max_clusters.argtypes = [I, I, I, I, P]
    lib.ptt_fused_lstm_max_clusters.restype = I


def _bind_lstmp(lib):
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ptt_fused_lstmp_fwd.argtypes = [P, L, L] + [P] * 9 + [I] * 14 + [P]
    lib.ptt_fused_lstmp_fwd.restype = I


def _count(name, dtype=torch.float32):
    """One launch of kernel `name` (its bf16 instantiation's for bf16)."""
    if dtype == torch.bfloat16:
        name += "_bf16"
    with _count_lock:
        _launches[name] += 1


def launch_counts():
    """{kernel name: launches since the last reset}, in KERNEL_NAMES'
    order. Launches made inside a replayed graph's while bodies are added
    from their device totals, read here (one read a kernel and card),
    after the run, never during it."""
    with _count_lock:
        counts = dict(_launches)
        for (name, _), total in _device_launches.items():
            counts[name] += int(total.item())
        return counts


def launch_snapshot():
    """The host counts as they stand, without the device totals (a
    capture in progress must not read the device)."""
    with _count_lock:
        return dict(_launches)


def reset_launch_counts():
    with _count_lock:
        for name in _launches:
            _launches[name] = 0
        _device_launches.clear()


def take_launches(before):
    """The counts added since `before` (a launch_counts() snapshot), taken
    back out: a CUDA graph capture records its kernels and launches none.
    Returns {name: n} of the kernels one replay of the graph launches."""
    with _count_lock:
        took = {}
        for name, n in _launches.items():
            if n != before.get(name, 0):
                took[name] = n - before.get(name, 0)
                _launches[name] = before.get(name, 0)
        return took


def add_launches(counts, times=1):
    """Count `times` launches of each kernel in `counts` ({name: n}, as
    take_launches returns): `times` replays of a captured graph. The
    counts live on the host and do not move when a graph replays."""
    with _count_lock:
        for name, n in counts.items():
            _launches[name] += n * times


def add_device_launches(counts, iterations):
    """Count `iterations` (a 0-d integer tensor on the device, not read
    here) launches of each kernel in `counts`: the body of a conditional
    while node, which ran as many times as the device decided. The
    product is added on the device, in stream order, into one running
    total a kernel and card, so the counter may be reset for the next
    call right after this one."""
    with _count_lock:
        for name, n in counts.items():
            key = (name, iterations.device)
            if key not in _device_launches:
                _device_launches[key] = torch.zeros(
                    (), dtype=torch.int64, device=iterations.device)
            _device_launches[key].add_(iterations, alpha=n)


def _stream_of(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check_launch(err, what):
    if err != 0:
        raise RuntimeError("%s: kernel launch failed with cudaError %d"
                           % (what, err))


def _check_vec_layout(t, what):
    """16-byte loads need 16-byte aligned rows: last dim contiguous,
    other strides multiples of 16 bytes (4 fp32, 8 bf16 elements), a
    16-byte aligned base."""
    per = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % per for s in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        raise ValueError("%s: tensor must have a contiguous last dim, "
                         "strides that are multiples of %d and a 16-byte "
                         "aligned base (got strides %s)"
                         % (what, per, tuple(t.stride())))


def _flash_dtype(what, tensors):
    """The one element type of the named tensors, fp32 or bf16 (the flash
    kernels' instantiations); anything else, or a mix, raises."""
    dtypes = {x.dtype for _, x in tensors}
    if len(dtypes) != 1 or not dtypes <= set(FLASH_DTYPES):
        raise ValueError("%s: the CUDA kernel takes %s all float32 or all "
                         "bfloat16, got %s"
                         % (what, ", ".join(n for n, _ in tensors),
                            ", ".join("%s %s" % (n, x.dtype)
                                      for n, x in tensors)))
    return dtypes.pop()


# ---------------------------------------------------------------------------
# flash attention forward (replaces pallas_kernels._flash_fwd_kernel)
# ---------------------------------------------------------------------------

def flash_attention_fwd_plain(q, k, v, kv_len=None, causal=False,
                              scale=None):
    """Plain version: dense masked softmax over [B, H, T, T] in fp32 (bf16
    inputs are widened first, as the kernel and the TPU kernel do).
    Keys at or past kv_len[b] (and, causal, past the query) are masked; a
    row with no valid key gives out = 0 and lse = -1e30 + log(1e-30), the
    TPU kernel's `l_safe` convention. Returns (out [B, T, H, D] in q's
    dtype, lse [B, H, T] fp32)."""
    b, t, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = q.float() * scale
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    kpos = torch.arange(t, device=q.device)
    valid = torch.ones((1, 1, t, t), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        lens = kv_len.reshape(b, 1).to(device=q.device, dtype=torch.int64)
        valid = valid & (kpos[None, :] < lens)[:, None, None, :]
    if causal:
        valid = valid & (kpos[None, :] <= kpos[:, None])[None, None]
    s = torch.where(valid, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) \
        / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out.to(q.dtype), lse


def flash_attention_fwd(q, k, v, kv_len=None, causal=False, scale=None):
    """Exact attention over q, k, v [B, T, H, D] (equal q and k lengths),
    keys masked at or past kv_len ([B] or [B, 1] int; None = all T) and,
    causal, past each query. Returns (out [B, T, H, D], lse [B, H, T] fp32).

    q, k, v are all fp32 or all bf16 (anything else raises, on every
    device); out comes back in their dtype. Dispatch by q's device: meta
    -> empty outputs, cpu -> the plain version, cuda -> the kernel (D in
    FLASH_HEAD_DIMS; anything else raises)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention_fwd needs q, k, v of one shape "
                         "[B, T, H, D], got %s %s %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    b, t, h, d = q.shape
    if kv_len is not None:
        if kv_len.numel() != b:
            raise ValueError("kv_len must hold one length per batch row "
                             "(%d), got shape %s" % (b, tuple(kv_len.shape)))
        kv_len = kv_len.reshape(b)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dtype = _flash_dtype("flash_attention_fwd", (("q", q), ("k", k),
                                                  ("v", v)))
    dev = q.device.type
    if dev == "meta":
        return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
                torch.empty((b, h, t), dtype=torch.float32, device=q.device))
    if dev == "cpu":
        return flash_attention_fwd_plain(q, k, v, kv_len, causal, scale)
    if dev != "cuda":
        raise ValueError("flash_attention_fwd: unsupported device %s" % dev)
    if d not in FLASH_HEAD_DIMS:
        raise ValueError("flash_attention_fwd: head dim %d not in %s"
                         % (d, FLASH_HEAD_DIMS))
    flash_grid(b, h, t, "flash_attention_fwd")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError("flash_attention_fwd: %s on %s, q on %s"
                             % (name, x.device, q.device))
        _check_vec_layout(x, "flash_attention_fwd %s" % name)
    out = torch.empty((b, t, h, d), dtype=dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if t == 0 or b * h == 0:
        return out, lse
    lens = None
    if kv_len is not None:
        lens = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    lib = build()
    fn = lib.ptt_flash_attention_fwd if dtype == torch.float32 \
        else lib.ptt_flash_attention_fwd_bf16
    err = _fwd_call(fn, q, k, v, lens, out, lse, scale, causal)
    _check_launch(err, "flash_attention_fwd")
    _count("flash_attention_fwd", dtype)
    return out, lse


def flash_grid(b, h, t, what="flash attention"):
    """The grid of K1, K2 and K3: (B * H, ceil(T / FLASH_ROWS)). grid.x
    takes B * H up to 2^31 - 1 (the kernels index it with 64-bit
    offsets), grid.y the row tiles up to 65535 (T up to 4194240). Raises
    ValueError beyond either."""
    tiles = -(-t // FLASH_ROWS)
    if b * h > _INT_MAX or tiles > 65535:
        raise ValueError("%s: B*H = %d and %d row tiles of T = %d exceed "
                         "the grid limits %d and 65535"
                         % (what, b * h, tiles, t, _INT_MAX))
    return b * h, tiles


def _fwd_call(fn, q, k, v, lens, out, lse, scale, causal):
    b, t, h, d = q.shape
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
              lens.data_ptr() if lens is not None else None,
              out.data_ptr(), lse.data_ptr(), b, t, h, d,
              *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
              float(scale), int(bool(causal)), _stream_of(q))


# ---------------------------------------------------------------------------
# layer norm forward (replaces pallas_kernels._ln_kernel)
# ---------------------------------------------------------------------------

def layer_norm_fwd_plain(x, scale, bias, eps=1e-5):
    """Plain version: fp32 row statistics of x [N, D]. Returns (y [N, D]
    in x's dtype, mean [N] fp32, var [N] fp32 — the biased variance)."""
    xf = x.float()
    mean = xf.mean(dim=-1)
    xc = xf - mean[:, None]
    var = (xc * xc).mean(dim=-1)
    y = xc * torch.rsqrt(var[:, None] + eps) * scale.float() + bias.float()
    return y.to(x.dtype), mean, var


def layer_norm_fwd(x, scale, bias, eps=1e-5):
    """Layer norm over the last dim of x [N, D] with scale, bias [D].
    Returns (y [N, D], mean [N], var [N]); dispatch by x's device as in
    flash_attention_fwd (the CUDA kernel takes fp32, any D)."""
    if x.dim() != 2 or scale.shape != (x.shape[1],) \
            or bias.shape != (x.shape[1],):
        raise ValueError("layer_norm_fwd needs x [N, D], scale and bias [D]; "
                         "got %s %s %s" % (tuple(x.shape), tuple(scale.shape),
                                           tuple(bias.shape)))
    n, d = x.shape
    dev = x.device.type
    if dev == "meta":
        return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
                torch.empty((n,), dtype=torch.float32, device=x.device),
                torch.empty((n,), dtype=torch.float32, device=x.device))
    if dev == "cpu":
        return layer_norm_fwd_plain(x, scale, bias, eps)
    if dev != "cuda":
        raise ValueError("layer_norm_fwd: unsupported device %s" % dev)
    for name, t in (("x", x), ("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32:
            raise ValueError("layer_norm_fwd: the CUDA kernel takes fp32 "
                             "(%s is %s)" % (name, t.dtype))
        if t.device != x.device:
            raise ValueError("layer_norm_fwd: %s on %s, x on %s"
                             % (name, t.device, x.device))
    x = x.contiguous()
    scale = scale.contiguous()
    bias = bias.contiguous()
    y = torch.empty_like(x)
    mean = torch.empty((n,), dtype=torch.float32, device=x.device)
    var = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return y, mean, var
    vec4 = d % 4 == 0 and all(t.data_ptr() % 16 == 0
                              for t in (x, scale, bias, y))
    lib = build()
    err = lib.ptt_layer_norm_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), var.data_ptr(), n, d, float(eps), int(vec4),
        _stream_of(x))
    _check_launch(err, "layer_norm_fwd")
    _count("layer_norm_fwd")
    return y, mean, var


# ---------------------------------------------------------------------------
# flash attention backward (replaces pallas_kernels._flash_bwd_dkdv_kernel
# and _flash_bwd_dq_kernel, launched by _flash_bwd)
# ---------------------------------------------------------------------------

def _valid_pairs(b, t, q_device, kv_len, causal):
    """[B, 1, T, T] bool: key at or past kv_len[b] masked, and, causal,
    keys past the query."""
    kpos = torch.arange(t, device=q_device)
    valid = torch.ones((1, 1, t, t), dtype=torch.bool, device=q_device)
    if kv_len is not None:
        lens = kv_len.reshape(b, 1).to(device=q_device, dtype=torch.int64)
        valid = valid & (kpos[None, :] < lens)[:, None, None, :]
    if causal:
        valid = valid & (kpos[None, :] <= kpos[:, None])[None, None]
    return valid


def flash_attention_bwd_plain(q, k, v, lse, delta, g, kv_len=None,
                              causal=False, scale=None):
    """Plain version: the vjp of flash_attention_fwd_plain written out over
    the dense [B, H, T, T] recompute, from the saved lse [B, H, T] and
    delta = rowsum(g * out) [B, H, T], as the TPU kernels compute it:
    p = exp(q.k * scale - lse) on valid pairs (masked before the
    exponential, so an empty row gives 0), dS = p * (g.v - delta) * scale,
    every product in fp32 (bf16 inputs widened first). Returns (dq, dk,
    dv), each [B, T, H, D] in q's dtype."""
    b, t, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    valid = _valid_pairs(b, t, q.device, kv_len, causal)
    p = torch.where(valid, torch.exp(torch.where(valid, s - lse[..., None],
                                                 torch.zeros_like(s))),
                    torch.zeros_like(s))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _flash_bwd_args(what, q, k, v, lse, delta, g, kv_len):
    """Checks for the backward kernels; returns (B, T, H, D, int32 lens or
    None, lse and delta contiguous)."""
    if q.dim() != 4 or any(x.shape != q.shape for x in (k, v, g)):
        raise ValueError("%s needs q, k, v, g of one shape [B, T, H, D], got "
                         "%s" % (what, [tuple(x.shape) for x in (q, k, v, g)]))
    b, t, h, d = q.shape
    if lse.shape != (b, h, t) or delta.shape != (b, h, t):
        raise ValueError("%s needs lse and delta [B, H, T] = %s, got %s %s"
                         % (what, (b, h, t), tuple(lse.shape),
                            tuple(delta.shape)))
    for name, x in (("q", q), ("k", k), ("v", v), ("g", g), ("lse", lse),
                    ("delta", delta)):
        if name in ("lse", "delta") and x.dtype != torch.float32:
            raise ValueError("%s: the CUDA kernel takes %s in fp32 (got %s)"
                             % (what, name, x.dtype))
        if x.device != q.device:
            raise ValueError("%s: %s on %s, q on %s"
                             % (what, name, x.device, q.device))
    if d not in FLASH_HEAD_DIMS:
        raise ValueError("%s: head dim %d not in %s"
                         % (what, d, FLASH_HEAD_DIMS))
    flash_grid(b, h, t, what)
    for name, x in (("q", q), ("k", k), ("v", v), ("g", g)):
        _check_vec_layout(x, "%s %s" % (what, name))
    lens = None
    if kv_len is not None:
        if kv_len.numel() != b:
            raise ValueError("kv_len must hold one length per batch row "
                             "(%d), got shape %s" % (b, tuple(kv_len.shape)))
        lens = kv_len.reshape(b).to(device=q.device,
                                    dtype=torch.int32).contiguous()
    return b, t, h, d, lens, lse.contiguous(), delta.contiguous()


def _bwd_call(fn, q, k, v, g, lse, delta, lens, outs, b, t, h, d, scale,
              causal):
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             lse.data_ptr(), delta.data_ptr(),
             lens.data_ptr() if lens is not None else None,
             *[o.data_ptr() for o in outs], b, t, h, d,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *g.stride()[:3], float(scale), int(bool(causal)), _stream_of(q))
    return err


def flash_attention_bwd_dkdv(q, k, v, lse, delta, g, kv_len=None,
                             causal=False, scale=None):
    """dK, dV [B, T, H, D] of flash attention from the saved lse and delta
    [B, H, T] (fp32) and the output gradient g [B, T, H, D] (kernel K2).
    Dispatch by q's device as in flash_attention_fwd: q, k, v, g all fp32
    or all bf16 (else it raises, on every device), dK and dV in their
    dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _flash_dtype("flash_attention_bwd_dkdv",
                 (("q", q), ("k", k), ("v", v), ("g", g)))
    dev = q.device.type
    if dev == "meta":
        return torch.empty_like(k), torch.empty_like(v)
    if dev == "cpu":
        return flash_attention_bwd_plain(q, k, v, lse, delta, g, kv_len,
                                         causal, scale)[1:]
    if dev != "cuda":
        raise ValueError("flash_attention_bwd_dkdv: unsupported device %s"
                         % dev)
    b, t, h, d, lens, lse, delta = _flash_bwd_args(
        "flash_attention_bwd_dkdv", q, k, v, lse, delta, g, kv_len)
    dk = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if t == 0 or b * h == 0:
        return dk, dv
    lib = build()
    fn = lib.ptt_flash_attention_bwd_dkdv if q.dtype == torch.float32 \
        else lib.ptt_flash_attention_bwd_dkdv_bf16
    err = _bwd_call(fn, q, k, v, g, lse, delta, lens, (dk, dv), b, t, h, d,
                    scale, causal)
    _check_launch(err, "flash_attention_bwd_dkdv")
    _count("flash_attention_bwd_dkdv", q.dtype)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, lse, delta, g, kv_len=None,
                           causal=False, scale=None):
    """dQ [B, T, H, D] of flash attention, from the same inputs as
    flash_attention_bwd_dkdv (kernel K3)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _flash_dtype("flash_attention_bwd_dq",
                 (("q", q), ("k", k), ("v", v), ("g", g)))
    dev = q.device.type
    if dev == "meta":
        return torch.empty_like(q)
    if dev == "cpu":
        return flash_attention_bwd_plain(q, k, v, lse, delta, g, kv_len,
                                         causal, scale)[0]
    if dev != "cuda":
        raise ValueError("flash_attention_bwd_dq: unsupported device %s" % dev)
    b, t, h, d, lens, lse, delta = _flash_bwd_args(
        "flash_attention_bwd_dq", q, k, v, lse, delta, g, kv_len)
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    if t == 0 or b * h == 0:
        return dq
    lib = build()
    fn = lib.ptt_flash_attention_bwd_dq if q.dtype == torch.float32 \
        else lib.ptt_flash_attention_bwd_dq_bf16
    err = _bwd_call(fn, q, k, v, g, lse, delta, lens, (dq,), b, t, h, d,
                    scale, causal)
    _check_launch(err, "flash_attention_bwd_dq")
    _count("flash_attention_bwd_dq", q.dtype)
    return dq


def flash_delta(g, out):
    """delta = rowsum(g * out) as [B, H, T], summed in fp32 from bf16 or
    fp32 g and out (the TPU path computes it outside its kernels too)."""
    return (g.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd(q, k, v, out, lse, g, kv_len=None, causal=False,
                        scale=None):
    """(dq, dk, dv) of flash attention: delta from g and the forward's out,
    then K2 (dK, dV) and K3 (dQ) on the card; on the CPU one plain dense
    recompute gives all three."""
    _flash_dtype("flash_attention_bwd",
                 (("q", q), ("k", k), ("v", v), ("g", g), ("out", out)))
    delta = flash_delta(g, out)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, lse, delta, g, kv_len,
                                         causal, scale)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, lse, delta, g, kv_len, causal,
                                      scale)
    dq = flash_attention_bwd_dq(q, k, v, lse, delta, g, kv_len, causal, scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# softmax cross-entropy forward (replaces pallas_kernels._xent_kernel)
# ---------------------------------------------------------------------------

def hard_label_index(label, num_classes):
    """The class a hard label picks, the JAX package's CPU rule (numpy-
    style indexing under JAX's clamping gather): a negative label wraps
    once (-1 -> V - 1), then anything still outside [0, V) is clamped
    (V + k -> V - 1, -V - k -> 0). K4 (forward and backward), its plain
    version and the cross_entropy rules all take it."""
    lab = label.long()
    return torch.where(lab < 0, lab + num_classes, lab).clamp(
        0, num_classes - 1)


def softmax_xent_fwd_plain(logits, labels):
    """Plain version: (loss [N, 1], lse [N, 1]) in fp32, with
    loss = lse - logits[hard_label_index(label)]."""
    x = logits.float()
    n, v = x.shape
    lse = torch.logsumexp(x, dim=-1, keepdim=True)
    lab = hard_label_index(labels.reshape(n, 1), v)
    return lse - x.gather(1, lab), lse


def softmax_xent_fwd(logits, labels):
    """Row log-sum-exp and hard-label cross-entropy of logits [N, V] with
    int labels [N] (or [N, 1]): returns (loss [N, 1], lse [N, 1]) fp32.
    Dispatch by the logits' device as in flash_attention_fwd (the CUDA
    kernel takes fp32 logits)."""
    if logits.dim() != 2 or labels.numel() != logits.shape[0]:
        raise ValueError("softmax_xent_fwd needs logits [N, V] and N labels, "
                         "got %s and %s" % (tuple(logits.shape),
                                            tuple(labels.shape)))
    n, v = logits.shape
    dev = logits.device.type
    if dev == "meta":
        return (torch.empty((n, 1), dtype=torch.float32, device=logits.device),
                torch.empty((n, 1), dtype=torch.float32, device=logits.device))
    if dev == "cpu":
        return softmax_xent_fwd_plain(logits, labels)
    if dev != "cuda":
        raise ValueError("softmax_xent_fwd: unsupported device %s" % dev)
    if logits.dtype != torch.float32:
        raise ValueError("softmax_xent_fwd: the CUDA kernel takes fp32 logits "
                         "(got %s)" % logits.dtype)
    if labels.device != logits.device or labels.is_floating_point():
        raise ValueError("softmax_xent_fwd: labels must be an int tensor on "
                         "%s (got %s on %s)" % (logits.device, labels.dtype,
                                                labels.device))
    x = logits.contiguous()
    lab = labels.reshape(n).to(torch.int64).contiguous()
    loss = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    lse = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    if n == 0:
        return loss, lse
    if v == 0 or n > 2 ** 31 - 1:
        raise ValueError("softmax_xent_fwd: needs 0 < V and N < 2^31, got "
                         "[%d, %d]" % (n, v))
    vec4 = v % 4 == 0 and x.data_ptr() % 16 == 0
    lib = build()
    err = lib.ptt_softmax_xent_fwd(x.data_ptr(), lab.data_ptr(),
                                   loss.data_ptr(), lse.data_ptr(), n, v,
                                   int(vec4), _stream_of(x))
    _check_launch(err, "softmax_xent_fwd")
    _count("softmax_xent_fwd")
    return loss, lse


# ---------------------------------------------------------------------------
# fused LSTM recurrence forward (replaces pallas_kernels._lstm_seq_kernel)
# ---------------------------------------------------------------------------

def step_mask(lens, b, t, device, dtype=torch.float32):
    """[B, T] in `dtype`: 1 where step t < lens[b] (every step when lens is
    None), else 0."""
    if lens is None:
        return torch.ones((b, t), dtype=dtype, device=device)
    steps = torch.arange(t, device=device)
    return (steps[None, :] < lens.reshape(-1, 1).to(
        device=device, dtype=torch.int64)).to(dtype)


def _lstm_args(x, w, b, h0, c0, lens):
    if x.dim() != 3 or x.shape[2] % 4:
        raise ValueError("fused_lstm needs x [B, T, 4D], got %s"
                         % (tuple(x.shape),))
    bsz, t, four_d = x.shape
    d = four_d // 4
    if w.shape != (d, four_d) or b.numel() != four_d:
        raise ValueError("fused_lstm needs w [D, 4D] = %s and b [4D]; got "
                         "%s %s" % ((d, four_d), tuple(w.shape),
                                    tuple(b.shape)))
    for name, s in (("h0", h0), ("c0", c0)):
        if s is not None and s.shape != (bsz, d):
            raise ValueError("fused_lstm %s must be [B, D] = %s, got %s"
                             % (name, (bsz, d), tuple(s.shape)))
    if lens is not None and lens.numel() != bsz:
        raise ValueError("fused_lstm lens must hold one length per batch "
                         "row (%d), got shape %s" % (bsz, tuple(lens.shape)))
    return bsz, t, d


def _cell_step(gates, c, peepholes, gate_act, cell_act, cand_act):
    """One step of the LSTM cell (lstm_op.h) from its gate pre-activations
    [B, 4D] in the order {candidate, input, forget, output} and c_prev
    [B, D]; peepholes [3, D] (w_ic, w_fc, w_oc) or None. Returns (c_new,
    h_new)."""
    gc, gi, gf, go = gates.chunk(4, dim=-1)
    if peepholes is not None:
        w_ic, w_fc, w_oc = peepholes
        gi = gi + c * w_ic
        gf = gf + c * w_fc
    c_new = gate_act(gf) * c + gate_act(gi) * cand_act(gc)
    if peepholes is not None:
        go = go + c_new * w_oc
    return c_new, gate_act(go) * cell_act(c_new)


def fused_lstm_plain(x, w, b, h0=None, c0=None, lens=None, reverse=False,
                     peepholes=None, acts=(torch.sigmoid, torch.tanh,
                                           torch.tanh),
                     dtype=torch.float32):
    """Plain version: the masked recurrence as a torch loop over T (the
    JAX package's lax.scan step). Gate order {candidate, input, forget,
    output}; a step at or past lens[b] carries (h, c) unchanged; reverse
    walks t from T-1 down. Returns (hidden, cell) [B, T, D] in `dtype`.

    The lstm rule also runs it for what K6 does not cover: peepholes
    [3D] (w_ic, w_fc, w_oc, added as lstm_op.h adds them), other
    (gate, cell, candidate) activations and another state dtype."""
    bsz, t, d = _lstm_args(x, w, b, h0, c0, lens)
    xf, wf, bf = x.to(dtype), w.to(dtype), b.reshape(-1).to(dtype)
    h = torch.zeros((bsz, d), dtype=dtype, device=x.device) \
        if h0 is None else h0.to(dtype)
    c = torch.zeros_like(h) if c0 is None else c0.to(dtype)
    if peepholes is not None:
        peepholes = peepholes.reshape(3, d).to(dtype)
    m = step_mask(lens, bsz, t, x.device, dtype)
    hidden = torch.empty((bsz, t, d), dtype=dtype, device=x.device)
    cell = torch.empty_like(hidden)
    for k in range(t):
        s = t - 1 - k if reverse else k
        c_new, h_new = _cell_step(xf[:, s] + h @ wf + bf, c, peepholes,
                                  *acts)
        ms = m[:, s:s + 1]
        h = ms * h_new + (1 - ms) * h
        c = ms * c_new + (1 - ms) * c
        hidden[:, s] = h
        cell[:, s] = c
    return hidden, cell


def fused_lstm(x, w, b, h0=None, c0=None, lens=None, reverse=False):
    """The whole masked LSTM recurrence over x [B, T, 4D] (the
    pre-projected gate inputs; any batch and time strides, last dim
    contiguous on the card), recurrent weight w [D, 4D], gate bias b [4D],
    optional h0, c0 [B, D] (zeros when None) and lengths lens [B] (every
    step when None). Returns (hidden, cell) [B, T, D] fp32.

    Dispatch by x's device: meta -> empty outputs, cpu -> the plain
    version, cuda -> the kernel (fp32 only; anything else raises): one
    launch of thread-block clusters as lstm_plan_on_card lays it out for
    this card; a refused plan or launch raises."""
    bsz, t, d = _lstm_args(x, w, b, h0, c0, lens)
    dev = x.device.type
    if dev == "meta":
        return (torch.empty((bsz, t, d), dtype=torch.float32,
                            device=x.device),
                torch.empty((bsz, t, d), dtype=torch.float32,
                            device=x.device))
    if dev == "cpu":
        return fused_lstm_plain(x, w, b, h0, c0, lens, reverse)
    if dev != "cuda":
        raise ValueError("fused_lstm: unsupported device %s" % dev)
    for name, a in (("x", x), ("w", w), ("b", b), ("h0", h0), ("c0", c0)):
        if a is None:
            continue
        if a.dtype != torch.float32:
            raise ValueError("fused_lstm: the CUDA kernel takes fp32 (%s is "
                             "%s)" % (name, a.dtype))
        if a.device != x.device:
            raise ValueError("fused_lstm: %s on %s, x on %s"
                             % (name, a.device, x.device))
    if x.stride(2) != 1:
        raise ValueError("fused_lstm: x needs a contiguous last dim (got "
                         "strides %s)" % (tuple(x.stride()),))
    w = w.contiguous()
    b = b.reshape(-1).contiguous()
    h0 = h0.contiguous() if h0 is not None else None
    c0 = c0.contiguous() if c0 is not None else None
    hidden = torch.empty((bsz, t, d), dtype=torch.float32, device=x.device)
    cell = torch.empty_like(hidden)
    if bsz == 0 or t == 0 or d == 0:
        return hidden, cell
    if lens is not None:
        lens = lens.reshape(bsz).to(device=x.device,
                                    dtype=torch.int32).contiguous()
    lib = build()
    _launch_lstm(lib, lstm_plan_on_card(lib, bsz, d, x.device), x, w, b, h0,
                 c0, lens, reverse, hidden, cell)
    _count("fused_lstm")
    return hidden, cell


LSTM_THREADS = 256        # threads per block of K6 (kThreads in the .cu)
LSTM_MAX_CLUSTER = 16     # blocks a cluster (above 8: non-portable)
LSTM_MIN_SLICE = 8        # the fewest terms of D a thread's tile sums
# what one more block of a cluster costs a step (its exchange and the
# wider barrier), in (padded rows x units) of a block's work: fitted to
# k6_ablation.py's sweep of cluster sizes and rows on an H100
LSTM_BLOCK_COST = 8


def _lstm_smem_floats(d, rows, ku, rp, ks, resident, prefetch):
    """Shared memory K6 needs, in 4-byte words: its layout in
    csrc/fused_lstm_fwd.cu (smem_floats) region by region: the W slice [D,
    4 ku] (resident only), h [2, D, rp], the partial sums [ks, rp, 4 ku],
    x [2, rows, 4 ku] (prefetch only), the bias [4 ku], c [rows, ku], the
    lengths."""
    return ((4 * d * ku if resident else 0) + 2 * d * rp + 4 * ks * rp * ku
            + (8 * rows * ku if prefetch else 0) + 4 * ku
            + _round_up(rows * ku, 4) + _round_up(rows, 4))


def lstm_launch_plan(bsz, d, sm_count, active=None, cs=None, rows=None):
    """K6's launch plan for B rows and D hidden units on a card with
    `sm_count` SMs: a dict with
      cs        -- blocks a thread-block cluster (1-16, at most D);
      rows      -- R, the batch rows a cluster owns ([q R, q R + R));
      clusters  -- ceil(B / R); grid -- clusters * cs blocks;
      units     -- block j's hidden units [j D / cs, (j + 1) D / cs);
      ku        -- the most units any block owns (ceil(D / cs));
      rg, rp    -- the rows of a thread's tile (4 or 8) and R rounded up
                   to it;
      ks        -- the slices of D the gate product is split into;
      resident  -- the W slices stay in shared memory for the launch
                   (False: read from L2 at every step);
      prefetch  -- the next step's x columns are copied into shared memory
                   during a step (False: the cell update reads them from
                   global memory);
      smem      -- dynamic shared memory bytes; threads -- a block's;
      waves     -- ceil(clusters / the clusters the card runs at once).
    `active(cs, rg, resident, smem)` says how many clusters the card runs
    at once (cudaOccupancyMaxActiveClusters on the card, 0 for a size it
    refuses); without it, sm_count // cs. The plan has the fewest waves,
    then a resident W, then the least cost a step, (padded rows x units)
    of a block's work plus LSTM_BLOCK_COST for each block of the cluster,
    then the fewest real (rows x units), then the smallest cluster. cs and
    rows pin those choices (the ablation's variants). Raises
    ValueError on sizes that are not positive or when no plan fits."""
    if bsz <= 0 or d <= 0 or sm_count <= 0:
        raise ValueError("lstm_launch_plan needs positive B, D and SM count, "
                         "got %r" % ((bsz, d, sm_count),))
    limit = LSTMP_SMEM_LIMIT
    sizes = [c for c in (1, 2, 4, 8, 16) if c <= min(LSTM_MAX_CLUSTER, d)] \
        if cs is None else [int(cs)]
    if rows is None:
        row_opts = sorted({-(-bsz // n) for n in range(1, bsz + 1)})
    else:
        row_opts = [min(int(rows), bsz)]
    best = None
    for c in sizes:
        if c < 1 or c > d:
            raise ValueError("lstm_launch_plan: a cluster of %d blocks at "
                             "D = %d" % (c, d))
        ku = -(-d // c)
        for r in row_opts:
            rg = 4 if r <= 4 else 8
            rp = _round_up(r, rg)
            # the slices of D: as many as the threads left over by the
            # (row group, unit) tiles allow, each LSTM_MIN_SLICE terms or
            # more
            k = min(max(1, LSTM_THREADS // (rp // rg * ku)),
                    max(1, d // LSTM_MIN_SLICE))
            for resident, prefetch in ((True, True), (True, False),
                                       (False, True), (False, False)):
                while 4 * _lstm_smem_floats(d, r, ku, rp, k, resident,
                                            prefetch) > limit and k > 1:
                    k = -(-k // 2)
                smem = 4 * _lstm_smem_floats(d, r, ku, rp, k, resident,
                                             prefetch)
                if smem <= limit:
                    break
            else:
                continue
            clusters = -(-bsz // r)
            at_once = sm_count // c if active is None else \
                active(c, rg, resident, smem)
            if at_once < 1:
                continue
            waves = -(-clusters // at_once)
            key = (waves, not resident, rp * ku + LSTM_BLOCK_COST * c,
                   r * ku, c)
            if best is None or key < best[0]:
                best = (key, {
                    "cs": c, "rows": r, "clusters": clusters,
                    "grid": clusters * c, "ku": ku,
                    "units": [(j * d // c, (j + 1) * d // c)
                              for j in range(c)],
                    "rg": rg, "rp": rp, "ks": k, "resident": resident,
                    "prefetch": prefetch, "smem": smem,
                    "threads": LSTM_THREADS, "waves": waves})
    if best is None:
        raise ValueError("fused_lstm: no cluster plan fits B = %d, D = %d "
                         "(shared memory %d bytes a block)"
                         % (bsz, d, limit))
    return best[1]


_lstm_plans = {}


def lstm_plan_on_card(lib, bsz, d, device):
    """lstm_launch_plan for this card, the clusters it runs at once from
    cudaOccupancyMaxActiveClusters at the plan's own shared memory (cached
    per shape and device). Raises when the card runs no cluster of the
    plan."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (bsz, d, index)
    plan = _lstm_plans.get(key)
    if plan is not None:
        return plan
    counts = {}

    def active(cs, rg, resident, smem):
        arg = (cs, rg, int(resident), smem)
        if arg not in counts:
            n = ctypes.c_int(0)
            with torch.cuda.device(index):
                err = lib.ptt_fused_lstm_max_clusters(*arg, ctypes.byref(n))
            if err != 0 and cs <= 8:
                _check_launch(err, "fused_lstm occupancy query")
            counts[arg] = n.value if err == 0 else 0
        return counts[arg]

    plan = lstm_launch_plan(
        bsz, d, torch.cuda.get_device_properties(index).multi_processor_count,
        active=active)
    if active(plan["cs"], plan["rg"], plan["resident"], plan["smem"]) < 1:
        raise RuntimeError("fused_lstm: the card runs no cluster of %d blocks "
                           "with %d bytes of shared memory"
                           % (plan["cs"], plan["smem"]))
    _lstm_plans[key] = plan
    return plan


def _launch_lstm(lib, plan, x, w, b, h0, c0, lens, reverse, hidden=None,
                 cell=None):
    """One launch of K6 from `lib` with `plan`, on checked CUDA tensors
    (w, b, h0, c0 contiguous; lens int32 or None). Allocates the outputs
    when not given; raises when the launch is refused. Returns (hidden,
    cell)."""
    bsz, t, four_d = x.shape
    d = four_d // 4
    if hidden is None:
        hidden = torch.empty((bsz, t, d), dtype=torch.float32,
                             device=x.device)
        cell = torch.empty_like(hidden)
    err = lib.ptt_fused_lstm_fwd(
        x.data_ptr(), x.stride(0), x.stride(1), w.data_ptr(), b.data_ptr(),
        h0.data_ptr() if h0 is not None else None,
        c0.data_ptr() if c0 is not None else None,
        lens.data_ptr() if lens is not None else None,
        hidden.data_ptr(), cell.data_ptr(), bsz, t, d, int(bool(reverse)),
        plan["cs"], plan["rows"], plan["ku"], plan["rg"], plan["ks"],
        int(plan["prefetch"]), plan["smem"], int(plan["resident"]),
        plan["threads"], _stream_of(x))
    _check_launch(err, "fused_lstm")
    return hidden, cell


def _walk(a, reverse):
    """[B, T, ...] -> [T, B, ...] fp32, in the order the recurrence walks
    the steps."""
    a = a.float().transpose(0, 1)
    return a.flip(0) if reverse else a


def _entering(first, walked):
    """The state entering each step, [T, B, ...]: `first` (or zeros when
    None), then every step's output but the last."""
    if first is None:
        first = torch.zeros_like(walked[0])
    return torch.cat([first.float()[None], walked[:-1]], dim=0)


def _cell_terms(xs, s_prev, c_prev, w, b):
    """The LSTM cell of every step at once, from its gate inputs xs [T, B,
    4D], the saved recurrent state s_prev [T, B, K] entering each step (h
    for the LSTM, the projection r for the LSTMP), c_prev [T, B, D], w [K,
    4D] and b [4D]. Returns (f, h_new, p, q_c, q_o), the factors of the
    chain rule that do not depend on the carried gradients: dc_new = dc *
    m + dh_new * p, dg = [dc_new * q_c, dh_new * q_o] (gate order
    candidate, input, forget, output)."""
    t, bsz, four_d = xs.shape
    d = four_d // 4
    gates = xs + (s_prev.reshape(t * bsz, -1) @ w.float()).reshape(
        t, bsz, four_d) + b.reshape(-1).float()
    z = torch.tanh(gates[..., :d])
    i = torch.sigmoid(gates[..., d:2 * d])
    f = torch.sigmoid(gates[..., 2 * d:3 * d]).contiguous()
    o = torch.sigmoid(gates[..., 3 * d:])
    tc = torch.tanh(f * c_prev + i * z)
    q_c = torch.stack([i * (1 - z * z), z * i * (1 - i),
                       c_prev * f * (1 - f)], dim=2)           # [T, B, 3, D]
    return f, o * tc, o * (1 - tc * tc), q_c, tc * o * (1 - o)


def fused_lstm_bwd(x, w, b, h0, c0, lens, hidden, cell, g_hidden, g_cell,
                   reverse=False):
    """Gradients (dx, dw, db, dh0, dc0) of fused_lstm from its SAVED states
    (parity: pallas_kernels._lstm_seq_core_bwd): no forward is run again.
    The gates of every step are re-derived at once from the saved
    (h_prev, c_prev) with one matrix product, and so are the gate
    derivatives that do not depend on the carried gradients; the loop
    then walks the steps in reverse processing order carrying (dh, dc),
    and dw, db come from one product and one sum over all steps. Works on
    any device (torch code, as in the JAX package)."""
    bsz, t, d = _lstm_args(x, w, b, h0, c0, lens)
    dev = x.device
    h_prev = _entering(h0, _walk(hidden, reverse))             # [T, B, D]
    c_prev = _entering(c0, _walk(cell, reverse))
    f, _, p, q_c, q_o = _cell_terms(_walk(x, reverse), h_prev, c_prev, w, b)
    m = _walk(step_mask(lens, bsz, t, dev)[..., None], reverse)
    one_m = 1 - m
    zeros = torch.zeros((t, bsz, d), dtype=torch.float32, device=dev)
    gh = zeros if g_hidden is None else _walk(g_hidden, reverse)
    gc = zeros if g_cell is None else _walk(g_cell, reverse)
    dg = torch.empty((t, bsz, 4, d), dtype=torch.float32, device=dev)
    wt = w.float().t().contiguous()
    dh_c = torch.zeros((bsz, d), dtype=torch.float32, device=dev)
    dc_c = torch.zeros_like(dh_c)
    for k in range(t - 1, -1, -1):
        dh = dh_c + gh[k]
        dc = dc_c + gc[k]
        dh_new = dh * m[k]
        dc_new = torch.addcmul(dc * m[k], dh_new, p[k])
        torch.mul(dc_new[:, None], q_c[k], out=dg[k, :, :3])
        torch.mul(dh_new, q_o[k], out=dg[k, :, 3])
        dh_c = torch.addmm(dh * one_m[k], dg[k].reshape(bsz, 4 * d), wt)
        dc_c = torch.addcmul(dc * one_m[k], dc_new, f[k])
    dg = dg.reshape(t, bsz, 4 * d)
    dw = h_prev.reshape(t * bsz, d).t() @ dg.reshape(t * bsz, 4 * d)
    db = dg.sum(dim=(0, 1))
    dx = (dg.flip(0) if reverse else dg).transpose(0, 1)
    return (dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype).reshape(b.shape),
            dh_c, dc_c)


# ---------------------------------------------------------------------------
# fused LSTMP recurrence forward (replaces pallas_kernels._lstmp_seq_kernel)
# ---------------------------------------------------------------------------

def _lstmp_args(x, w, w_proj, b, r0, c0, lens):
    if x.dim() != 3 or x.shape[2] % 4:
        raise ValueError("fused_lstmp needs x [B, T, 4D], got %s"
                         % (tuple(x.shape),))
    bsz, t, four_d = x.shape
    d = four_d // 4
    if w_proj.dim() != 2 or w_proj.shape[0] != d:
        raise ValueError("fused_lstmp needs w_proj [D, P] with D = %d, got %s"
                         % (d, tuple(w_proj.shape)))
    p = w_proj.shape[1]
    if w.shape != (p, four_d) or b.numel() != four_d:
        raise ValueError("fused_lstmp needs w [P, 4D] = %s and b [4D]; got "
                         "%s %s" % ((p, four_d), tuple(w.shape),
                                    tuple(b.shape)))
    for name, s, width in (("r0", r0, p), ("c0", c0, d)):
        if s is not None and s.shape != (bsz, width):
            raise ValueError("fused_lstmp %s must be %s, got %s"
                             % (name, (bsz, width), tuple(s.shape)))
    if lens is not None and lens.numel() != bsz:
        raise ValueError("fused_lstmp lens must hold one length per batch "
                         "row (%d), got shape %s" % (bsz, tuple(lens.shape)))
    return bsz, t, d, p


LSTMP_THREADS = 256        # threads per block of K7 (kThreads in the .cu)
LSTMP_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use


def _round_up(v, m):
    return -(-v // m) * m


def _lstmp_smem_floats(bsz, p, d, ku, kp, row_tile, h_rows, resident,
                       prefetch):
    """Shared memory K7 needs, in 4-byte words: its layout in
    csrc/fused_lstmp_fwd.cu region by region, each a multiple of 4. One
    region serves phase A (the r^T row tile, the partial sums of an 8 x 4
    tile a thread, their sums) and then phase B (h_rows rows of h and a
    word a thread for the warps' sums)."""
    pp, dp = _round_up(p, 4), _round_up(d, 4)
    weights = pp * 4 * ku + dp * _round_up(kp, 4) if resident else 0
    shared = max(pp * row_tile + LSTMP_THREADS * 32 + row_tile * 4 * ku,
                 h_rows * dp + LSTMP_THREADS)
    xs = _round_up(2 * bsz * 4 * ku, 4) if prefetch else 0
    return (weights + shared + xs + _round_up(bsz * ku, 4)
            + _round_up(bsz * kp, 4) + bsz)


def lstmp_launch_plan(bsz, d, p, sm_count, smem_limit=LSTMP_SMEM_LIMIT):
    """K7's launch plan for B rows, D hidden units and P projection
    columns on a card with `sm_count` SMs: a dict with
      grid      -- blocks, one per SM: min(sm_count, max(D, P));
      units     -- block j's hidden units [u0, u1) = [j D / G, (j+1) D / G);
      cols      -- block j's projection columns, the same split of P;
      ku, kp    -- the most units / columns any block owns;
      row_tile  -- rows of r_prev staged in shared memory at once (a
                   multiple of 8; B rounded up to 8 when it fits);
      b_pad     -- B rounded up to the row tile (the exchanged r's rows);
      h_rows    -- rows of h_new staged at once for the projection (as
                   many as the shared memory left over holds, at most B
                   and at most 8 rows a warp);
      resident  -- the weight slices stay in shared memory for the launch
                   (False: they are read from L2 at every step);
      prefetch  -- the next step's x columns of all B rows are copied
                   into shared memory during a step (False: the cell
                   update reads them from global memory);
      smem      -- dynamic shared memory bytes;
      scratch   -- fp32 words of the zeroed scratch buffer: the grid
                   barrier's counter, r [P, b_pad] and h [B, D] (P and D
                   rounded up to 4);
      threads   -- threads per block.
    Resident weights come first, then the prefetch, then the largest row
    tile that fits (a thread's tile is 8 rows x 4 gate columns, and a
    row tile gives every thread at least one). Raises ValueError when not
    even 8 rows fit (B's own state alone overflows a block)."""
    if bsz <= 0 or d <= 0 or p <= 0 or sm_count <= 0:
        raise ValueError("lstmp_launch_plan needs positive B, D, P and SM "
                         "count, got %r" % ((bsz, d, p, sm_count),))
    grid = min(sm_count, max(d, p))
    ku, kp = -(-d // grid), -(-p // grid)
    top = min(_round_up(bsz, 8), LSTMP_THREADS // ku * 8)
    dp = _round_up(d, 4)
    for resident, prefetch, row_tile in (
            (r, f, n) for r in (True, False) for f in (True, False)
            for n in range(top, 0, -8)):
        # phase B's h rows take phase A's buffers and what is left over
        base = _lstmp_smem_floats(bsz, p, d, ku, kp, row_tile, 0, resident,
                                  prefetch)
        phase_a = (_round_up(p, 4) * row_tile + LSTMP_THREADS * 32
                   + row_tile * 4 * ku)
        h_rows = min(bsz, LSTMP_THREADS // 32 * 8,
                     (smem_limit // 4 - base + phase_a
                      - LSTMP_THREADS) // dp)
        if 4 * base <= smem_limit and h_rows >= 1:
            words = _lstmp_smem_floats(bsz, p, d, ku, kp, row_tile, h_rows,
                                       resident, prefetch)
            b_pad = _round_up(bsz, row_tile)
            return {
                "grid": grid, "ku": ku, "kp": kp,
                "units": [(j * d // grid, (j + 1) * d // grid)
                          for j in range(grid)],
                "cols": [(j * p // grid, (j + 1) * p // grid)
                         for j in range(grid)],
                "row_tile": row_tile, "b_pad": b_pad, "h_rows": h_rows,
                "resident": resident,
                "prefetch": prefetch, "smem": 4 * words,
                "scratch": 4 + _round_up(p, 4) * b_pad
                + bsz * _round_up(d, 4),
                "threads": LSTMP_THREADS}
    raise ValueError("fused_lstmp: batch %d at D=%d, P=%d needs more shared "
                     "memory than a block has (%d bytes)"
                     % (bsz, d, p, smem_limit))


def fused_lstmp_plain(x, w, w_proj, b, r0=None, c0=None, lens=None,
                      reverse=False, peepholes=None,
                      acts=(torch.sigmoid, torch.tanh, torch.tanh,
                            torch.tanh),
                      dtype=torch.float32):
    """Plain version: the masked LSTMP recurrence as a torch loop over T
    (the JAX package's lax.scan step of the lstmp rule). Per step, with
    gate order {candidate, input, forget, output}: g = x_t + r_prev @ w +
    b, c_new = act_gate(g_f) * c + act_gate(g_i) * act_cand(g_c), h_new =
    act_gate(g_o) * act_cell(c_new), r_new = act_proj(h_new @ w_proj); a
    step at or past lens[b] carries (r, c) unchanged; reverse walks t from
    T-1 down. r0 [B, P] is the already projected initial state (zeros when
    None). Returns (projection [B, T, P], cell [B, T, D]) in `dtype`.

    The lstmp rule also runs it for what K7 does not cover: peepholes [3D]
    (w_ic, w_fc, w_oc), other (gate, cell, candidate, proj) activations
    and another state dtype."""
    bsz, t, d, p = _lstmp_args(x, w, w_proj, b, r0, c0, lens)
    xf, wf, wpf = x.to(dtype), w.to(dtype), w_proj.to(dtype)
    bf = b.reshape(-1).to(dtype)
    r = torch.zeros((bsz, p), dtype=dtype, device=x.device) \
        if r0 is None else r0.to(dtype)
    c = torch.zeros((bsz, d), dtype=dtype, device=x.device) \
        if c0 is None else c0.to(dtype)
    if peepholes is not None:
        peepholes = peepholes.reshape(3, d).to(dtype)
    m = step_mask(lens, bsz, t, x.device, dtype)
    proj = torch.empty((bsz, t, p), dtype=dtype, device=x.device)
    cell = torch.empty((bsz, t, d), dtype=dtype, device=x.device)
    for k in range(t):
        s = t - 1 - k if reverse else k
        c_new, h_new = _cell_step(xf[:, s] + r @ wf + bf, c, peepholes,
                                  *acts[:3])
        r_new = acts[3](h_new @ wpf)
        ms = m[:, s:s + 1]
        r = ms * r_new + (1 - ms) * r
        c = ms * c_new + (1 - ms) * c
        proj[:, s] = r
        cell[:, s] = c
    return proj, cell


def fused_lstmp(x, w, w_proj, b, r0=None, c0=None, lens=None, reverse=False):
    """The whole masked LSTMP recurrence over x [B, T, 4D] (the
    pre-projected gate inputs; any batch and time strides, last dim
    contiguous on the card), recurrent weight w [P, 4D], projection
    w_proj [D, P], gate bias b [4D], optional r0 [B, P] (the projected
    initial state) and c0 [B, D] (zeros when None) and lengths lens [B]
    (every step when None). Returns (projection [B, T, P], cell [B, T, D])
    fp32.

    Dispatch by x's device: meta -> empty outputs, cpu -> the plain
    version, cuda -> the kernel (fp32 only; anything else raises): one
    cooperative launch of one block per SM, as lstmp_launch_plan lays it
    out for this card; a refused launch raises."""
    bsz, t, d, p = _lstmp_args(x, w, w_proj, b, r0, c0, lens)
    dev = x.device.type
    if dev == "meta":
        return (torch.empty((bsz, t, p), dtype=torch.float32,
                            device=x.device),
                torch.empty((bsz, t, d), dtype=torch.float32,
                            device=x.device))
    if dev == "cpu":
        return fused_lstmp_plain(x, w, w_proj, b, r0, c0, lens, reverse)
    if dev != "cuda":
        raise ValueError("fused_lstmp: unsupported device %s" % dev)
    for name, a in (("x", x), ("w", w), ("w_proj", w_proj), ("b", b),
                    ("r0", r0), ("c0", c0)):
        if a is None:
            continue
        if a.dtype != torch.float32:
            raise ValueError("fused_lstmp: the CUDA kernel takes fp32 (%s is "
                             "%s)" % (name, a.dtype))
        if a.device != x.device:
            raise ValueError("fused_lstmp: %s on %s, x on %s"
                             % (name, a.device, x.device))
    if x.stride(2) != 1:
        raise ValueError("fused_lstmp: x needs a contiguous last dim (got "
                         "strides %s)" % (tuple(x.stride()),))
    w = w.contiguous()
    w_proj = w_proj.contiguous()
    b = b.reshape(-1).contiguous()
    r0 = r0.contiguous() if r0 is not None else None
    c0 = c0.contiguous() if c0 is not None else None
    proj = torch.empty((bsz, t, p), dtype=torch.float32, device=x.device)
    cell = torch.empty((bsz, t, d), dtype=torch.float32, device=x.device)
    if bsz == 0 or t == 0 or d == 0 or p == 0:
        return proj, cell
    if lens is not None:
        lens = lens.reshape(bsz).to(device=x.device,
                                    dtype=torch.int32).contiguous()
    plan = lstmp_launch_plan(bsz, d, p, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    _launch_lstmp(build(), plan, x, w, w_proj, b, r0, c0, lens, reverse,
                  proj, cell)
    _count("fused_lstmp")
    return proj, cell


def _launch_lstmp(lib, plan, x, w, w_proj, b, r0, c0, lens, reverse,
                  proj=None, cell=None):
    """One launch of K7 from `lib` with `plan`, on checked CUDA tensors
    (w, w_proj, b, r0, c0 contiguous; lens int32 or None). Allocates the
    zeroed scratch (and the outputs when not given); raises when the
    launch is refused. Returns (proj, cell)."""
    bsz, t, four_d = x.shape
    d, p = four_d // 4, w_proj.shape[1]
    if proj is None:
        proj = torch.empty((bsz, t, p), dtype=torch.float32, device=x.device)
        cell = torch.empty((bsz, t, d), dtype=torch.float32, device=x.device)
    scratch = torch.zeros(plan["scratch"], dtype=torch.float32,
                          device=x.device)
    err = lib.ptt_fused_lstmp_fwd(
        x.data_ptr(), x.stride(0), x.stride(1), w.data_ptr(),
        w_proj.data_ptr(), b.data_ptr(),
        r0.data_ptr() if r0 is not None else None,
        c0.data_ptr() if c0 is not None else None,
        lens.data_ptr() if lens is not None else None,
        proj.data_ptr(), cell.data_ptr(), scratch.data_ptr(), bsz, t, d, p,
        int(bool(reverse)), plan["grid"], plan["ku"], plan["kp"],
        plan["row_tile"], plan["h_rows"], int(plan["prefetch"]),
        plan["smem"], int(plan["resident"]), plan["threads"],
        _stream_of(x))
    _check_launch(err, "fused_lstmp")
    return proj, cell


def fused_lstmp_bwd(x, w, w_proj, b, r0, c0, lens, proj, cell, g_proj,
                    g_cell, reverse=False):
    """Gradients (dx, dw, dw_proj, db, dr0, dc0) of fused_lstmp from its
    SAVED states (parity: pallas_kernels._lstmp_seq_core_bwd): no forward
    is run again. Everything the carried gradients do not touch is
    computed once over all steps with batched products: the gates from
    the saved (r_prev, c_prev), z i f o, tanh(c_new), h_new and r_new =
    tanh(h_new @ w_proj). The loop then walks the steps in reverse
    processing order carrying (dr, dc); dw, dw_proj and db come from one
    product or sum each after it. Works on any device (torch code, as in
    the JAX package)."""
    bsz, t, d, p = _lstmp_args(x, w, w_proj, b, r0, c0, lens)
    dev = x.device
    r_prev = _entering(r0, _walk(proj, reverse))               # [T, B, P]
    c_prev = _entering(c0, _walk(cell, reverse))               # [T, B, D]
    f, h_new, p_c, q_c, q_o = _cell_terms(_walk(x, reverse), r_prev, c_prev,
                                          w, b)
    wpf = w_proj.float()
    r_new = torch.tanh(h_new.reshape(t * bsz, d) @ wpf).reshape(t, bsz, p)
    m = _walk(step_mask(lens, bsz, t, dev)[..., None], reverse)
    one_m = 1 - m
    # dproj = dr * m * (1 - r_new^2), then dh_new = dproj @ w_proj^T
    s_r = m * (1 - r_new * r_new)
    del r_new
    gr = torch.zeros((t, bsz, p), dtype=torch.float32, device=dev) \
        if g_proj is None else _walk(g_proj, reverse)
    gc = torch.zeros((t, bsz, d), dtype=torch.float32, device=dev) \
        if g_cell is None else _walk(g_cell, reverse)
    dg = torch.empty((t, bsz, 4, d), dtype=torch.float32, device=dev)
    dproj = torch.empty((t, bsz, p), dtype=torch.float32, device=dev)
    wt, wpt = w.float().t().contiguous(), wpf.t().contiguous()
    dr_c = torch.zeros((bsz, p), dtype=torch.float32, device=dev)
    dc_c = torch.zeros((bsz, d), dtype=torch.float32, device=dev)
    for k in range(t - 1, -1, -1):
        dr = dr_c + gr[k]
        dc = dc_c + gc[k]
        torch.mul(dr, s_r[k], out=dproj[k])
        dh_new = dproj[k] @ wpt
        dc_new = torch.addcmul(dc * m[k], dh_new, p_c[k])
        torch.mul(dc_new[:, None], q_c[k], out=dg[k, :, :3])
        torch.mul(dh_new, q_o[k], out=dg[k, :, 3])
        dr_c = torch.addmm(dr * one_m[k], dg[k].reshape(bsz, 4 * d), wt)
        dc_c = torch.addcmul(dc * one_m[k], dc_new, f[k])
    dg = dg.reshape(t * bsz, 4 * d)
    dw = r_prev.reshape(t * bsz, p).t() @ dg
    dw_proj = h_new.reshape(t * bsz, d).t() @ dproj.reshape(t * bsz, p)
    db = dg.sum(dim=0)
    dg = dg.reshape(t, bsz, 4 * d)
    dx = (dg.flip(0) if reverse else dg).transpose(0, 1)
    return (dx.to(x.dtype), dw.to(w.dtype), dw_proj.to(w_proj.dtype),
            db.to(b.dtype).reshape(b.shape), dr_c, dc_c)


# ---------------------------------------------------------------------------
# masked sequence softmax forward (replaces
# pallas_kernels._masked_softmax_kernel)
# ---------------------------------------------------------------------------

SOFTMAX_WARPS = 2   # rows (one warp each) a block of K8 (k6_ablation.py)
SOFTMAX_REG_CAP = 1024  # the longest row K8 holds in registers


def _softmax_args(x, lens):
    if x.dim() != 2 or lens.numel() != x.shape[0]:
        raise ValueError("masked_softmax needs x [N, T] and N lengths, got "
                         "%s and %s" % (tuple(x.shape), tuple(lens.shape)))
    return x.shape


def masked_softmax_plain(x, lens):
    """Plain version: the softmax over t < lens[n] of each row of x [N, T]
    in fp32, 0 at t >= lens[n] (a length-0 row is all 0: its sum is
    floored at 1e-30, as in the TPU kernel). Returns [N, T] in x's
    dtype."""
    n, t = _softmax_args(x, lens)
    valid = step_mask(lens, n, t, x.device, torch.bool)
    s = torch.where(valid, x.float(), _NEG)
    p = torch.where(valid, torch.exp(s - s.amax(dim=1, keepdim=True)), 0.0)
    return (p / p.sum(dim=1, keepdim=True).clamp_min(1e-30)).to(x.dtype)


def masked_softmax(x, lens):
    """Softmax over the time dim of x [N, T] (any row stride, last dim
    contiguous on the card) with lengths lens [N]: steps t >= lens[n] get
    0. Dispatch by x's device as in fused_lstm (the CUDA kernel takes
    fp32)."""
    n, t = _softmax_args(x, lens)
    dev = x.device.type
    if dev == "meta":
        return torch.empty((n, t), dtype=x.dtype, device=x.device)
    if dev == "cpu":
        return masked_softmax_plain(x, lens)
    if dev != "cuda":
        raise ValueError("masked_softmax: unsupported device %s" % dev)
    if x.dtype != torch.float32:
        raise ValueError("masked_softmax: the CUDA kernel takes fp32 (got %s)"
                         % x.dtype)
    if x.stride(1) != 1:
        raise ValueError("masked_softmax: x needs a contiguous last dim (got "
                         "strides %s)" % (tuple(x.stride()),))
    y = torch.empty((n, t), dtype=torch.float32, device=x.device)
    if n == 0 or t == 0:
        return y
    lens = lens.reshape(n).to(device=x.device, dtype=torch.int32).contiguous()
    lib = build()
    err = lib.ptt_masked_softmax_fwd(x.data_ptr(), x.stride(0),
                                     lens.data_ptr(), y.data_ptr(), n, t,
                                     SOFTMAX_WARPS, _stream_of(x))
    _check_launch(err, "masked_softmax")
    _count("masked_softmax")
    return y


# ---------------------------------------------------------------------------
# masked sequence pool forward (replaces pallas_kernels._masked_pool_kernel)
# ---------------------------------------------------------------------------

POOL_TYPES = ("SUM", "AVERAGE", "SQRT")
POOL_THREADS = 256      # a block of K9 (kThreads in csrc/masked_pool_fwd.cu)
POOL_CLUSTERS = (1, 2, 4, 8)   # blocks a cluster along T (portable sizes)
POOL_COLS = 32          # the most columns a block spans (a warp's width)
# a row (feature tile) is split over a cluster until a block reads at most
# POOL_BLOCK_BYTES of its padded span, but not beyond one wave of blocks
# (the blocks the card holds at once): k9_ablation.py measured a
# cluster's two barriers at ~0.8 us a launch, and grids of more than one
# wave of short blocks slower than one wave, on an H100
POOL_BLOCK_BYTES = 32 * 1024
POOL_BLOCKS_PER_SM = 8  # 2048 threads an SM / POOL_THREADS (registers
                        # permitting; on the card the occupancy query says)


def _pool_vec(f, sxb, sxt, aligned):
    """4 (float4 loads) when F and the strides are multiples of 4 and x's
    base is 16-byte aligned, else 1."""
    return 4 if (f % 4 == 0 and sxb % 4 == 0 and sxt % 4 == 0
                 and aligned) else 1


def pool_launch_plan(b, t, f, sxb, sxt, aligned, sm_count, cs=None,
                     blocks_per_sm=POOL_BLOCKS_PER_SM):
    """K9's launch plan for x [B, T, F] with batch and time strides sxb,
    sxt (elements), `aligned` when x's base is 16-byte aligned, on a card
    with `sm_count` SMs each holding `blocks_per_sm` blocks of K9 at once.
    From shapes only (the lengths stay on the card). A dict with
      vec      -- 4 (float4 loads) when F, sxb and sxt are multiples of 4
                  and x is aligned, else 1;
      cols     -- ceil(F / vec) columns of vec floats;
      lf, lt   -- a block's lanes along F (a power of 2 up to POOL_COLS)
                  and along T (POOL_THREADS / lf);
      tiles    -- ceil(cols / lf) feature tiles (grid.y, at most 65535);
      cs       -- blocks a thread-block cluster along T (POOL_CLUSTERS);
      chunk    -- ceil(T / cs) steps a block (at least 1);
      ranges   -- block c's steps [c chunk, (c + 1) chunk) cut to [0, T);
      grid     -- (B * cs, tiles); blocks_per_sm -- as given.
    cs is the smallest size whose blocks read at most POOL_BLOCK_BYTES of
    a tile's padded span T * min(F, lf * vec) * 4, halved while the grid
    holds more than one wave (sm_count * blocks_per_sm blocks); `cs` pins
    it (tests, ablation). Raises ValueError on sizes the grid cannot take
    (tiles over 65535, B * cs over 2^31 - 1)."""
    if b < 1 or t < 0 or f < 1 or sm_count < 1 or blocks_per_sm < 1:
        raise ValueError("pool_launch_plan needs B, F, SM count, blocks an "
                         "SM >= 1 and T >= 0, got %r"
                         % ((b, t, f, sm_count, blocks_per_sm),))
    vec = _pool_vec(f, sxb, sxt, aligned)
    cols = -(-f // vec)
    lf = 1
    while lf < min(cols, POOL_COLS):
        lf *= 2
    tiles = -(-cols // lf)
    if tiles > 65535:
        raise ValueError("masked_pool: F = %d needs %d feature tiles, over "
                         "the grid limit 65535" % (f, tiles))
    if cs is None:
        span = t * min(f, lf * vec) * 4
        cs = 1
        while cs < POOL_CLUSTERS[-1] and span > POOL_BLOCK_BYTES * cs:
            cs *= 2
        while cs > 1 and b * tiles * cs > sm_count * blocks_per_sm:
            cs //= 2
    elif cs not in POOL_CLUSTERS:
        raise ValueError("masked_pool: a cluster of %r blocks (not in %s)"
                         % (cs, POOL_CLUSTERS))
    if b * cs > _INT_MAX:
        raise ValueError("masked_pool: B * CS = %d over the grid limit %d"
                         % (b * cs, _INT_MAX))
    chunk = max(1, -(-t // cs))
    return {"vec": vec, "cols": cols, "lf": lf, "lt": POOL_THREADS // lf,
            "tiles": tiles, "cs": cs, "chunk": chunk,
            "ranges": [(min(c * chunk, t), min((c + 1) * chunk, t))
                       for c in range(cs)],
            "grid": (b * cs, tiles), "blocks_per_sm": blocks_per_sm}


_pool_cards = {}


def pool_plan_of(x, cs=None):
    """pool_launch_plan for the CUDA tensor x [B, T, F] on its card: the
    SM count from the device's properties and the blocks an SM holds from
    the occupancy query of the kernel the plan's vec picks (cached per
    card and vec)."""
    b, t, f = x.shape
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    aligned = x.data_ptr() % 16 == 0
    vec = _pool_vec(f, x.stride(0), x.stride(1), aligned)
    key = (index, vec)
    if key not in _pool_cards:
        n = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = build().ptt_masked_pool_blocks_per_sm(vec, ctypes.byref(n))
        _check_launch(err, "masked_pool occupancy query")
        _pool_cards[key] = (
            torch.cuda.get_device_properties(index).multi_processor_count,
            n.value)
    sms, per_sm = _pool_cards[key]
    return pool_launch_plan(b, t, f, x.stride(0), x.stride(1), aligned, sms,
                            cs=cs, blocks_per_sm=per_sm)


def _launch_pool(lib, plan, x, lens, ptype, out):
    """One launch of K9 from `lib` with `plan` on checked CUDA tensors
    (lens int32 [B] contiguous, out fp32 [B, F] contiguous); raises when
    the launch is refused."""
    b, t, f = x.shape
    err = lib.ptt_masked_pool_fwd(
        x.data_ptr(), x.stride(0), x.stride(1), lens.data_ptr(),
        out.data_ptr(), b, t, f, POOL_TYPES.index(ptype), plan["vec"],
        plan["lf"], plan["cs"], plan["chunk"], _stream_of(x))
    _check_launch(err, "masked_pool")
    return out


def _pool_args(x, lens, ptype):
    if ptype not in POOL_TYPES:
        raise ValueError("masked_pool handles %s, got %r"
                         % ("/".join(POOL_TYPES), ptype))
    if x.dim() != 3 or lens.numel() != x.shape[0]:
        raise ValueError("masked_pool needs x [B, T, F] and B lengths, got "
                         "%s and %s" % (tuple(x.shape), tuple(lens.shape)))
    return x.shape


def masked_pool_plain(x, lens, ptype="AVERAGE"):
    """Plain version: the sum over steps t < lens[b] of x [B, T, F] in
    fp32, divided by max(len, 1) (AVERAGE) or its square root (SQRT).
    Returns [B, F] in x's dtype."""
    b, t, _ = _pool_args(x, lens, ptype)
    m = step_mask(lens, b, t, x.device)[:, :, None]
    s = (x.float() * m).sum(dim=1)
    denom = lens.reshape(b, 1).to(device=x.device,
                                  dtype=torch.float32).clamp_min(1.0)
    if ptype == "AVERAGE":
        s = s / denom
    elif ptype == "SQRT":
        s = s / torch.sqrt(denom)
    return s.to(x.dtype)


def masked_pool(x, lens, ptype="AVERAGE"):
    """SUM / AVERAGE / SQRT pool over the time dim of x [B, T, F] (any
    batch and time strides, last dim contiguous on the card) with lengths
    lens [B]: returns [B, F]. Dispatch by x's device as in fused_lstm (the
    CUDA kernel takes fp32, any B, and F up to 65535 tiles of its plan)."""
    b, t, f = _pool_args(x, lens, ptype)
    dev = x.device.type
    if dev == "meta":
        return torch.empty((b, f), dtype=x.dtype, device=x.device)
    if dev == "cpu":
        return masked_pool_plain(x, lens, ptype)
    if dev != "cuda":
        raise ValueError("masked_pool: unsupported device %s" % dev)
    if x.dtype != torch.float32:
        raise ValueError("masked_pool: the CUDA kernel takes fp32 (got %s)"
                         % x.dtype)
    if x.stride(2) != 1:
        raise ValueError("masked_pool: x needs a contiguous last dim (got "
                         "strides %s)" % (tuple(x.stride()),))
    out = torch.empty((b, f), dtype=torch.float32, device=x.device)
    if b == 0 or f == 0:
        return out
    plan = pool_plan_of(x)
    lens = lens.reshape(b).to(device=x.device, dtype=torch.int32).contiguous()
    _launch_pool(build(), plan, x, lens, ptype, out)
    _count("masked_pool")
    return out


# ---------------------------------------------------------------------------
# autograd Functions (the JAX package's custom_vjps)
# ---------------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v) through K1; backward through K2 and K3
    (parity: pallas_kernels._flash_core / _flash_core_bwd). kv_len gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, scale):
        if scale is None:
            scale = 1.0 / math.sqrt(q.shape[-1])
        out, lse = flash_attention_fwd(q, k, v, kv_len, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, kv_len = ctx.saved_tensors
        # the kernels read 16-byte aligned rows; autograd may hand over a
        # strided or expanded gradient
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g.contiguous(),
                                         kv_len, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


class LayerNorm(torch.autograd.Function):
    """(y, mean, var) = layer_norm(x [N, D], scale, bias) through K5;
    backward in torch from the saved statistics, with rstd = rsqrt(var +
    eps) (parity: pallas_kernels._ln_core_bwd). mean and var carry no
    gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, var = layer_norm_fwd(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _gmean, _gvar):
        x, scale, mean, var = ctx.saved_tensors
        gf = g.float()
        rstd = torch.rsqrt(var + ctx.eps)[:, None]
        xhat = (x.float() - mean[:, None]) * rstd
        gs = gf * scale.float()[None, :]
        dx = rstd * (gs - gs.mean(dim=-1, keepdim=True)
                     - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
        return (dx.to(x.dtype), (gf * xhat).sum(dim=0).to(scale.dtype),
                gf.sum(dim=0).to(scale.dtype), None)


class SoftmaxXent(torch.autograd.Function):
    """(loss, lse) [N, 1] = softmax cross-entropy of logits [N, V] with hard
    labels through K4; backward in torch (parity:
    pallas_kernels._xent_core_bwd): d logits = p * (g_loss + g_lse) -
    onehot * g_loss, with p = exp(logits - lse) and the one-hot at the
    class hard_label_index picks (the forward's class). lse is
    differentiable so that a softmax built as exp(logits - lse) gets its
    exact gradient. The [N, V] gradient is built
    in place in one buffer (the exponential's), to hold one [N, V] tensor
    rather than four."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = softmax_xent_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss, lse

    @staticmethod
    def backward(ctx, g_loss, g_lse):
        logits, labels, lse = ctx.saved_tensors
        n, v = logits.shape
        d = torch.sub(logits.float(), lse).exp_()
        d.mul_(g_loss + g_lse)
        d.scatter_add_(1, hard_label_index(labels.reshape(n, 1), v),
                       -g_loss.float())
        return d.to(logits.dtype), None


class FusedLSTM(torch.autograd.Function):
    """(hidden, cell) = the masked LSTM recurrence through K6; backward the
    saved-state reverse scan of fused_lstm_bwd (parity:
    pallas_kernels._lstm_seq_core / _lstm_seq_core_bwd). lens gets no
    gradient; h0 and c0 get theirs when given."""

    @staticmethod
    def forward(ctx, x, w, b, h0, c0, lens, reverse):
        hidden, cell = fused_lstm(x, w, b, h0, c0, lens, reverse)
        ctx.save_for_backward(x, w, b, h0, c0, lens, hidden, cell)
        ctx.reverse = reverse
        return hidden, cell

    @staticmethod
    def backward(ctx, g_hidden, g_cell):
        x, w, b, h0, c0, lens, hidden, cell = ctx.saved_tensors
        dx, dw, db, dh0, dc0 = fused_lstm_bwd(
            x, w, b, h0, c0, lens, hidden, cell, g_hidden, g_cell,
            ctx.reverse)
        return (dx, dw, db, dh0 if h0 is not None else None,
                dc0 if c0 is not None else None, None, None)


class FusedLSTMP(torch.autograd.Function):
    """(projection, cell) = the masked LSTMP recurrence through K7;
    backward the saved-state reverse scan of fused_lstmp_bwd (parity:
    pallas_kernels._lstmp_seq_core / _lstmp_seq_core_bwd). lens gets no
    gradient; r0 and c0 get theirs when given."""

    @staticmethod
    def forward(ctx, x, w, w_proj, b, r0, c0, lens, reverse):
        proj, cell = fused_lstmp(x, w, w_proj, b, r0, c0, lens, reverse)
        ctx.save_for_backward(x, w, w_proj, b, r0, c0, lens, proj, cell)
        ctx.reverse = reverse
        return proj, cell

    @staticmethod
    def backward(ctx, g_proj, g_cell):
        x, w, w_proj, b, r0, c0, lens, proj, cell = ctx.saved_tensors
        dx, dw, dwp, db, dr0, dc0 = fused_lstmp_bwd(
            x, w, w_proj, b, r0, c0, lens, proj, cell, g_proj, g_cell,
            ctx.reverse)
        return (dx, dw, dwp, db, dr0 if r0 is not None else None,
                dc0 if c0 is not None else None, None, None)


class MaskedSoftmax(torch.autograd.Function):
    """y [N, T] = masked softmax of x [N, T] over t < lens through K8;
    backward in torch from the saved output (parity:
    pallas_kernels._masked_softmax_core_bwd): dx = y * (g - sum(g * y)).
    Masked steps have y == 0, so their gradient is exactly 0. lens gets no
    gradient."""

    @staticmethod
    def forward(ctx, x, lens):
        y = masked_softmax(x, lens)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        yf, gf = y.float(), g.float()
        dx = yf * (gf - (gf * yf).sum(dim=-1, keepdim=True))
        return dx.to(y.dtype), None


class MaskedPool(torch.autograd.Function):
    """out [B, F] = masked SUM / AVERAGE / SQRT pool of x [B, T, F] through
    K9; backward in torch (parity: pallas_kernels._masked_pool_core_bwd):
    the output gradient, scaled as the pool scales, spread over the steps
    t < len and zero on the padding. lens gets no gradient."""

    @staticmethod
    def forward(ctx, x, lens, ptype):
        out = masked_pool(x, lens, ptype)
        ctx.save_for_backward(lens)
        ctx.shape, ctx.dtype, ctx.ptype = x.shape, x.dtype, ptype
        return out

    @staticmethod
    def backward(ctx, g):
        lens, = ctx.saved_tensors
        b, t, _ = ctx.shape
        gf = g.float()[:, None, :]
        denom = lens.reshape(b, 1, 1).to(device=g.device,
                                         dtype=torch.float32).clamp_min(1.0)
        if ctx.ptype == "AVERAGE":
            gf = gf / denom
        elif ctx.ptype == "SQRT":
            gf = gf / torch.sqrt(denom)
        m = step_mask(lens, b, t, g.device)[:, :, None]
        return (gf * m).to(ctx.dtype), None, None


# ---------------------------------------------------------------------------
# a while loop inside a captured CUDA graph (csrc/graph_while.cu; replaces
# no TPU kernel: the JAX package's While is a lax.while_loop whose
# predicate XLA evaluates on the device)
# ---------------------------------------------------------------------------

def _cond_arg(cond, what):
    if cond.device.type != "cuda" or cond.dtype != torch.bool or \
            cond.numel() != 1 or not cond.is_contiguous():
        raise ValueError("%s takes a contiguous one-element bool tensor on "
                         "a card; got %s %s on %s" % (
                             what, cond.dtype, tuple(cond.shape),
                             cond.device))


def _graph_while_check(lib, err, what):
    if err != 0:
        from ..core.lowering import GraphCaptureError
        raise GraphCaptureError("%s failed: %s (cudaError %d)" % (
            what, lib.ptt_cuda_error_string(err).decode(), err))


def set_while_condition_plain(cond):
    """Plain version: the value the loop's handle takes, read on the host
    (the eager loop's one read an iteration)."""
    return bool(cond.reshape(()))


def set_while_condition(handle, cond):
    """Launch set_while_condition on the current stream: the conditional
    handle `handle` (of a node being captured) takes cond's value on the
    device. `cond`: a one-element bool tensor on the card."""
    _cond_arg(cond, "set_while_condition")
    lib = build()
    _graph_while_check(lib, lib.ptt_set_while_condition(
        handle, cond.data_ptr(), _stream_of(cond)), "set_while_condition")
    _count("set_while_condition")


def graph_while_begin(cond, body_stream):
    """On the current stream, which is capturing a CUDA graph: a
    conditional handle, set_while_condition(handle, cond) (the entry
    test), a WHILE node after the stream's work (what the stream captures
    next runs after the loop), and `body_stream` capturing into the
    node's body graph. Returns the handle; end the body's capture with
    graph_while_end(body_stream)."""
    _cond_arg(cond, "graph_while_begin")
    lib = build()
    handle = ctypes.c_ulonglong()
    _graph_while_check(lib, lib.ptt_graph_while_begin(
        _stream_of(cond), ctypes.c_void_p(body_stream.cuda_stream),
        cond.data_ptr(), ctypes.byref(handle)),
        "adding a conditional while node to the captured graph")
    _count("set_while_condition")
    return handle.value


def graph_while_end(body_stream):
    """End the capture of a while node's body on `body_stream`."""
    lib = build()
    _graph_while_check(lib, lib.ptt_graph_while_end(
        ctypes.c_void_p(body_stream.cuda_stream)),
        "ending the capture of the while body")
