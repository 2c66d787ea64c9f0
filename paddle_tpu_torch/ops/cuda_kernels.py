"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

Counterpart of the JAX package's ops/pallas_kernels.py. Each TPU kernel
on the port's path becomes a CUDA C++ kernel in `paddle_tpu_torch/csrc/`
(see the note at the top of each source for what it replaces and what
bounds it). The sources build at first use with `nvcc` into one shared
library with a plain C interface (`build()`), loaded with ctypes.

Beside each kernel:
  * a wrapper (`flash_attention_fwd`, `layer_norm_fwd`) whose dispatch
    rule is the tensor's device: `meta` returns empty outputs of the right
    shape (build-time shape inference), `cpu` runs the plain version,
    `cuda` launches the kernel or raises. Nothing falls back;
  * a plain PyTorch version (`*_plain`) of the same function — what the
    CPU runs, and what the card's kernel is held against;
  * a launch counter (`wrapper.launches`), raised by one exactly where the
    kernel is launched, so a run can show the main path went through it.
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
           "layer_norm_fwd", "layer_norm_fwd_plain", "launch_counts",
           "reset_launch_counts", "FLASH_HEAD_DIMS"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("flash_attention_fwd.cu", "layer_norm_fwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

FLASH_HEAD_DIMS = (16, 32, 64, 128)
_NEG = -1e30  # the masked-score value and empty-row max (TPU kernel's _NEG)

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


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
    lib.ptt_flash_attention_fwd.argtypes = (
        [P, P, P, P, P, P, I, I, I, I] + [L] * 9 + [F, I, P])
    lib.ptt_flash_attention_fwd.restype = I
    lib.ptt_layer_norm_fwd.argtypes = [P, P, P, P, P, P, I, I, F, I, P]
    lib.ptt_layer_norm_fwd.restype = I


def _count(wrapper):
    with _count_lock:
        wrapper.launches += 1


def launch_counts():
    """{wrapper name: launches since the last reset}."""
    return {f.__name__: f.launches for f in (flash_attention_fwd,
                                             layer_norm_fwd)}


def reset_launch_counts():
    with _count_lock:
        flash_attention_fwd.launches = 0
        layer_norm_fwd.launches = 0


def _stream_of(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check_launch(err, what):
    if err != 0:
        raise RuntimeError("%s: kernel launch failed with cudaError %d"
                           % (what, err))


def _check_vec_layout(t, what):
    """float4 loads need 16-byte aligned rows: last dim contiguous,
    other strides multiples of 4 elements, 16-byte aligned base."""
    if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        raise ValueError("%s: tensor must have a contiguous last dim, "
                         "strides that are multiples of 4 and a 16-byte "
                         "aligned base (got strides %s)"
                         % (what, tuple(t.stride())))


# ---------------------------------------------------------------------------
# flash attention forward (replaces pallas_kernels._flash_fwd_kernel)
# ---------------------------------------------------------------------------

def flash_attention_fwd_plain(q, k, v, kv_len=None, causal=False,
                              scale=None):
    """Plain version: dense masked softmax over [B, H, T, T] in fp32.
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

    Dispatch by q's device: meta -> empty outputs, cpu -> the plain
    version, cuda -> the kernel (fp32, D in FLASH_HEAD_DIMS; anything else
    raises)."""
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
    dev = q.device.type
    if dev == "meta":
        return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
                torch.empty((b, h, t), dtype=torch.float32, device=q.device))
    if dev == "cpu":
        return flash_attention_fwd_plain(q, k, v, kv_len, causal, scale)
    if dev != "cuda":
        raise ValueError("flash_attention_fwd: unsupported device %s" % dev)
    if q.dtype != torch.float32 or k.dtype != torch.float32 \
            or v.dtype != torch.float32:
        raise ValueError("flash_attention_fwd: the CUDA kernel takes fp32")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError("flash_attention_fwd: head dim %d not in %s"
                         % (d, FLASH_HEAD_DIMS))
    if b * h > 65535:
        raise ValueError("flash_attention_fwd: B*H = %d exceeds the grid "
                         "limit 65535" % (b * h))
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError("flash_attention_fwd: %s on %s, q on %s"
                             % (name, x.device, q.device))
        _check_vec_layout(x, "flash_attention_fwd %s" % name)
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if t == 0 or b * h == 0:
        return out, lse
    lens = None
    if kv_len is not None:
        lens = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    lib = build()
    err = lib.ptt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lens.data_ptr() if lens is not None else None,
        out.data_ptr(), lse.data_ptr(), b, t, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), int(bool(causal)), _stream_of(q))
    _check_launch(err, "flash_attention_fwd")
    _count(flash_attention_fwd)
    return out, lse


flash_attention_fwd.launches = 0


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
    _count(layer_norm_fwd)
    return y, mean, var


layer_norm_fwd.launches = 0
