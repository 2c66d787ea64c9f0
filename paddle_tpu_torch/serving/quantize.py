"""Weight-dtype reduction for serving engines.

Parity: the JAX package's serving/quantize.py. `InferenceEngine(...,
weights_dtype=...)` trades weight precision for memory PER ENGINE, at
load time, without touching the fp32 model files on disk:

* "fp32": no-op (the default).
* "bf16": the matmul/conv weight params cast to bfloat16 in the engine's
  private Scope AND the program's mixed precision turned on, so the
  contractions run bf16 (the same lowering path training AMP uses,
  core/lowering._apply_amp: a Transformer's fused_attention then runs
  the bf16 flash kernel); norm statistics and losses stay f32. Half the
  weight bytes.
* "int8": the matmul/conv weight params are quantized per output
  channel (symmetric, scale = max|W_c| / 127) and REWRITTEN into the
  program: the param var becomes a computed intermediate fed by a
  prepended `dequantize_channel` op (ops/quant_ops.py) over two new
  persistables, <name>@QVAL (int8 values) and <name>@QSCALE (f32
  per-channel scales). Consumers read the same var name. The weight is
  stored at 1/4 size and widened to f32 on every dispatch (a plain torch
  op: nothing fuses the widening into the consumer); compute precision
  is unchanged, and the divergence from fp32 is the per-channel rounding,
  which `divergence_bound` gates.

Only params consumed as matmul/conv weights quantize (mul/matmul "Y",
conv "Filter"); biases, norm parameters and embedding tables stay f32.
The program rewrite bumps the program version, so nothing cached for the
fp32 program serves the quantized one.
"""
import numpy as np
import torch

__all__ = ["WEIGHTS_DTYPES", "QVAL_SUFFIX", "QSCALE_SUFFIX",
           "quantizable_params", "apply_weights_dtype",
           "divergence_bound"]

WEIGHTS_DTYPES = ("fp32", "bf16", "int8")
QVAL_SUFFIX = "@QVAL"
QSCALE_SUFFIX = "@QSCALE"

# op type -> (weight input slot, per-OUTPUT-channel axis of that param)
_WEIGHT_SLOTS = {
    "mul": ("Y", -1),
    "matmul": ("Y", -1),
    "conv2d": ("Filter", 0),            # OIHW: O is axis 0
    "depthwise_conv2d": ("Filter", 0),
    "conv2d_transpose": ("Filter", 1),  # IOHW: O is axis 1
}

# default max-abs-divergence gates of a quantized engine against its fp32 twin,
# relative to the fp32 engine's output magnitude (see divergence_bound).
_DEFAULT_BOUNDS = {"bf16": 5e-2, "int8": 5e-2, "fp32": 0.0}


def divergence_bound(weights_dtype):
    """The bounded-divergence gate for a quantized engine vs its fp32
    twin: max |q - f| / (max|f| + 1e-6) must stay under this.
    PADDLE_TPU_QUANT_BOUND overrides (deploy-specific models can be
    deeper or shallower than the default budget assumes)."""
    import os
    env = os.environ.get("PADDLE_TPU_QUANT_BOUND", "")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    return _DEFAULT_BOUNDS.get(weights_dtype, 0.0)


def quantizable_params(program):
    """{param name: per-output-channel axis} for every persistable
    float32 param (>= 2 dims) the program consumes as a matmul/conv
    weight. A name consumed under conflicting channel axes is skipped —
    one scale vector can't serve both layouts."""
    block = program.global_block()
    axes = {}
    skip = set()
    for op in block.ops:
        slot_axis = _WEIGHT_SLOTS.get(op.type)
        if slot_axis is None:
            continue
        slot, axis = slot_axis
        for name in op.inputs.get(slot, ()):
            var = block.vars.get(name)
            if var is None or not var.persistable:
                continue
            if var.dtype not in ("float32", None) or \
                    len(var.shape or ()) < 2:
                continue
            norm_axis = axis % len(var.shape)
            if name in axes and axes[name] != norm_axis:
                skip.add(name)
            axes[name] = norm_axis
    for name in skip:
        axes.pop(name, None)
    return axes


def _quantize_array(arr, axis):
    """(int8 values, f32 per-channel scales) for a float array, symmetric
    per channel along `axis`."""
    arr = np.asarray(arr, dtype=np.float32)
    reduce_axes = tuple(i for i in range(arr.ndim) if i != axis)
    amax = np.abs(arr).max(axis=reduce_axes)
    scales = np.maximum(amax / 127.0, 1e-8).astype(np.float32)
    bshape = [1] * arr.ndim
    bshape[axis] = arr.shape[axis]
    q = np.clip(np.round(arr / scales.reshape(bshape)), -127, 127)
    return q.astype(np.int8), scales


def apply_weights_dtype(program, scope, weights_dtype):
    """Apply the weight-dtype contract to a loaded (program, scope)
    pair, in place, BEFORE the first trace. Returns a report dict:
    {mode, params: [names], bytes_before, bytes_after}. Raises on a
    param named by the census but missing from the scope (a half-loaded
    model must fail loudly, not serve garbage-scaled weights)."""
    mode = (weights_dtype or "fp32").lower()
    if mode not in WEIGHTS_DTYPES:
        raise ValueError("weights_dtype must be one of %s, got %r"
                         % (WEIGHTS_DTYPES, weights_dtype))
    report = {"mode": mode, "params": [], "bytes_before": 0,
              "bytes_after": 0}
    if mode == "fp32":
        return report
    targets = quantizable_params(program)
    block = program.global_block()
    for name in sorted(targets):
        value = scope.get(name)
        if value is None:
            raise ValueError(
                "weights_dtype=%r: param %r is not initialized in the "
                "engine scope (load weights before quantizing)"
                % (mode, name))
        arr = value.detach().cpu().numpy() \
            if isinstance(value, torch.Tensor) else np.asarray(value)
        report["params"].append(name)
        report["bytes_before"] += arr.size * 4
        if mode == "bf16":
            scope.set(name, value.to(torch.bfloat16))
            report["bytes_after"] += arr.size * 2
            continue
        axis = targets[name]
        q, scales = _quantize_array(arr, axis)
        var = block.var(name)
        qv = block.create_var(name=name + QVAL_SUFFIX, shape=var.shape,
                              dtype="int8", persistable=True)
        qs = block.create_var(name=name + QSCALE_SUFFIX,
                              shape=[int(arr.shape[axis])],
                              dtype="float32", persistable=True)
        # the param becomes a computed intermediate: same name, now
        # produced by the prepended dequantize — consumers untouched
        var.persistable = False
        block.prepend_op(
            "dequantize_channel",
            inputs={"X": [qv], "Scale": [qs]},
            outputs={"Out": [var]},
            attrs={"axis": int(axis)}, infer_shape=False)
        device = value.device if isinstance(value, torch.Tensor) else None
        scope.set(name + QVAL_SUFFIX, torch.from_numpy(q).to(device))
        scope.set(name + QSCALE_SUFFIX, torch.from_numpy(scales).to(device))
        scope.drop(name)
        report["bytes_after"] += q.size + scales.size * 4
    if mode == "bf16":
        # the same AMP casts training uses: contractions run bf16,
        # statistics and losses stay f32 (core/lowering._apply_amp)
        program.enable_mixed_precision(True)
    return report
