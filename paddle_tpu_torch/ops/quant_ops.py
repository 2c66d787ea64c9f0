"""Quantization ops: the weight-only int8 serving path behind
`InferenceEngine(weights_dtype="int8")` (serving/quantize.py).

Parity: the JAX package's ops/quant_ops.py. The JAX package leaves this
op to XLA, which fuses the widening multiply into the consumer (no Pallas
kernel); here it is a plain torch op: every dispatch widens each int8
weight to f32 in a tensor of its own before the matmul or conv reads it.
"""
import torch

from ..core.registry import register, single

# input-slot storage dtypes of dequantize_channel: the static half of the
# int8 contract
DEQUANTIZE_SLOTS = {"X": "int8", "Scale": "float32"}


@register("dequantize_channel")
def _dequantize_channel(ctx, ins, attrs):
    """int8 per-channel weight dequantize: Out = X.astype(f32) * Scale
    broadcast along `axis`. Compute stays f32; only the weight's storage
    (and its rounding, bounded by the per-channel scale) changes."""
    q = single(ins, "X")          # int8 [param shape]
    scale = single(ins, "Scale")  # f32 [C]
    axis = attrs.get("axis", -1)
    if axis < 0:
        axis += q.dim()
    bshape = [1] * q.dim()
    bshape[axis] = q.shape[axis]
    out = q.to(torch.float32) * scale.reshape(bshape)
    return {"Out": [out]}
