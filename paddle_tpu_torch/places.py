"""Device places.

Parity: paddle/fluid/platform/place.h (CPUPlace / CUDAPlace) and the JAX
package's places.py. A Place names the torch device an Executor (or any
entry point that takes a device) runs on:

    CPUPlace()      the CPU, because the caller asked for it
    CUDAPlace(i)    CUDA card i
    TPUPlace(i)     the accelerator: here CUDA card i, so scripts written
                    for the JAX package's TPUPlace run on the card

A card Place raises where there is no card (core/executor.resolve_device),
as the default device does: nothing falls back to the CPU.
"""
import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "TPUPlace",
           "is_compiled_with_cuda", "is_compiled_with_tpu"]


class Place(object):
    def torch_device(self):
        """The device string core/executor.resolve_device takes."""
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__ + "()"


class CPUPlace(Place):
    def torch_device(self):
        return "cpu"


class TPUPlace(Place):
    """The accelerator (the JAX package's TPU chip): CUDA card
    `device_id`."""

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def torch_device(self):
        return "cuda:%d" % self.device_id

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self.device_id)


class CUDAPlace(TPUPlace):
    """CUDA card `device_id` (the JAX package's alias for its TPU; here the
    card itself)."""


def is_compiled_with_cuda():
    """True where the port can run on a card (torch sees one): a script's
    `CUDAPlace(0) if is_compiled_with_cuda() else CPUPlace()` then picks
    a place that works."""
    return torch.cuda.is_available()


def is_compiled_with_tpu():
    """The accelerator behind TPUPlace is the card: as
    is_compiled_with_cuda."""
    return torch.cuda.is_available()
