"""fluid.concurrency surface (parity: python/paddle/fluid/concurrency.py
and the JAX package's concurrency module).

A scope cut in both packages: the reference's Go-style CSP channels
(make_channel / channel_send / channel_recv / channel_close / Select)
block interpreter threads between ops and had no model, test or benchmark
user in the reference era. The names exist so that reference scripts fail
with the JAX package's curated, actionable error instead of an
AttributeError.
"""
__all__ = ["make_channel", "channel_send", "channel_recv", "channel_close",
           "Select"]

_MSG = ("fluid.concurrency is not rebuilt in paddle_tpu (explicit scope "
        "cut, SURVEY.md §2): CSP channel ops block host threads between "
        "ops, which contradicts whole-program XLA execution. Use the "
        "reader layers (fluid.layers.double_buffer) for async input, or "
        "ParallelExecutor collectives for parallel coordination.")


def make_channel(dtype, capacity=0):
    raise NotImplementedError(_MSG)


def channel_send(channel, value, is_copy=False):
    raise NotImplementedError(_MSG)


def channel_recv(channel, return_value):
    raise NotImplementedError(_MSG)


def channel_close(channel):
    raise NotImplementedError(_MSG)


class Select(object):
    """The CSP select block: raises the same curated error."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_MSG)
