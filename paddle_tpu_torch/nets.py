"""Composite network helpers (the subset the sentiment conv net calls).

Parity: python/paddle/fluid/nets.py and the JAX package's nets.py. Its
simple_img_conv_pool, img_conv_group, glu and scaled_dot_product_attention
are not ported yet.
"""
from . import layers

__all__ = ["sequence_conv_pool"]


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)
