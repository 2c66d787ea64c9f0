"""Composite network helpers (the subset the sentiment conv net, the
recognize_digits LeNet and the VGG-style conv groups call).

Parity: python/paddle/fluid/nets.py and the JAX package's nets.py. Its
glu and scaled_dot_product_attention are not ported yet.
"""
from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, param_attr=None,
                         pool_type="max", use_cudnn=True, use_mkldnn=False):
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             act=act, use_cudnn=use_cudnn)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         use_cudnn=use_cudnn)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True,
                   use_mkldnn=False):
    """A group of convs (each optionally followed by batch_norm, the
    activation moving after the norm) and one pool. A nonzero
    conv_batchnorm_drop_rate needs `dropout`, which is not ported."""
    if not isinstance(conv_num_filter, (list, tuple)):
        raise TypeError("conv_num_filter must be a list/tuple (one entry "
                        "per conv in the group)")
    n = len(conv_num_filter)

    def per_conv(value):
        """Broadcast a scalar argument to one value per conv."""
        return list(value) if hasattr(value, "__len__") else [value] * n

    stages = zip(conv_num_filter, per_conv(conv_filter_size),
                 per_conv(conv_padding), per_conv(param_attr),
                 per_conv(conv_with_batchnorm),
                 per_conv(conv_batchnorm_drop_rate))

    out = input
    for filters, fsize, pad, pattr, with_bn, drop in stages:
        out = layers.conv2d(input=out, num_filters=filters,
                            filter_size=fsize, padding=pad,
                            param_attr=pattr,
                            act=None if with_bn else conv_act,
                            use_cudnn=use_cudnn)
        if with_bn:
            out = layers.batch_norm(input=out, act=conv_act)
            if abs(drop) > 1e-5:
                raise NotImplementedError(
                    "img_conv_group with conv_batchnorm_drop_rate needs "
                    "the dropout layer, which is not ported yet (ROADMAP "
                    "A3)")
    return layers.pool2d(input=out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         use_cudnn=use_cudnn)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)
