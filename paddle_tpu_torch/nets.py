"""Composite network helpers: the conv-pool blocks of the sentiment conv
net, the recognize_digits LeNet and the VGG-style conv groups, glu and
scaled_dot_product_attention.

Parity: python/paddle/fluid/nets.py and the JAX package's nets.py, which
build the same ops.
"""
from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


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
    activation moving after the norm, and by dropout at a nonzero
    conv_batchnorm_drop_rate) and one pool."""
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
                out = layers.dropout(x=out, dropout_prob=drop)
    return layers.pool2d(input=out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         use_cudnn=use_cudnn)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    """The gated linear unit: input split in two along dim, a * sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(x=a, y=layers.sigmoid(x=b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """softmax(Q K^T / sqrt(d)) V over 3-D [B, T, D] q, k, v, split into
    num_heads heads first and merged back after (dense: the product and
    the softmax are plain ops, as in the JAX package)."""
    if num_heads != 1:
        def _split_heads(x):
            reshaped = layers.reshape(
                x=x, shape=[x.shape[0] if x.shape[0] > 0 else -1, x.shape[1],
                            num_heads, x.shape[2] // num_heads])
            return layers.transpose(x=reshaped, perm=[0, 2, 1, 3])
        q, k, v = map(_split_heads, (queries, keys, values))
    else:
        q, k, v = queries, keys, values
    key_dim = float(k.shape[-1])
    scaled_q = layers.scale(x=q, scale=key_dim ** -0.5)
    product = layers.matmul(x=scaled_q, y=k, transpose_y=True)
    weights = layers.reshape(
        x=layers.softmax(layers.reshape(
            x=product, shape=[-1, product.shape[-1]])),
        shape=[d if d > 0 else -1 for d in product.shape[:-1]] +
              [product.shape[-1]])
    if dropout_rate:
        weights = layers.dropout(x=weights, dropout_prob=dropout_rate)
    ctx_multiheads = layers.matmul(weights, v)
    if num_heads == 1:
        return ctx_multiheads
    t = layers.transpose(ctx_multiheads, perm=[0, 2, 1, 3])
    return layers.reshape(x=t, shape=[t.shape[0] if t.shape[0] > 0 else -1,
                                      t.shape[1],
                                      t.shape[2] * t.shape[3]])
