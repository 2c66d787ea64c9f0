"""Image classification: ResNet, VGG-16, AlexNet, GoogLeNet and
SE-ResNeXt.

Parity: benchmark/paddle/image/{resnet.py,vgg.py,alexnet.py,googlenet.py},
the fluid benchmark's models/se_resnext.py, the fluid book chapter 03
(image_classification) and the JAX package's
models/image_classification.py, whose functions and build_train these
are, unchanged in content, so both packages build the same Program.
ResNet-50 trained with Momentum is the JAX package's benchmark model. The
nets' conv2d, pool2d, batch_norm, lrn and concat are plain torch rules
(cuDNN on the card): the JAX package wrote no Pallas kernel for them.
Their dropout layers take is_test from the caller, and clone(for_test=True)
and save_inference_model set it, so an inference program scales by
1 - dropout_prob.
"""
import paddle_tpu_torch as fluid


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, is_test=False):
    conv = fluid.layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=(filter_size - 1) // 2, groups=groups,
        act=None, bias_attr=False)
    return fluid.layers.batch_norm(input=conv, act=act, is_test=is_test)


def shortcut(input, ch_out, stride, is_test=False):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, is_test=is_test)
    return input


def bottleneck_block(input, num_filters, stride, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu", is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride, act="relu",
                          is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, act=None,
                          is_test=is_test)
    short = shortcut(input, num_filters * 4, stride, is_test=is_test)
    return fluid.layers.elementwise_add(x=short, y=conv2, act="relu")


def basic_block(input, num_filters, stride, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 3, stride=stride, act="relu",
                          is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, act=None, is_test=is_test)
    short = shortcut(input, num_filters, stride, is_test=is_test)
    return fluid.layers.elementwise_add(x=short, y=conv1, act="relu")


RESNET_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False):
    """ResNet for 224x224 ImageNet (benchmark resnet.py, layers=50)."""
    kind, counts = RESNET_CFG[depth]
    block_fn = bottleneck_block if kind == "bottleneck" else basic_block
    conv = conv_bn_layer(input, 64, 7, stride=2, act="relu", is_test=is_test)
    pool = fluid.layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                               pool_padding=1, pool_type="max")
    filters = [64, 128, 256, 512]
    for stage, n in enumerate(counts):
        for i in range(n):
            stride = 2 if i == 0 and stage > 0 else 1
            pool = block_fn(pool, filters[stage], stride, is_test=is_test)
    pool = fluid.layers.pool2d(input=pool, pool_type="avg",
                               global_pooling=True)
    return fluid.layers.fc(input=pool, size=class_dim, act="softmax")


def resnet_cifar10(input, class_dim=10, depth=32, is_test=False):
    """The fluid book chapter 03's resnet_cifar10."""
    if (depth - 2) % 6 != 0:
        raise ValueError("resnet_cifar10 depth must be 6n + 2, got %d"
                         % depth)
    n = (depth - 2) // 6
    conv = conv_bn_layer(input, 16, 3, act="relu", is_test=is_test)
    for stage, nf in enumerate([16, 32, 64]):
        for i in range(n):
            stride = 2 if i == 0 and stage > 0 else 1
            conv = basic_block(conv, nf, stride, is_test=is_test)
    pool = fluid.layers.pool2d(input=conv, pool_type="avg",
                               global_pooling=True)
    return fluid.layers.fc(input=pool, size=class_dim, act="softmax")


def vgg16(input, class_dim=1000, is_test=False):
    """benchmark vgg.py / the book chapter 03's vgg_bn_drop."""
    def conv_block(ipt, num_filter, groups):
        return fluid.nets.img_conv_group(
            input=ipt, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True, pool_type="max")

    conv1 = conv_block(input, 64, 2)
    conv2 = conv_block(conv1, 128, 2)
    conv3 = conv_block(conv2, 256, 3)
    conv4 = conv_block(conv3, 512, 3)
    conv5 = conv_block(conv4, 512, 3)
    fc1 = fluid.layers.fc(input=conv5, size=4096, act=None)
    bn = fluid.layers.batch_norm(input=fc1, act="relu", is_test=is_test)
    drop = fluid.layers.dropout(x=bn, dropout_prob=0.5, is_test=is_test)
    fc2 = fluid.layers.fc(input=drop, size=4096, act=None)
    return fluid.layers.fc(input=fc2, size=class_dim, act="softmax")


def build_train(model="resnet50", class_dim=1000, image_shape=(3, 224, 224),
                learning_rate=0.01, momentum=0.9, is_test=False,
                use_softmax_xent_fusion=True, use_bf16=False,
                uint8_input=False):
    """Build the full training graph (benchmark/fluid style) into the
    current default programs: the image (float32, or with uint8_input raw
    uint8 pixels cast and scaled by 1/255 in the program) and label
    feeds, the model (resnetN: resnet_cifar10 when the image's last side
    is at most 64, resnet_imagenet otherwise; vgg16, alexnet, googlenet,
    se_resnext50 / 101 / 152), cross_entropy, mean, accuracy and, unless
    is_test, Momentum. use_bf16 turns on mixed precision for the main
    program (Program.enable_mixed_precision). use_softmax_xent_fusion is
    the JAX signature's, which reads it no more than this one does: the
    models end in softmax + cross_entropy either way.

    Returns (image, label, avg_cost, acc_top1).
    """
    if use_bf16:
        fluid.default_main_program().enable_mixed_precision()
    if uint8_input:
        raw = fluid.layers.data(name="image", shape=list(image_shape),
                                dtype="uint8")
        image = fluid.layers.scale(
            fluid.layers.cast(raw, dtype="float32"), scale=1.0 / 255.0)
    else:
        image = fluid.layers.data(name="image", shape=list(image_shape),
                                  dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    if model.startswith("resnet"):
        depth = int(model[len("resnet"):] or 50)
        if image_shape[-1] <= 64:
            predict = resnet_cifar10(image, class_dim,
                                     depth if depth in (20, 32, 44, 56) else 32,
                                     is_test=is_test)
        else:
            predict = resnet_imagenet(image, class_dim, depth,
                                      is_test=is_test)
    elif model == "vgg16":
        predict = vgg16(image, class_dim, is_test=is_test)
    elif model == "alexnet":
        predict = alexnet(image, class_dim, is_test=is_test)
    elif model == "googlenet":
        predict = googlenet(image, class_dim, is_test=is_test)
    elif model.startswith("se_resnext"):
        suffix = model[len("se_resnext"):] or "50"
        if suffix not in ("50", "101", "152"):
            raise ValueError("unknown model %r" % model)
        predict = se_resnext(image, class_dim, int(suffix), is_test=is_test)
    else:
        raise ValueError("unknown model %r" % model)
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(x=cost)
    acc = fluid.layers.accuracy(input=predict, label=label)
    if not is_test:
        opt = fluid.optimizer.Momentum(learning_rate=learning_rate,
                                       momentum=momentum)
        opt.minimize(avg_cost)
    return image, label, avg_cost, acc


def alexnet(input, class_dim=1000, is_test=False):
    """benchmark/paddle/image/alexnet.py (the legacy v2 benchmark)."""
    conv1 = fluid.layers.conv2d(input=input, num_filters=96, filter_size=11,
                                stride=4, act="relu")
    pool1 = fluid.layers.pool2d(input=conv1, pool_size=3, pool_stride=2,
                                pool_type="max")
    norm1 = fluid.layers.lrn(input=pool1, n=5, alpha=0.0001, beta=0.75)
    conv2 = fluid.layers.conv2d(input=norm1, num_filters=256, filter_size=5,
                                padding=2, groups=1, act="relu")
    pool2 = fluid.layers.pool2d(input=conv2, pool_size=3, pool_stride=2,
                                pool_type="max")
    norm2 = fluid.layers.lrn(input=pool2, n=5, alpha=0.0001, beta=0.75)
    conv3 = fluid.layers.conv2d(input=norm2, num_filters=384, filter_size=3,
                                padding=1, act="relu")
    conv4 = fluid.layers.conv2d(input=conv3, num_filters=384, filter_size=3,
                                padding=1, act="relu")
    conv5 = fluid.layers.conv2d(input=conv4, num_filters=256, filter_size=3,
                                padding=1, act="relu")
    pool3 = fluid.layers.pool2d(input=conv5, pool_size=3, pool_stride=2,
                                pool_type="max")
    fc1 = fluid.layers.fc(input=pool3, size=4096, act="relu")
    drop1 = fluid.layers.dropout(x=fc1, dropout_prob=0.5, is_test=is_test)
    fc2 = fluid.layers.fc(input=drop1, size=4096, act="relu")
    drop2 = fluid.layers.dropout(x=fc2, dropout_prob=0.5, is_test=is_test)
    return fluid.layers.fc(input=drop2, size=class_dim, act="softmax")


def _inception(input, c1, c3r, c3, c5r, c5, proj):
    """GoogLeNet's inception module (benchmark/paddle/image/googlenet.py)."""
    b1 = fluid.layers.conv2d(input=input, num_filters=c1, filter_size=1,
                             act="relu")
    b3 = fluid.layers.conv2d(input=input, num_filters=c3r, filter_size=1,
                             act="relu")
    b3 = fluid.layers.conv2d(input=b3, num_filters=c3, filter_size=3,
                             padding=1, act="relu")
    b5 = fluid.layers.conv2d(input=input, num_filters=c5r, filter_size=1,
                             act="relu")
    b5 = fluid.layers.conv2d(input=b5, num_filters=c5, filter_size=5,
                             padding=2, act="relu")
    bp = fluid.layers.pool2d(input=input, pool_size=3, pool_stride=1,
                             pool_padding=1, pool_type="max")
    bp = fluid.layers.conv2d(input=bp, num_filters=proj, filter_size=1,
                             act="relu")
    return fluid.layers.concat(input=[b1, b3, b5, bp], axis=1)


def googlenet(input, class_dim=1000, is_test=False):
    """benchmark/paddle/image/googlenet.py's main tower (the two auxiliary
    classifier heads, a training-era regularizer, are left out as the
    fluid benchmark leaves them out)."""
    conv = fluid.layers.conv2d(input=input, num_filters=64, filter_size=7,
                               stride=2, padding=3, act="relu")
    pool = fluid.layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                               pool_type="max")
    conv = fluid.layers.conv2d(input=pool, num_filters=64, filter_size=1,
                               act="relu")
    conv = fluid.layers.conv2d(input=conv, num_filters=192, filter_size=3,
                               padding=1, act="relu")
    pool = fluid.layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                               pool_type="max")
    ince = _inception(pool, 64, 96, 128, 16, 32, 32)        # 3a
    ince = _inception(ince, 128, 128, 192, 32, 96, 64)      # 3b
    pool = fluid.layers.pool2d(input=ince, pool_size=3, pool_stride=2,
                               pool_type="max")
    ince = _inception(pool, 192, 96, 208, 16, 48, 64)       # 4a
    ince = _inception(ince, 160, 112, 224, 24, 64, 64)      # 4b
    ince = _inception(ince, 128, 128, 256, 24, 64, 64)      # 4c
    ince = _inception(ince, 112, 144, 288, 32, 64, 64)      # 4d
    ince = _inception(ince, 256, 160, 320, 32, 128, 128)    # 4e
    pool = fluid.layers.pool2d(input=ince, pool_size=3, pool_stride=2,
                               pool_type="max")
    ince = _inception(pool, 256, 160, 320, 32, 128, 128)    # 5a
    ince = _inception(ince, 384, 192, 384, 48, 128, 128)    # 5b
    pool = fluid.layers.pool2d(input=ince, pool_type="avg",
                               global_pooling=True)
    drop = fluid.layers.dropout(x=pool, dropout_prob=0.4, is_test=is_test)
    return fluid.layers.fc(input=drop, size=class_dim, act="softmax")


def squeeze_excitation(input, num_channels, reduction_ratio=16):
    pool = fluid.layers.pool2d(input=input, pool_type="avg",
                               global_pooling=True)
    squeeze = fluid.layers.fc(input=pool,
                              size=num_channels // reduction_ratio,
                              act="relu")
    excitation = fluid.layers.fc(input=squeeze, size=num_channels,
                                 act="sigmoid")
    return fluid.layers.elementwise_mul(x=input, y=excitation, axis=0)


def se_bottleneck_block(input, num_filters, stride, cardinality=32,
                        reduction_ratio=16, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu", is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          groups=cardinality, act="relu", is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None,
                          is_test=is_test)
    scale = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = shortcut(input, num_filters * 2, stride, is_test=is_test)
    return fluid.layers.elementwise_add(x=short, y=scale, act="relu")


def se_resnext(input, class_dim=1000, depth=50, cardinality=32,
               reduction_ratio=16, is_test=False):
    """SE-ResNeXt-50 / 101 / 152 (the fluid benchmark's
    models/se_resnext.py)."""
    counts = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
    conv = conv_bn_layer(input, 64, 7, stride=2, act="relu", is_test=is_test)
    pool = fluid.layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                               pool_padding=1, pool_type="max")
    filters = [128, 256, 512, 1024]
    for stage, n in enumerate(counts):
        for i in range(n):
            stride = 2 if i == 0 and stage > 0 else 1
            pool = se_bottleneck_block(
                pool, filters[stage], stride, cardinality, reduction_ratio,
                is_test=is_test)
    pool = fluid.layers.pool2d(input=pool, pool_type="avg",
                               global_pooling=True)
    drop = fluid.layers.dropout(x=pool, dropout_prob=0.5, is_test=is_test)
    return fluid.layers.fc(input=drop, size=class_dim, act="softmax")
