"""Image classification: ResNet for ImageNet and CIFAR-10.

Parity: benchmark/paddle/image/resnet.py, the fluid book chapter 03
(image_classification) and the JAX package's
models/image_classification.py, whose ResNet functions and build_train
these are, unchanged in content. ResNet-50 trained with Momentum is the
JAX package's benchmark model. Its vgg16, alexnet, googlenet and
se_resnext need the dropout, lrn and concat layers, which are not ported
yet: build_train raises for them.
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


_NOT_PORTED = dict.fromkeys(("vgg16", "alexnet", "googlenet", "se_resnext"),
                            "the dropout layer (ROADMAP A3)")


def build_train(model="resnet50", class_dim=1000, image_shape=(3, 224, 224),
                learning_rate=0.01, momentum=0.9, is_test=False,
                use_bf16=False, uint8_input=False):
    """Build the full training graph (benchmark/fluid style) into the
    current default programs: the image (float32, or with uint8_input raw
    uint8 pixels cast and scaled by 1/255 in the program) and label
    feeds, the model (resnetN: resnet_cifar10 when the image's last side
    is at most 64, resnet_imagenet otherwise), cross_entropy, mean,
    accuracy and, unless is_test, Momentum. use_bf16 turns on mixed
    precision for the main program (Program.enable_mixed_precision).

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
    else:
        family = "se_resnext" if model.startswith("se_resnext") else model
        if family not in _NOT_PORTED:
            raise ValueError("unknown model %r" % model)
        raise NotImplementedError(
            "%s is not ported yet: it needs %s" % (model, _NOT_PORTED[family]))
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(x=cost)
    acc = fluid.layers.accuracy(input=predict, label=label)
    if not is_test:
        opt = fluid.optimizer.Momentum(learning_rate=learning_rate,
                                       momentum=momentum)
        opt.minimize(avg_cost)
    return image, label, avg_cost, acc
