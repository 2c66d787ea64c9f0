"""Book chapter 02: recognize_digits (MNIST).

Parity: python/paddle/fluid/tests/book/test_recognize_digits.py and the
JAX package's models/recognize_digits.py, unchanged in content: the three
network bodies (softmax regression, a multilayer perceptron and the
LeNet-5-style conv-pool net) and the same train program (cross_entropy,
mean, accuracy, Adam).
"""
import paddle_tpu_torch as fluid


def softmax_regression(img):
    return fluid.layers.fc(input=img, size=10, act="softmax")


def multilayer_perceptron(img):
    hidden = fluid.layers.fc(input=img, size=128, act="relu")
    hidden = fluid.layers.fc(input=hidden, size=64, act="relu")
    return fluid.layers.fc(input=hidden, size=10, act="softmax")


def convolutional_neural_network(img):
    conv_pool_1 = fluid.nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_2 = fluid.nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    return fluid.layers.fc(input=conv_pool_2, size=10, act="softmax")


def build(nn_type="conv", with_optimizer=True, learning_rate=0.001):
    """Build the train graph into the current default programs.

    Returns (img, label, avg_loss, acc).
    """
    img = fluid.layers.data(name="img", shape=[1, 28, 28], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    if nn_type == "conv":
        prediction = convolutional_neural_network(img)
    elif nn_type == "mlp":
        prediction = multilayer_perceptron(img)
    else:
        prediction = softmax_regression(img)
    loss = fluid.layers.cross_entropy(input=prediction, label=label)
    avg_loss = fluid.layers.mean(x=loss)
    acc = fluid.layers.accuracy(input=prediction, label=label)
    if with_optimizer:
        optimizer = fluid.optimizer.Adam(learning_rate=learning_rate)
        optimizer.minimize(avg_loss)
    return img, label, avg_loss, acc
