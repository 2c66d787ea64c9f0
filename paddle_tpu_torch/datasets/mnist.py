"""MNIST digits.

Parity: python/paddle/v2/dataset/mnist.py — train()/test() yield
(image float32[784] in [-1, 1], label int). Real idx-format files under
DATA_HOME/mnist are used when present; otherwise a deterministic synthetic
set of blurred class-template digits that a LeNet genuinely learns.
"""
import gzip
import os
import struct

import numpy as np

from . import common

__all__ = ["train", "test", "convert"]

_TRAIN_N, _TEST_N = common.synthetic_size(2048, 512)
_CLASSES = 10


def _synthetic(split_name, n):
    tmpl_rng = common.synthetic_rng("mnist", "templates")
    templates = tmpl_rng.rand(_CLASSES, 784).astype(np.float32)
    rng = common.synthetic_rng("mnist", split_name)
    labels = rng.randint(0, _CLASSES, n)
    imgs = templates[labels] + rng.randn(n, 784).astype(np.float32) * 0.35
    imgs = np.clip(imgs, 0.0, 1.0) * 2.0 - 1.0  # reference scales to [-1,1]
    return imgs.astype(np.float32), labels.astype(np.int64)


def _read_idx(image_path, label_path):
    with gzip.open(label_path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int64)
    with gzip.open(image_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows * cols)
    images = images.astype(np.float32) / 255.0 * 2.0 - 1.0
    return images, labels


def _reader_creator(split_name, n, image_file, label_file):
    def reader():
        if common.have_real_data("mnist", image_file) and \
                common.have_real_data("mnist", label_file):
            imgs, labels = _read_idx(
                os.path.join(common.DATA_HOME, "mnist", image_file),
                os.path.join(common.DATA_HOME, "mnist", label_file))
        else:
            imgs, labels = _synthetic(split_name, n)
        for img, lab in zip(imgs, labels):
            yield img, int(lab)
    return reader


def train():
    return _reader_creator("train", _TRAIN_N,
                           "train-images-idx3-ubyte.gz",
                           "train-labels-idx1-ubyte.gz")


def test():
    return _reader_creator("test", _TEST_N,
                           "t10k-images-idx3-ubyte.gz",
                           "t10k-labels-idx1-ubyte.gz")


def convert(path):
    common.convert(path, train(), 1000, "mnist_train")
    common.convert(path, test(), 1000, "mnist_test")
