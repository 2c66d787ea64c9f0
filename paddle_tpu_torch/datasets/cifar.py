"""CIFAR-10 / CIFAR-100.

Parity: python/paddle/v2/dataset/cifar.py — train10/test10/train100/test100
yield (float32[3072] in [0,1], int label). The real
`cifar-10-python.tar.gz` / `cifar-100-python.tar.gz` under DATA_HOME/cifar
is read when present (pickle batch members, exactly the reference's
tarfile walk); synthetic fallback: per-class color-texture templates +
noise (CHW layout like the real pickles).
"""
import os
import pickle
import tarfile

import numpy as np

from . import common

__all__ = ["train10", "test10", "train100", "test100", "convert"]

_TRAIN_N, _TEST_N = common.synthetic_size(1024, 256)
_TARS = {10: "cifar-10-python.tar.gz", 100: "cifar-100-python.tar.gz"}


def _real_reader(split_name, num_classes):
    """Yield from the pickle batches inside the official tar (reference
    cifar.py reader_creator: members filtered by sub_name)."""
    sub_name = ("train" if num_classes == 100 else "data_batch") \
        if split_name == "train" else "test"
    label_key = b"fine_labels" if num_classes == 100 else b"labels"
    path = os.path.join(common.DATA_HOME, "cifar", _TARS[num_classes])

    def reader():
        with tarfile.open(path, mode="r") as tar:
            names = [m for m in tar.getmembers() if sub_name in m.name]
            for m in names:
                batch = pickle.load(tar.extractfile(m), encoding="bytes")
                for img, lab in zip(batch[b"data"], batch[label_key]):
                    yield img.astype(np.float32) / 255.0, int(lab)
    return reader


def _reader_creator(split_name, n, num_classes):
    tag = "cifar%d" % num_classes
    if common.have_real_data("cifar", _TARS[num_classes]):
        return _real_reader(split_name, num_classes)

    def reader():
        tmpl_rng = common.synthetic_rng(tag, "templates")
        templates = tmpl_rng.rand(num_classes, 3072).astype(np.float32)
        rng = common.synthetic_rng(tag, split_name)
        labels = rng.randint(0, num_classes, n)
        for lab in labels:
            img = templates[lab] + rng.randn(3072).astype(np.float32) * 0.25
            yield np.clip(img, 0.0, 1.0), int(lab)
    return reader


def train10():
    return _reader_creator("train", _TRAIN_N, 10)


def test10():
    return _reader_creator("test", _TEST_N, 10)


def train100():
    return _reader_creator("train", _TRAIN_N, 100)


def test100():
    return _reader_creator("test", _TEST_N, 100)


def convert(path):
    common.convert(path, train10(), 1000, "cifar_train10")
    common.convert(path, test10(), 1000, "cifar_test10")
