"""PASCAL VOC2012 segmentation.

Parity: python/paddle/v2/dataset/voc2012.py — train()/test()/val() yield
(image float32[3,H,W], segmentation mask int32[H,W] with 21 classes).
Synthetic fallback: random rectangles of uniform class over a background.
"""
import numpy as np

from . import common

__all__ = ["train", "test", "val"]

_CLASSES = 21
_H = _W = 64  # synthetic resolution (real data varies per image)
_TRAIN_N, _TEST_N = common.synthetic_size(48, 12)


def _creator(split_name, n):
    def reader():
        rng = common.synthetic_rng("voc2012", split_name)
        for _ in range(n):
            img = rng.rand(3, _H, _W).astype(np.float32)
            mask = np.zeros((_H, _W), dtype=np.int32)
            for _ in range(int(rng.randint(1, 4))):
                c = int(rng.randint(1, _CLASSES))
                y0, x0 = rng.randint(0, _H // 2), rng.randint(0, _W // 2)
                h, w = rng.randint(8, _H // 2), rng.randint(8, _W // 2)
                mask[y0:y0 + h, x0:x0 + w] = c
                img[:, y0:y0 + h, x0:x0 + w] += c / float(_CLASSES)
            yield np.clip(img, 0, 1.5), mask
    return reader


def train():
    return _creator("train", _TRAIN_N)


def test():
    return _creator("test", _TEST_N)


def val():
    return _creator("val", _TEST_N)
