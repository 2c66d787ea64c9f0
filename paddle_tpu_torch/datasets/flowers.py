"""Oxford 102 Flowers.

Parity: python/paddle/v2/dataset/flowers.py — train()/test()/valid() yield
(float32[3*224*224] image in [0,1], label 0..101); mapper/use_xmap kwargs
accepted (mapper applied per sample).
"""
import numpy as np

from . import common
from .. import reader as reader_mod

__all__ = ["train", "test", "valid"]

_CLASSES = 102
_SHAPE = (3, 224, 224)
_TRAIN_N, _TEST_N = common.synthetic_size(64, 16)


def _creator(split_name, n, mapper=None, buffered_size=1024, use_xmap=False):
    def reader():
        tmpl_rng = common.synthetic_rng("flowers", "templates")
        # low-res per-class template upsampled: learnable + cheap to store
        tmpl = tmpl_rng.rand(_CLASSES, 3, 8, 8).astype(np.float32)
        rng = common.synthetic_rng("flowers", split_name)
        for _ in range(n):
            lab = int(rng.randint(0, _CLASSES))
            img = np.kron(tmpl[lab], np.ones((28, 28), dtype=np.float32))
            img = img + rng.randn(*_SHAPE).astype(np.float32) * 0.15
            sample = (np.clip(img, 0.0, 1.0).reshape(-1), lab)
            yield sample
    if mapper is None:
        return reader
    if use_xmap:
        return reader_mod.xmap_readers(mapper, reader, 2, buffered_size)
    return reader_mod.map_readers(mapper, reader)


def train(mapper=None, buffered_size=1024, use_xmap=False):
    return _creator("train", _TRAIN_N, mapper, buffered_size, use_xmap)


def test(mapper=None, buffered_size=1024, use_xmap=False):
    return _creator("test", _TEST_N, mapper, buffered_size, use_xmap)


def valid(mapper=None, buffered_size=1024, use_xmap=False):
    return _creator("valid", _TEST_N, mapper, buffered_size, use_xmap)
