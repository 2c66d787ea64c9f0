"""WMT14 French→English translation.

Parity: python/paddle/v2/dataset/wmt14.py — train(dict_size)/test(dict_size)
yield (src_ids, trg_ids, trg_ids_next) where trg has <s> prepended and
trg_next is shifted by one ending in <e>; get_dict(dict_size) returns
(src_dict, trg_dict). Special ids: <s>=0, <e>=1, <unk>=2.
"""
import numpy as np

from . import common

__all__ = ["train", "test", "get_dict", "convert"]

_TRAIN_N, _TEST_N = common.synthetic_size(600, 150)


def get_dict(dict_size, reverse=True):
    d = common.word_dict(dict_size, extra=("<s>", "<e>", "<unk>"))
    src = dict(d)
    trg = dict(d)
    if reverse:
        src = {v: k for k, v in src.items()}
        trg = {v: k for k, v in trg.items()}
    return src, trg


def _reader_creator(split_name, n, dict_size, tag="wmt14"):
    def reader():
        # a fixed random word-to-word mapping: translation is learnable
        map_rng = common.synthetic_rng(tag, "mapping")
        trans = map_rng.permutation(dict_size)
        trans[:3] = [0, 1, 2]
        rng = common.synthetic_rng(tag, split_name)
        for _ in range(n):
            length = int(rng.randint(3, 12))
            src = rng.randint(3, dict_size, length).astype(np.int64)
            trg = trans[src]
            src_ids = src.tolist()
            trg_ids = [0] + trg.tolist()           # <s> + target
            trg_next = trg.tolist() + [1]          # target + <e>
            yield src_ids, trg_ids, trg_next
    return reader


def train(dict_size):
    return _reader_creator("train", _TRAIN_N, dict_size)


def test(dict_size):
    return _reader_creator("test", _TEST_N, dict_size)


def convert(path):
    common.convert(path, train(1000), 1000, "wmt14_train")
    common.convert(path, test(1000), 1000, "wmt14_test")
