"""WMT16 German↔English translation (BPE-era, separate vocab sizes).

Parity: python/paddle/v2/dataset/wmt16.py — train/test/validation take
(src_dict_size, trg_dict_size, src_lang) and yield (src_ids, trg_ids,
trg_ids_next); get_dict(lang, dict_size, reverse) returns the vocab.
"""
from . import common
from . import wmt14 as _w

__all__ = ["train", "test", "validation", "get_dict", "fetch", "convert"]

_TRAIN_N, _TEST_N = common.synthetic_size(600, 150)


def get_dict(lang, dict_size, reverse=False):
    d = common.word_dict(dict_size, extra=("<s>", "<e>", "<unk>"))
    if reverse:
        d = {v: k for k, v in d.items()}
    return d


def _creator(split_name, n, src_dict_size, trg_dict_size, src_lang):
    # reuse the learnable-mapping generator; vocab = min of both sizes so
    # every id is valid in either language's table
    size = min(src_dict_size, trg_dict_size)
    return _w._reader_creator(split_name, n, size, tag="wmt16_" + src_lang)


def train(src_dict_size, trg_dict_size, src_lang="en"):
    return _creator("train", _TRAIN_N, src_dict_size, trg_dict_size, src_lang)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    return _creator("test", _TEST_N, src_dict_size, trg_dict_size, src_lang)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    return _creator("val", _TEST_N, src_dict_size, trg_dict_size, src_lang)


def fetch():
    raise IOError("zero-egress build: place WMT16 files under DATA_HOME")


def convert(path, src_dict_size=1000, trg_dict_size=1000, src_lang="en"):
    common.convert(path, train(src_dict_size, trg_dict_size, src_lang),
                   1000, "wmt16_train")
