"""CoNLL-2005 semantic role labeling.

Parity: python/paddle/v2/dataset/conll05.py — get_dict() returns
(word_dict, verb_dict, label_dict); test() yields 9 aligned sequences:
(word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred_ids, mark, labels)
where ctx_* are the predicate-window words broadcast over the sentence and
mark flags the predicate span. Synthetic fallback keeps exactly that record
shape with a learnable word→label correlation.
"""
import numpy as np

from . import common

__all__ = ["get_dict", "get_embedding", "test", "convert"]

_WORD_VOCAB = 4000
_VERB_VOCAB = 300
_NUM_LABELS = 59  # BIO tags over 29 roles, reference label_dict size era
_TEST_N = common.synthetic_size(200, 200)[1]


def get_dict():
    word_dict = common.word_dict(_WORD_VOCAB)
    verb_dict = common.word_dict(_VERB_VOCAB)
    label_dict = {"label%d" % i: i for i in range(_NUM_LABELS)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    """Pretrained word embeddings (reference: emb file). Synthetic:
    deterministic gaussian table [word_vocab, 32]."""
    rng = common.synthetic_rng("conll05", "embedding")
    return rng.randn(_WORD_VOCAB, 32).astype(np.float32)


def _reader_creator(split_name, n):
    def reader():
        lab_rng = common.synthetic_rng("conll05", "labelmap")
        word2label = lab_rng.randint(0, _NUM_LABELS, _WORD_VOCAB)
        rng = common.synthetic_rng("conll05", split_name)
        for _ in range(n):
            length = int(rng.randint(5, 30))
            words = rng.randint(0, _WORD_VOCAB, length).astype(np.int64)
            pred_pos = int(rng.randint(0, length))
            verb = int(rng.randint(0, _VERB_VOCAB))

            def ctx(offset):
                i = min(max(pred_pos + offset, 0), length - 1)
                return np.full(length, words[i], dtype=np.int64)

            mark = np.zeros(length, dtype=np.int64)
            mark[pred_pos] = 1
            labels = word2label[words].astype(np.int64)
            yield (words.tolist(), ctx(-2).tolist(), ctx(-1).tolist(),
                   ctx(0).tolist(), ctx(1).tolist(), ctx(2).tolist(),
                   [verb] * length, mark.tolist(), labels.tolist())
    return reader


def test():
    return _reader_creator("test", _TEST_N)


def train():
    """Synthetic extension: the reference ships only test() publicly (the
    train corpus is licensed); our synthetic fallback can provide both."""
    return _reader_creator("train", _TEST_N * 4)


def convert(path):
    common.convert(path, test(), 1000, "conll05_test")
