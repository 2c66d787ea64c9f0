"""imikolov (PTB-style) language-model dataset.

Parity: python/paddle/v2/dataset/imikolov.py — build_dict, train/test with
DataType.NGRAM ((w0..wn-1) tuples) or DataType.SEQ ((src, trg) shifted
sequences). Real `ptb.train.txt` / `ptb.valid.txt` under DATA_HOME/imikolov
are read when present (one sentence per line, the Mikolov simple-examples
layout); synthetic fallback: a fixed random bigram chain, so N-gram and
RNN LMs genuinely reduce perplexity.
"""
import collections
import os

import numpy as np

from . import common

__all__ = ["build_dict", "train", "test", "DataType", "convert"]

_TRAIN_N, _TEST_N = common.synthetic_size(800, 200)
_FILES = {"train": "ptb.train.txt", "test": "ptb.valid.txt"}


class DataType(object):
    NGRAM = 1
    SEQ = 2


def _real_lines(split_name):
    path = os.path.join(common.DATA_HOME, "imikolov", _FILES[split_name])
    with open(path) as f:
        for line in f:
            words = line.strip().split()
            if words:
                yield words


def build_dict(min_word_freq=50):
    """word -> id, reference imikolov.py:49 exactly: counts over
    train+valid with '<s>'/'<e>' counted once PER SENTENCE, '<unk>'
    removed then re-added last, strict `> min_word_freq` pruning,
    frequency-ranked ids (ties alphabetical)."""
    if common.have_real_data("imikolov", _FILES["train"]):
        counts = collections.Counter()
        for split in ("train", "test"):
            if not common.have_real_data("imikolov", _FILES[split]):
                continue
            for words in _real_lines(split):
                counts.update(words)
                counts.update(("<s>", "<e>"))
        counts.pop("<unk>", None)
        kept = sorted(
            ((w, c) for w, c in counts.items() if c > min_word_freq),
            key=lambda x: (-x[1], x[0]))
        d = {w: i for i, (w, c) in enumerate(kept)}
        d["<unk>"] = len(d)
        for extra in ("<s>", "<e>"):  # tiny corpora can prune them
            d.setdefault(extra, len(d))
        return d
    d = common.word_dict(2072, extra=("<s>", "<e>", "<unk>"))
    return d


def _sentences(split_name, n, vocab):
    """Markov-chain sentences: next word depends on current (learnable)."""
    chain_rng = common.synthetic_rng("imikolov", "chain")
    # each word has a small successor set
    succ = chain_rng.randint(3, vocab, size=(vocab, 4))
    rng = common.synthetic_rng("imikolov", split_name)
    for _ in range(n):
        length = int(rng.randint(5, 20))
        w = int(rng.randint(3, vocab))
        sent = [w]
        for _ in range(length - 1):
            w = int(succ[w, rng.randint(0, 4)])
            sent.append(w)
        yield sent


def _reader_creator(split_name, n, word_idx, ngram_n, data_type):
    vocab = len(word_idx)
    # real mode requires the TRAIN file (the vocabulary source): a stray
    # valid-only DATA_HOME must not mix a synthetic vocab with real text
    real = common.have_real_data("imikolov", _FILES["train"]) and \
        common.have_real_data("imikolov", _FILES[split_name])

    def sentences():
        if real:
            unk = word_idx["<unk>"]
            for words in _real_lines(split_name):
                yield [word_idx.get(w, unk) for w in words]
        else:
            for sent in _sentences(split_name, n, vocab):
                yield sent

    def reader():
        start, end = word_idx["<s>"], word_idx["<e>"]
        for sent in sentences():
            if data_type == DataType.NGRAM:
                s = [start] + sent + [end]
                if len(s) >= ngram_n:
                    s = np.asarray(s, dtype=np.int64)
                    for i in range(ngram_n, len(s) + 1):
                        yield tuple(s[i - ngram_n:i])
            elif data_type == DataType.SEQ:
                s = [start] + sent + [end]
                # reference: n bounds the src length for SEQ readers
                # (imikolov.py reader_creator: skip if len(src) > n > 0)
                if ngram_n > 0 and len(s) - 1 > ngram_n:
                    continue
                yield s[:-1], s[1:]
            else:
                raise ValueError("Unknown data type %r" % data_type)
    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    return _reader_creator("train", _TRAIN_N, word_idx, n, data_type)


def test(word_idx, n, data_type=DataType.NGRAM):
    return _reader_creator("test", _TEST_N, word_idx, n, data_type)


def convert(path):
    w = build_dict()
    common.convert(path, train(w, 5), 1000, "imikolov_train")
    common.convert(path, test(w, 5), 1000, "imikolov_test")
