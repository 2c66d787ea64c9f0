"""IMDB movie-review sentiment.

Parity: python/paddle/v2/dataset/imdb.py — build_dict, word_dict,
train(word_idx)/test(word_idx) yield (word-id sequence, 0/1 label). The
real `aclImdb_v1.tar.gz` under DATA_HOME/imdb is read when present
(reference tokenize(): tar members matched by train/pos etc., lowercased,
punctuation stripped); synthetic fallback: two sentiment-biased unigram
distributions over the vocabulary, so an LSTM/conv classifier genuinely
separates them.
"""
import collections
import os
import re
import string
import tarfile

import numpy as np

from . import common

__all__ = ["build_dict", "word_dict", "train", "test", "convert"]

_VOCAB = 5148  # matches the book chapter's cutoff-150 dict size era
_TRAIN_N, _TEST_N = common.synthetic_size(600, 200)
_TAR = "aclImdb_v1.tar.gz"


def _tokenize(pattern):
    """Yield token lists for tar members matching `pattern` (reference
    imdb.py tokenize: lowercase, strip punctuation, split)."""
    path = os.path.join(common.DATA_HOME, "imdb", _TAR)
    trans = str.maketrans("", "", string.punctuation)
    with tarfile.open(path) as tar:
        for m in tar.getmembers():
            if bool(pattern.match(m.name)):
                doc = tar.extractfile(m).read().decode("latin-1")
                yield doc.lower().translate(trans).split()


def build_dict(pattern=None, cutoff=150):
    """Vocabulary dict word -> id; ids are frequency-ranked (ties broken
    alphabetically), strict `> cutoff` pruning, '<unk>' last — exactly the
    reference build_dict (imdb.py:85), defaulting to the labeled
    train+test corpus the reference book's word_dict used."""
    if common.have_real_data("imdb", _TAR):
        pattern = pattern or re.compile(
            r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$")
        if isinstance(pattern, str):
            pattern = re.compile(pattern)
        counts = collections.Counter()
        for words in _tokenize(pattern):
            counts.update(words)
        kept = sorted(((w, c) for w, c in counts.items() if c > cutoff),
                      key=lambda x: (-x[1], x[0]))
        d = {w: i for i, (w, c) in enumerate(kept)}
        d["<unk>"] = len(d)
        return d
    d = common.word_dict(_VOCAB - 1)
    d["<unk>"] = len(d)
    return d


def word_dict():
    return build_dict()


def _reader_creator(split_name, n, word_idx):
    vocab = len(word_idx)

    if common.have_real_data("imdb", _TAR):
        unk = word_idx["<unk>"]
        # one tar pass for both labels, docs cached like the reference's
        # INS list (reference reader_creator loads at creation time)
        pos_pat = re.compile(r"aclImdb/%s/pos/.*\.txt$" % split_name)
        neg_pat = re.compile(r"aclImdb/%s/neg/.*\.txt$" % split_name)
        both = re.compile(r"aclImdb/%s/((pos)|(neg))/.*\.txt$" % split_name)
        path = os.path.join(common.DATA_HOME, "imdb", _TAR)
        pos_docs, neg_docs = [], []
        with tarfile.open(path) as tar:
            trans = str.maketrans("", "", string.punctuation)
            for m in tar.getmembers():
                if not both.match(m.name):
                    continue
                doc = tar.extractfile(m).read().decode("latin-1")
                ids = [word_idx.get(w, unk)
                       for w in doc.lower().translate(trans).split()]
                (pos_docs if pos_pat.match(m.name) else neg_docs).append(ids)
        ins = [(d, 0) for d in pos_docs] + [(d, 1) for d in neg_docs]

        def real_reader():
            # reference order: all pos docs (label 0) then all neg (label 1)
            for doc, label in ins:
                yield doc, label
        return real_reader

    def reader():
        rng = common.synthetic_rng("imdb", split_name)
        # positive reviews draw from the front of the vocab, negative from
        # the back; overlap keeps the task non-trivial
        for i in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(8, 64))
            if label:
                ids = rng.randint(0, int(vocab * 0.6), length)
            else:
                ids = rng.randint(int(vocab * 0.4), vocab, length)
            yield ids.astype(np.int64).tolist(), label
    return reader


def train(word_idx):
    return _reader_creator("train", _TRAIN_N, word_idx)


def test(word_idx):
    return _reader_creator("test", _TEST_N, word_idx)


def convert(path):
    w = word_dict()
    common.convert(path, train(w), 1000, "imdb_train")
    common.convert(path, test(w), 1000, "imdb_test")
