"""NLTK movie-reviews sentiment corpus.

Parity: python/paddle/v2/dataset/sentiment.py — get_word_dict(),
train()/test() yield (word-id sequence, 0/1). Synthetic fallback mirrors
imdb's generator with this corpus's vocab size.
"""
from . import common
from . import imdb as _imdb

__all__ = ["train", "test", "get_word_dict", "NUM_TRAINING_INSTANCES",
           "NUM_TOTAL_INSTANCES"]

_VOCAB = 2048
NUM_TOTAL_INSTANCES = 2000
NUM_TRAINING_INSTANCES = 1600


def get_word_dict():
    """Sorted-by-frequency word dict (reference builds from nltk corpus)."""
    return common.word_dict(_VOCAB)


def _creator(split_name, n):
    word_idx = get_word_dict()

    def reader():
        # same sentiment-biased generator family as imdb, distinct stream
        inner = _imdb._reader_creator("sentiment_" + split_name, n, word_idx)
        for doc, label in inner():
            yield doc, label
    return reader


def train():
    return _creator("train", NUM_TRAINING_INSTANCES)


def test():
    return _creator("test", NUM_TOTAL_INSTANCES - NUM_TRAINING_INSTANCES)
