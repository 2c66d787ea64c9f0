"""MQ2007 learning-to-rank dataset.

Parity: python/paddle/v2/dataset/mq2007.py — train/test with format
'pointwise' ((relevance, feature[46])), 'pairwise' ((label, d_high, d_low)),
'listwise' ((relevance_list, feature_list)). Synthetic fallback: a hidden
linear relevance model over 46 features.
"""
import numpy as np

from . import common

__all__ = ["train", "test", "fetch"]

FEATURE_DIM = 46
_TRAIN_Q, _TEST_Q = common.synthetic_size(120, 30)
_DOCS_PER_QUERY = 8


def _queries(split_name, nq):
    model_rng = common.synthetic_rng("mq2007", "model")
    w = model_rng.randn(FEATURE_DIM).astype(np.float32)
    rng = common.synthetic_rng("mq2007", split_name)
    for qid in range(nq):
        feats = rng.randn(_DOCS_PER_QUERY, FEATURE_DIM).astype(np.float32)
        scores = feats @ w + rng.randn(_DOCS_PER_QUERY) * 0.1
        # bucket into relevance 0..2
        rel = np.digitize(scores, np.percentile(scores, [50, 80]))
        yield qid, rel.astype(np.int64), feats


def _reader_creator(split_name, nq, format):
    def pointwise():
        for qid, rel, feats in _queries(split_name, nq):
            for r, f in zip(rel, feats):
                yield int(r), f

    def pairwise():
        rng = common.synthetic_rng("mq2007", split_name + "_pairs")
        for qid, rel, feats in _queries(split_name, nq):
            for i in range(len(rel)):
                for j in range(len(rel)):
                    if rel[i] > rel[j]:
                        yield np.array([1.0], dtype=np.float32), \
                            feats[i], feats[j]

    def listwise():
        for qid, rel, feats in _queries(split_name, nq):
            yield rel.astype(np.float32), feats

    return {"pointwise": pointwise, "pairwise": pairwise,
            "listwise": listwise}[format]


def train(format="pairwise"):
    return _reader_creator("train", _TRAIN_Q, format)


def test(format="pairwise"):
    return _reader_creator("test", _TEST_Q, format)


def fetch():
    raise IOError("zero-egress build: place MQ2007 files under DATA_HOME")
