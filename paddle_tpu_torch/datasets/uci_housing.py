"""UCI housing regression dataset (506 samples, 13 features).

Parity: python/paddle/v2/dataset/uci_housing.py — train()/test() yield
(feature_vector[13] float32, [price] float32), features min-max normalized
like the reference's feature_range scaling. Real `housing.data` under
DATA_HOME/uci_housing is used when present (whitespace table, 14 columns,
80/20 split like the reference); otherwise a fixed random linear model +
noise, so fit_a_line genuinely converges on it.
"""
import os

import numpy as np

from . import common

__all__ = ["train", "test", "feature_num", "convert"]

feature_num = 13
_TRAIN_N, _TEST_N = 404, 102  # the real 80/20 split of 506


def _load_real():
    """Parse housing.data (whitespace floats, 14 cols) and normalize each
    feature as (x - mean) / (max - min) — reference uci_housing.py:67-71
    (load_data loop); the label column stays raw."""
    path = os.path.join(common.DATA_HOME, "uci_housing", "housing.data")
    data = np.loadtxt(path, dtype=np.float32).reshape(-1, feature_num + 1)
    feats = data[:, :feature_num]
    lo, hi = feats.min(axis=0), feats.max(axis=0)
    avg = feats.mean(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    data[:, :feature_num] = (feats - avg) / span
    n_train = int(len(data) * 0.8)
    return data[:n_train], data[n_train:]


def _make(split_name, n):
    rng = common.synthetic_rng("uci_housing", "model")  # shared true model
    w = rng.randn(feature_num).astype(np.float32)
    b = np.float32(rng.randn() * 2)
    rng = common.synthetic_rng("uci_housing", split_name)
    xs = rng.randn(n, feature_num).astype(np.float32)
    ys = xs @ w + b + rng.randn(n).astype(np.float32) * 0.1
    return xs, ys.astype(np.float32)


def _reader_creator(split_name, n):
    # creator-time decision + parse (like the sibling loaders and the
    # reference's load_data): epochs re-yield from memory, not the file
    if common.have_real_data("uci_housing", "housing.data"):
        tr, te = _load_real()
        rows = tr if split_name == "train" else te

        def real_reader():
            for row in rows:
                yield row[:feature_num], row[feature_num:]
        return real_reader

    def reader():
        xs, ys = _make(split_name, n)
        for x, y in zip(xs, ys):
            yield x, np.array([y], dtype=np.float32)
    return reader


def train():
    return _reader_creator("train", _TRAIN_N)


def test():
    return _reader_creator("test", _TEST_N)


def convert(path):
    common.convert(path, train(), 1000, "uci_housing_train")
    common.convert(path, test(), 1000, "uci_housing_test")
