"""Dataset helpers: the data home and the deterministic synthetic data.

Parity: python/paddle/v2/dataset/common.py and a copy of the parts of the
JAX package's datasets/common.py that the port's datasets use. Nothing
here downloads: a dataset's real file is used only when it is already
under DATA_HOME.
"""
import hashlib
import os

import numpy as np

__all__ = ["DATA_HOME", "have_real_data", "synthetic_rng", "synthetic_size",
           "word_dict"]

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))


def have_real_data(module_name, filename):
    return os.path.exists(os.path.join(DATA_HOME, module_name, filename))


def synthetic_rng(module_name, split_name, salt=0):
    """Deterministic per-(dataset, split) RandomState: the same records
    every run, every process (the seed is a stable hash, not builtin
    hash())."""
    key = "%s/%s/%d" % (module_name, split_name, salt)
    seed = int(hashlib.md5(key.encode()).hexdigest()[:8], 16)
    return np.random.RandomState(seed)


def synthetic_size(default_train, default_test):
    """Synthetic dataset sizes, shrinkable for tests via the env var
    PADDLE_TPU_SYNTH_SCALE (a float multiplier)."""
    scale = float(os.environ.get("PADDLE_TPU_SYNTH_SCALE", "1.0"))
    return max(8, int(default_train * scale)), max(4, int(default_test * scale))


def word_dict(size, extra=()):
    """Synthetic vocabulary 'w0'..'wN' (+ special tokens at the front)."""
    d = {}
    for i, tok in enumerate(extra):
        d[tok] = i
    for i in range(size - len(extra)):
        d["w%d" % i] = i + len(extra)
    return d
