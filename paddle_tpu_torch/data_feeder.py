"""DataFeeder: convert python/numpy rows into feed tensors.

Parity: python/paddle/fluid/data_feeder.py and the JAX package's
data_feeder.py — converts a minibatch (list of tuples from a reader) into
{var_name: array-or-LoDTensor} keyed by the feed list, handling
lod_level>0 vars by building LoDTensors from per-row lists. The feed stays
on the host: the Executor that runs it moves it to its place's device.
"""
import numpy as np

from .core.framework import Variable, default_main_program, convert_dtype
from .core.lod import LoDTensor


class DataFeeder(object):
    def __init__(self, feed_list, place=None, program=None):
        self.feed_dtypes = []
        self.feed_names = []
        self.feed_shapes = []
        self.feed_lod_level = []
        if program is None:
            program = default_main_program()
        for each_var in feed_list:
            if isinstance(each_var, str):
                each_var = program.global_block().var(each_var)
            if not isinstance(each_var, Variable):
                raise TypeError("feed_list should contain Variables or names")
            self.feed_names.append(each_var.name)
            self.feed_lod_level.append(each_var.lod_level)
            self.feed_shapes.append(each_var.shape)
            self.feed_dtypes.append(each_var.dtype)
        self.place = place

    def feed(self, iterable):
        rows = list(iterable)
        out = {}
        for i, name in enumerate(self.feed_names):
            cols = [row[i] for row in rows]
            lod_level = self.feed_lod_level[i]
            dtype = convert_dtype(self.feed_dtypes[i])
            if lod_level == 0:
                arr = np.asarray(cols, dtype=dtype)
                shape = self.feed_shapes[i]
                if shape is not None:
                    # reshape flat rows into declared shape (batch dim -1)
                    want = [d for d in shape]
                    if want and want[0] == -1:
                        arr = arr.reshape([len(rows)] +
                                          [d for d in want[1:]])
                out[name] = arr
            else:
                seqs = [np.asarray(c, dtype=dtype) for c in cols]
                seqs = [s.reshape(-1, *self._feat_shape(i)) for s in seqs]
                out[name] = LoDTensor.from_sequences(seqs, dtype=dtype)
        return out

    def _feat_shape(self, i):
        shape = self.feed_shapes[i]
        if shape is None:
            return ()
        return tuple(d for d in shape if d != -1) or (1,)
