"""LoD (level-of-detail) tensors: variable-length sequences.

Parity: paddle/fluid/framework/lod_tensor.{h,cc} and the JAX package's
core/lod.py. The reference stores a flat data tensor plus nested offset
tables and lets every sequence op walk offsets on the host. Here, as in the
JAX package, a LoDTensor feed expands to

    name        : dense [num_seqs, max_len, ...] zero-padded data
    name@SEQLEN : int32 [num_seqs] true lengths

and every sequence op is a masked computation over the padded layout.
The JAX package's native packer (`native/lodpack`) has no counterpart:
the padding is the numpy loop below.
"""
import numpy as np


class LoDTensor(object):
    """A batch of variable-length sequences.

    `lod` follows the reference's offset convention: for one level,
    lod=[[0, 3, 5]] means sequence 0 is rows [0,3) and sequence 1 is rows
    [3,5) of `data` (data is the concatenation of all sequences).
    """

    def __init__(self, data, lod=None):
        self.data = np.asarray(data)
        self.lod = [list(map(int, level)) for level in (lod or [])]

    def lod_level(self):
        return len(self.lod)

    def seq_lengths(self, level=0):
        offs = self.lod[level]
        return np.asarray([offs[i + 1] - offs[i] for i in range(len(offs) - 1)],
                          dtype=np.int32)

    def to_padded(self, max_len=None, bucket=8):
        """dense [num_seqs, max_len, *feature], lengths [num_seqs]. With no
        max_len, the longest sequence rounded up to a multiple of `bucket`
        (at least `bucket`)."""
        offs = self.lod[-1] if self.lod else [0, len(self.data)]
        lengths = np.asarray([offs[i + 1] - offs[i]
                              for i in range(len(offs) - 1)], dtype=np.int32)
        if max_len is None:
            m = int(lengths.max()) if len(lengths) else 1
            max_len = max(bucket, ((m + bucket - 1) // bucket) * bucket)
        # validate up front: a numpy slice past the data end can silently
        # broadcast a short row instead of raising
        if len(lengths) and (lengths.min() < 0 or offs[0] < 0
                             or offs[-1] > len(self.data)
                             or int(lengths.max()) > max_len):
            raise ValueError(
                "malformed LoD: offsets %r over %d data rows (max_len %d)"
                % (offs, len(self.data), max_len))
        feat = self.data.shape[1:]
        out = np.zeros((len(lengths), max_len) + tuple(feat),
                       dtype=self.data.dtype)
        for i in range(len(lengths)):
            out[i, :lengths[i]] = self.data[offs[i]:offs[i + 1]]
        return out, lengths

    @staticmethod
    def from_sequences(seqs, dtype=None):
        """Build from a list of per-sequence arrays (list of [len_i, ...])."""
        seqs = [np.asarray(s) for s in seqs]
        data = np.concatenate(seqs, axis=0) if seqs else np.zeros((0,))
        if dtype is not None:
            data = data.astype(dtype)
        offs = [0]
        for s in seqs:
            offs.append(offs[-1] + len(s))
        return LoDTensor(data, [offs])


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """Parity: fluid.create_lod_tensor (lengths-based construction)."""
    lod = []
    for lens in recursive_seq_lens:
        offs = [0]
        for n in lens:
            offs.append(offs[-1] + int(n))
        lod.append(offs)
    return LoDTensor(np.asarray(data), lod)
