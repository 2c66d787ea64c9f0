"""Dataset infrastructure (the port's copy of the JAX package's
datasets/common.py).

Parity: python/paddle/v2/dataset/common.py (DATA_HOME, download/md5 cache,
split/cluster_files_reader, convert-to-recordio). This build runs zero-egress:
`download` never touches the network — it returns the cached file when one is
already present under DATA_HOME and raises otherwise. Every dataset module
therefore ships a *deterministic synthetic fallback* with the exact record
types/shapes/vocabularies of the real data, so models, tests and benchmarks
run identically; drop the real files into DATA_HOME to train on them.
"""
import hashlib
import os

import numpy as np

__all__ = ["DATA_HOME", "download", "md5file", "split",
           "cluster_files_reader", "convert", "synthetic_rng",
           "synthetic_size", "have_real_data", "word_dict"]

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))


def _data_path(module_name, filename):
    return os.path.join(DATA_HOME, module_name, filename)


def have_real_data(module_name, filename):
    return os.path.exists(_data_path(module_name, filename))


def md5file(fname):
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def download(url, module_name, md5sum=None, save_name=None):
    """Zero-egress 'download': resolve to the local cache or fail loudly."""
    filename = save_name or url.split("/")[-1]
    path = _data_path(module_name, filename)
    if os.path.exists(path):
        if md5sum and md5file(path) != md5sum:
            raise IOError("cached file %s fails md5 check" % path)
        return path
    raise IOError(
        "no network egress and %s not cached; place the file at %s or use "
        "the synthetic fallback readers (the default)" % (url, path))


def split(reader, line_count, suffix="%05d.pickle", dumper=None):
    """Split reader samples into chunked pickle files (reference parity)."""
    import pickle
    dumper = dumper or pickle.dump
    indx_f = 0
    batched = []
    out_files = []

    def _flush():
        nonlocal indx_f, batched
        if not batched:
            return
        name = suffix % indx_f
        with open(name, "wb") as f:
            dumper(batched, f)
        out_files.append(name)
        batched = []
        indx_f += 1

    for sample in reader():
        batched.append(sample)
        if len(batched) == line_count:
            _flush()
    _flush()
    return out_files


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=None):
    """Read the shard of chunked files belonging to this trainer."""
    import glob
    import pickle
    loader = loader or pickle.load

    def reader():
        flist = sorted(glob.glob(files_pattern))
        for i, fn in enumerate(flist):
            if i % trainer_count == trainer_id:
                with open(fn, "rb") as f:
                    for sample in loader(f):
                        yield sample
    return reader


def convert(output_path, reader, line_count, name_prefix):
    """Serialize reader samples into recordio shards (reference parity,
    backed by our native recordio writer)."""
    from .. import recordio_writer
    indx_f = 0
    count = 0
    buffered = []

    def _flush():
        nonlocal indx_f, buffered
        if not buffered:
            return
        path = os.path.join(output_path,
                            "%s-%05d.recordio" % (name_prefix, indx_f))
        recordio_writer.convert_reader_to_recordio_file(
            path, lambda: iter(buffered))
        buffered = []
        indx_f += 1

    for sample in reader():
        buffered.append(sample)
        count += 1
        if len(buffered) == line_count:
            _flush()
    _flush()
    return count


# ---------------------------------------------------------------- synthetic

def synthetic_rng(module_name, split_name, salt=0):
    """Deterministic per-(dataset, split) RandomState — same records every
    run, every process (seed is a stable hash, not builtin hash())."""
    key = "%s/%s/%d" % (module_name, split_name, salt)
    seed = int(hashlib.md5(key.encode()).hexdigest()[:8], 16)
    return np.random.RandomState(seed)


def synthetic_size(default_train, default_test):
    """Synthetic dataset sizes, shrinkable for tests via env var
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
