"""The port's datasets (ROADMAP A8) against the JAX package's, on the CPU.

Each of the thirteen dataset modules falls back to its seeded synthetic
set exactly as the JAX module does: the first records of every reader
(and the dictionaries and tables beside them) are equal, field for field
and bit for bit. `common.convert` writes the same records into recordio
shards that the port's reader reads back; `common.split` and
`cluster_files_reader` round-trip. MovieLens reads a real `ml-1m.zip`
when one is under the data home: a tiny one written here into a
temporary PADDLE_TPU_DATA_HOME gives both packages the same metadata
and the same records (the module caches restored afterwards).

Tolerance: none; records are compared exactly.
"""
import itertools
import os
import zipfile

import numpy as np
import pytest

from paddle_tpu import datasets as jds
from paddle_tpu_torch import datasets as tds
from paddle_tpu_torch import recordio_writer as trw

N_RECORDS = 4


def _equal(a, b):
    """Records, lists, tuples, dicts and arrays, compared exactly."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def _first(reader, n=N_RECORDS):
    return list(itertools.islice(reader(), n))


# (name, fn(datasets module) -> what to compare)
CASES = {
    "cifar_train10": lambda d: _first(d.cifar.train10()),
    "cifar_test100": lambda d: _first(d.cifar.test100()),
    "conll05": lambda d: (_first(d.conll05.test()), d.conll05.get_dict(),
                          d.conll05.get_embedding()[:3]),
    "flowers": lambda d: (_first(d.flowers.train(), 2),
                          _first(d.flowers.valid(), 2)),
    "imdb": lambda d: (_first(d.imdb.train(d.imdb.word_dict())),
                       _first(d.imdb.test(d.imdb.word_dict()))),
    "imikolov": lambda d: (
        _first(d.imikolov.train(d.imikolov.build_dict(), 5)),
        _first(d.imikolov.test(d.imikolov.build_dict(), 5,
                               d.imikolov.DataType.SEQ))),
    "mnist": lambda d: (_first(d.mnist.train()), _first(d.mnist.test())),
    "movielens": lambda d: (_first(d.movielens.train()),
                            _first(d.movielens.test()),
                            d.movielens.max_user_id(),
                            d.movielens.max_movie_id(),
                            d.movielens.max_job_id()),
    "mq2007": lambda d: (_first(d.mq2007.train()),
                         _first(d.mq2007.test(format="listwise"), 2)),
    "sentiment": lambda d: (_first(d.sentiment.train()),
                            len(d.sentiment.get_word_dict())),
    "uci_housing": lambda d: (_first(d.uci_housing.train()),
                              _first(d.uci_housing.test())),
    "voc2012": lambda d: (_first(d.voc2012.train(), 2),
                          _first(d.voc2012.val(), 2)),
    "wmt14": lambda d: (_first(d.wmt14.train(1000)),
                        _first(d.wmt14.test(1000))),
    "wmt16": lambda d: (_first(d.wmt16.train(1000, 800)),
                        _first(d.wmt16.validation(1000, 800, "de")),
                        sorted(d.wmt16.get_dict("en", 50).items())),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_synthetic_records_match_the_jax_package(name):
    _equal(CASES[name](tds), CASES[name](jds))


def test_every_dataset_module_is_ported():
    assert sorted(tds.__all__) == sorted(jds.__all__)
    for mod in jds.__all__:
        assert set(getattr(jds, mod).__all__) <= \
            set(getattr(tds, mod).__all__), mod


def test_common_convert_writes_the_readers_records(tmp_path):
    """common.convert shards a reader into recordio files (2 records a
    file here) that read back record for record; the JAX package writes
    the same count."""
    rows = _first(tds.uci_housing.train(), 5)
    reader = lambda: iter(rows)  # noqa: E731
    n = tds.common.convert(str(tmp_path), reader, 2, "uci")
    assert n == 5
    names = sorted(os.listdir(str(tmp_path)))
    assert names == ["uci-%05d.recordio" % i for i in range(3)]
    back = [r for name in names
            for r in trw.recordio_reader(str(tmp_path / name))()]
    _equal([tuple(np.asarray(f) for f in r) for r in rows], back)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    assert jds.common.convert(str(jdir), reader, 2, "uci") == 5
    for name in names:
        assert (jdir / name).read_bytes() == (tmp_path / name).read_bytes()


def test_common_split_and_cluster_files_reader(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rows = [(i, [i, i + 1]) for i in range(7)]
    files = tds.common.split(lambda: iter(rows), 3)
    assert files == ["%05d.pickle" % i for i in range(3)]
    got = [r for t in range(2) for r in tds.common.cluster_files_reader(
        "*.pickle", 2, t)()]
    assert sorted(got) == rows


# --------------------------------------------------------- ml-1m.zip --

MOVIES = ["1::Toy Story (1995)::Animation|Children's|Comedy",
          "2::Jumanji (1995)::Adventure|Children's|Fantasy",
          "5::Father of the Bride Part II (1995)::Comedy"]
USERS = ["1::F::1::10::48067", "2::M::56::16::70072", "3::M::25::15::55117"]
RATINGS = ["%d::%d::%d::97830%04d" % (u, m, r, k) for k, (u, m, r) in
           enumerate([(1, 1, 5), (1, 2, 3), (2, 5, 4), (3, 1, 1), (2, 2, 2),
                      (3, 5, 5), (1, 5, 2), (2, 1, 4), (3, 2, 3),
                      (1, 1, 4)] * 3)]


@pytest.fixture
def ml_1m(tmp_path, monkeypatch):
    """A tiny ml-1m.zip under a temporary data home for both packages;
    their module caches are reset before and after."""
    (tmp_path / "movielens").mkdir()
    with zipfile.ZipFile(str(tmp_path / "movielens" / "ml-1m.zip"),
                         "w") as z:
        for name, lines in (("movies", MOVIES), ("users", USERS),
                            ("ratings", RATINGS)):
            z.writestr("ml-1m/%s.dat" % name,
                       "\n".join(lines).encode("latin-1") + b"\n")
    for pkg in (jds, tds):
        monkeypatch.setattr(pkg.common, "DATA_HOME", str(tmp_path))
        monkeypatch.setattr(pkg.movielens, "_REAL_CACHE", None)
    yield


def test_movielens_reads_ml_1m_as_the_jax_package(ml_1m):
    for d in (tds, jds):
        assert d.movielens._have_real()
    for fn in ("max_user_id", "max_movie_id", "max_job_id",
               "movie_categories", "get_movie_title_dict"):
        _equal(getattr(tds.movielens, fn)(), getattr(jds.movielens, fn)())
    assert tds.movielens.max_movie_id() == 5
    train = list(tds.movielens.train()())
    test = list(tds.movielens.test()())
    assert len(train) + len(test) == len(RATINGS)
    _equal(train, list(jds.movielens.train()()))
    _equal(test, list(jds.movielens.test()()))
    # user 1 (F, age 1, job 10) rated Toy Story 5: 2 x 5 - 5
    assert list(train[0][:4]) == [1, 1, 0, 10] and train[0][-1] == [5.0]
