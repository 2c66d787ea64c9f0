"""MovieLens-1M recommender dataset.

Parity: python/paddle/v2/dataset/movielens.py — train()/test() yield
(user_id, gender_id, age_id, job_id, movie_id, category_ids, title_ids,
[rating]); plus max_user_id/max_movie_id/max_job_id/age_table and the
MovieInfo/UserInfo tables. The real `ml-1m.zip` under DATA_HOME/movielens
is parsed when present ('::'-separated movies/users/ratings.dat, title
year stripped, rating scaled x2-5, random.Random(0) 10% test split —
reference movielens.py:101-160 exactly, with the title/category dicts
built in sorted order for determinism). Synthetic fallback: latent-factor
ratings (user·movie affinity), so the recommender model genuinely learns.
"""
import os
import random
import re
import zipfile

import numpy as np

from . import common

__all__ = ["train", "test", "get_movie_title_dict", "max_movie_id",
           "max_user_id", "max_job_id", "age_table", "movie_categories",
           "convert", "MovieInfo", "UserInfo"]

age_table = [1, 18, 25, 35, 45, 50, 56]

_N_USERS = 944       # ml-100k-scale ids, 1-based like the real data
_N_MOVIES = 1683
_N_JOBS = 21
_N_CATEGORIES = 18
_TITLE_VOCAB = 1024
_TRAIN_N, _TEST_N = common.synthetic_size(2000, 400)


class MovieInfo(object):
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        return [self.index, [c for c in self.categories],
                [t for t in self.title]]


class UserInfo(object):
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]


def max_user_id():
    if _have_real():
        return max(_real_meta()[0])
    return _N_USERS - 1


def max_movie_id():
    if _have_real():
        return max(_real_meta()[1])
    return _N_MOVIES - 1


def max_job_id():
    if _have_real():
        return max(u.job_id for u in _real_meta()[0].values())
    return _N_JOBS - 1


def movie_categories():
    if _have_real():
        return dict(_real_meta()[3])
    return {"cat%d" % i: i for i in range(_N_CATEGORIES)}


def get_movie_title_dict():
    if _have_real():
        return dict(_real_meta()[2])
    return common.word_dict(_TITLE_VOCAB)


_REAL_CACHE = None


def _have_real():
    return common.have_real_data("movielens", "ml-1m.zip")


def _real_meta():
    """Parse ml-1m.zip into (users, movies, title_dict, cat_dict) with
    MovieInfo values pre-resolved to id lists."""
    global _REAL_CACHE
    if _REAL_CACHE is not None:
        return _REAL_CACHE
    path = os.path.join(common.DATA_HOME, "movielens", "ml-1m.zip")
    pattern = re.compile(r"^(.*)\((\d+)\)$")
    raw_movies = {}
    title_words, cat_names = set(), set()
    with zipfile.ZipFile(path) as z:
        with z.open("ml-1m/movies.dat") as f:
            for line in f:
                mid, title, cats = \
                    line.decode("latin-1").strip().split("::")
                cats = cats.split("|")
                cat_names.update(cats)
                m = pattern.match(title)
                title = m.group(1) if m else title
                raw_movies[int(mid)] = (title, cats)
                title_words.update(w.lower() for w in title.split())
        users = {}
        with z.open("ml-1m/users.dat") as f:
            for line in f:
                uid, gender, age, job = \
                    line.decode("latin-1").strip().split("::")[:4]
                users[int(uid)] = UserInfo(uid, gender, age, job)
    title_dict = {w: i for i, w in enumerate(sorted(title_words))}
    cat_dict = {c: i for i, c in enumerate(sorted(cat_names))}
    movies = {}
    for mid, (title, cats) in raw_movies.items():
        movies[mid] = MovieInfo(
            mid, [cat_dict[c] for c in cats],
            [title_dict[w.lower()] for w in title.split()])
    _REAL_CACHE = (users, movies, title_dict, cat_dict)
    return _REAL_CACHE


def _real_reader(is_test, rand_seed=0, test_ratio=0.1):
    users, movies, _, _ = _real_meta()
    path = os.path.join(common.DATA_HOME, "movielens", "ml-1m.zip")

    def reader():
        rand = random.Random(x=rand_seed)
        with zipfile.ZipFile(path) as z:
            with z.open("ml-1m/ratings.dat") as f:
                for line in f:
                    if (rand.random() < test_ratio) != is_test:
                        continue
                    uid, mid, rating, _ts = \
                        line.decode("latin-1").strip().split("::")
                    rating = float(rating) * 2 - 5.0  # reference scaling
                    yield tuple(users[int(uid)].value() +
                                movies[int(mid)].value() + [[rating]])
    return reader


_TABLES_CACHE = None


def _tables():
    # memoized like the reference's module-global MOVIE_INFO/USER_INFO
    # (python/paddle/v2/dataset/movielens.py __initialize_meta_info__)
    global _TABLES_CACHE
    if _TABLES_CACHE is not None:
        return _TABLES_CACHE
    rng = common.synthetic_rng("movielens", "tables")
    movies = {}
    for mid in range(1, _N_MOVIES):
        ncat = int(rng.randint(1, 4))
        cats = rng.choice(_N_CATEGORIES, ncat, replace=False).tolist()
        tlen = int(rng.randint(1, 6))
        title = rng.randint(0, _TITLE_VOCAB, tlen).tolist()
        movies[mid] = MovieInfo(mid, cats, title)
    users = {}
    for uid in range(1, _N_USERS):
        users[uid] = UserInfo(
            uid, "M" if rng.rand() < 0.5 else "F",
            age_table[int(rng.randint(0, len(age_table)))],
            int(rng.randint(0, _N_JOBS)))
    # latent factors driving ratings
    uf = rng.randn(_N_USERS, 8).astype(np.float32)
    mf = rng.randn(_N_MOVIES, 8).astype(np.float32)
    _TABLES_CACHE = (users, movies, uf, mf)
    return _TABLES_CACHE


def movie_info():
    return _real_meta()[1] if _have_real() else _tables()[1]


def user_info():
    return _real_meta()[0] if _have_real() else _tables()[0]


def _reader_creator(split_name, n):
    if _have_real():
        return _real_reader(is_test=(split_name == "test"))
    def reader():
        users, movies, uf, mf = _tables()
        rng = common.synthetic_rng("movielens", split_name)
        for _ in range(n):
            uid = int(rng.randint(1, _N_USERS))
            mid = int(rng.randint(1, _N_MOVIES))
            raw = float(uf[uid] @ mf[mid]) / 4.0 + rng.randn() * 0.2
            rating = float(np.clip(np.round(raw + 3.0), 1, 5))
            yield tuple(users[uid].value() + movies[mid].value() + [[rating]])
    return reader


def train():
    return _reader_creator("train", _TRAIN_N)


def test():
    return _reader_creator("test", _TEST_N)


def convert(path):
    common.convert(path, train(), 1000, "movielens_train")
    common.convert(path, test(), 1000, "movielens_test")
