"""MovieLens metadata: the table sizes the recommender (book chapter 05)
builds its embeddings at.

Parity: python/paddle/v2/dataset/movielens.py and the synthetic branch
of the JAX package's datasets/movielens.py: age_table, max_user_id,
max_movie_id, max_job_id, movie_categories and get_movie_title_dict, at
the synthetic tables' sizes (944 users, 1683 movies, 21 jobs, 18
categories, 1024 title words; ids 1-based like the real data). The JAX
package sizes these from `ml-1m.zip` when that file is under the data
home; reading it is not ported (ROADMAP A8), so with the file present
every function here raises rather than build other widths than the JAX
package would.
"""
from . import common

__all__ = ["get_movie_title_dict", "max_movie_id", "max_user_id",
           "max_job_id", "age_table", "movie_categories"]

age_table = [1, 18, 25, 35, 45, 50, 56]

N_USERS = 944
N_MOVIES = 1683
N_JOBS = 21
N_CATEGORIES = 18
TITLE_VOCAB = 1024


def _synthetic_only():
    if common.have_real_data("movielens", "ml-1m.zip"):
        raise NotImplementedError(
            "ml-1m.zip is under %s: the JAX package sizes the recommender "
            "from it, and reading it is not ported yet (ROADMAP A8)"
            % common.DATA_HOME)


def max_user_id():
    _synthetic_only()
    return N_USERS - 1


def max_movie_id():
    _synthetic_only()
    return N_MOVIES - 1


def max_job_id():
    _synthetic_only()
    return N_JOBS - 1


def movie_categories():
    _synthetic_only()
    return {"cat%d" % i: i for i in range(N_CATEGORIES)}


def get_movie_title_dict():
    _synthetic_only()
    return common.word_dict(TITLE_VOCAB)
