"""MovieLens-1M (reference: python/paddle/v2/dataset/movielens.py) — each
sample is ``user.value() + movie.value() + [rating]``:
[user_id, gender_id, age_id, job_id, movie_id, [category_ids], [title_ids],
score].  Real ml-1m zip from cache when present, else deterministic synthetic
meta where rating correlates with (user bucket, movie category) affinity."""

from __future__ import annotations

import os
import re
import zipfile

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = [
    "train",
    "test",
    "get_movie_title_dict",
    "max_movie_id",
    "max_user_id",
    "max_job_id",
    "movie_categories",
    "age_table",
    "user_info",
    "movie_info",
    "MovieInfo",
    "UserInfo",
]

age_table = [1, 18, 25, 35, 45, 50, 56]

_N_USERS = 120
_N_MOVIES = 80
_N_JOBS = 21
_CATEGORIES = [
    "Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
    "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
    "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]
_TITLE_WORDS = 60
_RATINGS = 4000


class MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        return [
            self.index,
            [CATEGORIES_DICT[c] for c in self.categories],
            [MOVIE_TITLE_DICT[w.lower()] for w in self.title.split()],
        ]

    def __repr__(self):
        return (
            f"<MovieInfo id({self.index}), title({self.title}), "
            f"categories({self.categories})>"
        )


class UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]

    def __repr__(self):
        return (
            f"<UserInfo id({self.index}), gender({'M' if self.is_male else 'F'}), "
            f"age({age_table[self.age]}), job({self.job_id})>"
        )


CATEGORIES_DICT = {c: i for i, c in enumerate(_CATEGORIES)}
MOVIE_TITLE_DICT = {f"t{i}": i for i in range(_TITLE_WORDS)}

_meta = None


def _have_real() -> bool:
    return os.path.exists(common.data_path("movielens", "ml-1m.zip"))


def _load_real():
    movies, users = {}, {}
    title_words = {}
    pattern = re.compile(r"^(.*)\((\d+)\)$")
    path = common.data_path("movielens", "ml-1m.zip")
    ratings = []
    with zipfile.ZipFile(path) as package:
        for info in package.infolist():
            if info.filename.endswith("movies.dat"):
                with package.open(info) as f:
                    for line in f:
                        mid, title, cats = line.decode("latin-1").strip().split("::")
                        title = pattern.match(title).group(1).strip()
                        for w in title.split():
                            title_words.setdefault(w.lower(), len(title_words))
                        movies[int(mid)] = (title, cats.split("|"))
            elif info.filename.endswith("users.dat"):
                with package.open(info) as f:
                    for line in f:
                        uid, gender, age, job, _ = line.decode("latin-1").strip().split("::")
                        users[int(uid)] = UserInfo(uid, gender, age, job)
            elif info.filename.endswith("ratings.dat"):
                with package.open(info) as f:
                    for line in f:
                        uid, mid, rating, _ = line.decode("latin-1").strip().split("::")
                        ratings.append((int(uid), int(mid), float(rating)))
    global MOVIE_TITLE_DICT
    MOVIE_TITLE_DICT = title_words
    movie_objs = {
        mid: MovieInfo(mid, cats, title) for mid, (title, cats) in movies.items()
    }
    return users, movie_objs, ratings


def _synth_meta():
    rng = np.random.RandomState(71)
    users = {}
    for uid in range(1, _N_USERS + 1):
        users[uid] = UserInfo(
            uid,
            "M" if rng.rand() < 0.5 else "F",
            age_table[int(rng.randint(len(age_table)))],
            int(rng.randint(_N_JOBS)),
        )
    movies = {}
    for mid in range(1, _N_MOVIES + 1):
        cats = list(
            np.array(_CATEGORIES)[
                rng.choice(len(_CATEGORIES), size=int(rng.randint(1, 4)), replace=False)
            ]
        )
        n_title = int(rng.randint(1, 4))
        title = " ".join(f"t{int(i)}" for i in rng.randint(_TITLE_WORDS, size=n_title))
        movies[mid] = MovieInfo(mid, cats, title)
    # affinity: user-job x first-category preference drives the score
    affinity = rng.rand(_N_JOBS, len(_CATEGORIES)) * 4 + 1
    ratings = []
    for _ in range(_RATINGS):
        uid = int(rng.randint(1, _N_USERS + 1))
        mid = int(rng.randint(1, _N_MOVIES + 1))
        cat = CATEGORIES_DICT[movies[mid].categories[0]]
        base = affinity[users[uid].job_id, cat]
        score = float(np.clip(round(base + rng.randn() * 0.5), 1, 5))
        ratings.append((uid, mid, score))
    return users, movies, ratings


def _get_meta():
    global _meta
    if _meta is None:
        _meta = _load_real() if _have_real() else _synth_meta()
    return _meta


def _reader(is_test: bool, test_ratio: float = 0.1, rand_seed: int = 0):
    def reader():
        users, movies, ratings = _get_meta()
        rng = np.random.RandomState(rand_seed)
        for uid, mid, score in ratings:
            if (rng.rand() < test_ratio) == is_test:
                usr = users[uid]
                mov = movies[mid]
                yield usr.value() + mov.value() + [score]

    return reader


def train():
    return _reader(is_test=False)


def test():
    return _reader(is_test=True)


def get_movie_title_dict():
    _get_meta()
    return MOVIE_TITLE_DICT


def max_movie_id():
    return max(m.index for m in _get_meta()[1].values())


def max_user_id():
    return max(u.index for u in _get_meta()[0].values())


def max_job_id():
    return max(u.job_id for u in _get_meta()[0].values())


def movie_categories():
    return CATEGORIES_DICT


def user_info():
    return _get_meta()[0]


def movie_info():
    return _get_meta()[1]
def convert(path):
    """Export to recordio shards for the master (reference movielens.py)."""
    common.convert(path, train(), 1000, "movielens_train")
    common.convert(path, test(), 1000, "movielens_test")
