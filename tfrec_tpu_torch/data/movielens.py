"""MovieLens rating-file loaders: the counterpart of
``tfrec_tpu/data/movielens.py``.

Reads the standard rating formats, the separator sniffed from the first
line:

- ml-100k ``u.data``: ``user\\titem\\trating\\ttimestamp``;
- ml-1m and ml-10m ``ratings.dat``: ``user::item::rating::timestamp``;
- generic CSV, TSV or space-separated UIRT, with an optional header;

and ml-1m's ``users.dat`` and ``movies.dat`` side features for the
multi-field FM of config 2. The native parser (``data/uirt_native.py``)
reads the ratings where g++ builds it; the Python loop gives the same
arrays elsewhere.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from tfrec_tpu_torch.data.dataset import Interactions, densify_ids

_SEPARATORS = ("::", "\t", ",", " ")


def _sniff_separator(line: str) -> str:
    for sep in _SEPARATORS:
        if sep in line:
            return sep
    raise ValueError(f"cannot determine UIRT separator from line {line!r}")


def load_uirt_raw(path: str, native: bool = True):
    """(raw_users, raw_items, ratings, times) without densifying the ids
    (the "given" splitter densifies over train and test together). A header
    line, if any, is stripped; lines split on ``\\n`` only, as in the native
    parser. ``native=True`` parses through ``csrc/uirt_native.cpp`` where it
    builds, else the Python loop runs."""
    if path is None or not os.path.exists(path):
        raise FileNotFoundError(f"rating file not found: {path}")
    with open(path, "rb") as f:
        data = f.read()
    nl = data.find(b"\n")
    first = (data if nl < 0 else data[: nl + 1]).decode("latin-1")
    sep = _sniff_separator(first)
    has_header = not first.split(sep)[0].strip().lstrip("-").isdigit()
    if has_header:
        body = data[nl + 1 :] if nl >= 0 else b""  # a header alone, too
    else:
        body = data

    if native:
        from tfrec_tpu_torch.data.uirt_native import NativeUnavailable, parse_buffer

        try:
            return parse_buffer(body, sep)
        except NativeUnavailable:
            pass  # no toolchain: the Python loop gives the same arrays

    rows = body.decode("latin-1").split("\n")
    if rows and rows[-1] == "":
        rows.pop()
    n = len(rows)
    raw_u = np.empty(n, dtype=np.int64)
    raw_i = np.empty(n, dtype=np.int64)
    ratings = np.ones(n, dtype=np.float32)
    times = np.zeros(n, dtype=np.float64)
    count = 0
    for line in rows:
        parts = line.split(sep)
        if len(parts) < 2 or not parts[0].strip():
            continue
        raw_u[count] = int(float(parts[0]))
        raw_i[count] = int(float(parts[1]))
        if len(parts) >= 3 and parts[2].strip():
            ratings[count] = float(parts[2])
        if len(parts) >= 4 and parts[3].strip():
            times[count] = float(parts[3])
        count += 1
    return raw_u[:count], raw_i[:count], ratings[:count], times[:count]


def load_uirt(path: str) -> Interactions:
    """A user-item-rating[-time] file as Interactions with dense ids."""
    raw_u, raw_i, ratings, times = load_uirt_raw(path)
    users, items, nu, ni = densify_ids(raw_u, raw_i)
    return Interactions(users=users, items=items, ratings=ratings, times=times,
                        num_users=nu, num_items=ni)


def load_ml1m_user_features(path: str) -> Tuple[Dict[int, np.ndarray], Tuple[int, ...]]:
    """ml-1m ``users.dat`` (UserID::Gender::Age::Occupation::Zip) as a
    categorical vector [gender, age bucket, occupation] a user: (raw user id
    -> int32[3], the three fields' vocabs). Codes follow first appearance."""
    genders: Dict[str, int] = {}
    ages: Dict[str, int] = {}
    occs: Dict[str, int] = {}
    feats: Dict[int, np.ndarray] = {}
    with open(path, "r", encoding="latin-1") as f:
        for line in f:
            parts = line.rstrip("\n").split("::")
            if len(parts) < 4:
                continue
            uid = int(parts[0])
            g = genders.setdefault(parts[1], len(genders))
            a = ages.setdefault(parts[2], len(ages))
            o = occs.setdefault(parts[3], len(occs))
            feats[uid] = np.array([g, a, o], dtype=np.int32)
    return feats, (len(genders), len(ages), len(occs))


def load_ml1m_item_genres(path: str) -> Tuple[Dict[int, int], int]:
    """``movies.dat`` (MovieID::Title::Genres): each movie's first genre as
    one categorical field: (raw movie id -> genre code, the vocab)."""
    genres: Dict[str, int] = {}
    first_genre: Dict[int, int] = {}
    with open(path, "r", encoding="latin-1") as f:
        for line in f:
            parts = line.rstrip("\n").split("::")
            if len(parts) < 3:
                continue
            mid = int(parts[0])
            g = parts[2].split("|")[0]
            first_genre[mid] = genres.setdefault(g, len(genres))
    return first_genre, len(genres)
