"""The port's data loaders against the JAX package's, on the CPU.

Small Criteo TSVs and MovieLens rating and side-feature files are written
from a numpy seed; the port's Python parsers, its native parsers (built
with g++ into build/tfrec_tpu_torch/) and the JAX package's loaders read
them. Each parser is held bit for bit to its counterpart in the JAX
package: ``iter_criteo_batches`` (malformed lines, small chunks,
``max_examples``), ``load_criteo`` (the Python parser, as the reference's
reads), ``CriteoStreamBatcher`` (the eval
boundary, 2- and 3-way shards), ``load_uirt`` over tab, ``::``, comma and
header inputs, ``split_given`` through ``build_dataset`` and the ML-1M
readers. The JAX package's native Criteo parser is built into the test's
own directory, so it never races the JAX tests on ``build/``.

The reference's two Criteo parsers differ in the last bit of some dense
values: its Python parser rounds a float64 ``log1p`` to float32, and
``csrc/criteo_native.cpp`` calls the C library's float32 ``log1pf`` (its own test,
tests/test_criteo_native.py, holds them at rtol 1e-6). The port keeps both
as they are: each is held bit for bit to its own arithmetic, categorical
ids and labels are equal across the two, and dense values within 1 ulp.
"""

import ctypes
import ctypes.util
import dataclasses

import numpy as np
import pytest
import torch

import tfrec_tpu.data.criteo as jax_criteo
import tfrec_tpu.data.criteo_native as jax_criteo_native
import tfrec_tpu.data.movielens as jax_movielens
import tfrec_tpu.data.uirt_native as jax_uirt_native
from tfrec_tpu.configs import DataConfig as JaxDataConfig
from tfrec_tpu.data.dataset import build_dataset as jax_build_dataset
from tfrec_tpu_torch.configs import DataConfig
from tfrec_tpu_torch.data import criteo, criteo_native, movielens, uirt_native
from tfrec_tpu_torch.kernels._build import BUILD_DIR
from tfrec_tpu_torch.data.dataset import build_dataset

torch.set_num_threads(1)


def write_criteo(path, n, seed=0, malformed_every=0):
    """``n`` Criteo lines from a seed: ~10% of dense and categorical fields
    empty, negative ints among the dense ones, and every
    ``malformed_every``-th line (from the 5th) without its fields."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            if malformed_every and i % malformed_every == 5:
                f.write("garbage line without fields\n")
                continue
            label = rng.integers(0, 2)
            dense = "\t".join(str(rng.integers(-2, 100)) if rng.random() > 0.1 else ""
                              for _ in range(13))
            cats = "\t".join(format(rng.integers(0, 1 << 32), "x") if rng.random() > 0.1 else ""
                             for _ in range(26))
            f.write(f"{label}\t{dense}\t{cats}\n")
    return str(path)


def assert_batches_equal(got, want, dense_ulps=0):
    """Batches (tuples or dicts) equal array for array; with ``dense_ulps``
    the dense arrays within that many float32 ulps, the rest bit for bit."""
    got, want = list(got), list(want)
    assert len(got) == len(want) and len(got) > 0
    for a, b in zip(got, want):
        a = list(a.values()) if isinstance(a, dict) else a
        b = list(b.values()) if isinstance(b, dict) else b
        for i, (x, y) in enumerate(zip(a, b)):
            assert x.dtype == y.dtype and x.shape == y.shape
            if i == 0 and dense_ulps:
                assert np.abs(x.view(np.int32) - y.view(np.int32)).max() <= dense_ulps
            else:
                np.testing.assert_array_equal(x, y)


def raw_dense(path):
    """Each well-formed line's 13 dense ints as float64, clipped at 0."""
    rows = [line.rstrip("\n").split("\t") for line in open(path)]
    return np.array([[float(v) if v else 0.0 for v in r[1:14]] for r in rows if len(r) == 40]
                    ).clip(min=0.0)


def log1pf(values):
    """The C library's float32 ``log1pf`` of integer values (the native
    parser's dense transform), 0 where the value is not positive."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.log1pf.restype, libm.log1pf.argtypes = ctypes.c_float, [ctypes.c_float]
    uniq = np.unique(values)
    table = np.array([libm.log1pf(float(v)) if v > 0 else 0.0 for v in uniq], np.float32)
    return table[np.searchsorted(uniq, values)]


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """The JAX package's native Criteo parser. Both of its native parsers
    build their libraries into a directory of this test's own for the
    module's tests."""
    d = tmp_path_factory.mktemp("jax_native_build")
    mods = {jax_criteo_native: "libtfrec_criteo.so", jax_uirt_native: "libtfrec_uirt.so"}
    saved = {m: (m._BUILD_DIR, m._SO, m._lib) for m in mods}
    for m, lib in mods.items():
        m._BUILD_DIR, m._SO, m._lib = str(d), str(d / lib), None
    jax_criteo_native.load()
    yield jax_criteo_native
    for m, (build_dir, so, lib) in saved.items():
        m._BUILD_DIR, m._SO, m._lib = build_dir, so, lib


def _no_toolchain():
    raise jax_criteo_native.NativeUnavailable("no g++")


@pytest.fixture
def python_parser_only(monkeypatch):
    """Both packages' parser choice as on a host without g++."""
    monkeypatch.setattr(criteo, "_native_or_none", lambda: None)
    monkeypatch.setattr(jax_criteo_native, "load", _no_toolchain)


def test_native_parser_builds_into_the_ports_own_directory():
    lib = criteo_native.load()
    assert lib is criteo_native.load()
    assert (BUILD_DIR / "libcriteo_native.so").exists()
    assert BUILD_DIR.parts[-2:] == ("build", "tfrec_tpu_torch")


@pytest.mark.parametrize("malformed", [0, 97])
def test_criteo_parsers_match_jax_bit_for_bit(tmp_path, malformed, jax_native):
    path = write_criteo(tmp_path / "c.tsv", 3000, malformed_every=malformed)
    vocab = [777] * 26
    for drop in (True, False):  # the tail batch kept, as load_criteo reads it
        want_py = list(jax_criteo.iter_criteo_batches(path, 256, vocab, drop_remainder=drop))
        assert drop or len(want_py[-1][2]) < 256
        assert_batches_equal(criteo.iter_criteo_batches(path, 256, vocab, drop_remainder=drop),
                             want_py)
        got_native = list(criteo_native.iter_criteo_batches_native(
            path, 256, vocab, drop_remainder=drop))
        assert_batches_equal(got_native, want_py, dense_ulps=1)
    if not malformed:
        assert_batches_equal(got_native[:-1], jax_native.iter_criteo_batches_native(path, 256, vocab))
    # Each parser's dense arithmetic: float64 log1p rounded, and the C
    # library's float32 log1pf.
    x = raw_dense(path)
    py_dense = np.concatenate([b[0] for b in want_py])
    native_dense = np.concatenate([b[0] for b in got_native])
    np.testing.assert_array_equal(py_dense, np.log1p(x).astype(np.float32))
    np.testing.assert_array_equal(native_dense, log1pf(x))
    assert (py_dense != native_dense).any()


def test_criteo_hash_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(200):
        tok = format(rng.integers(0, 1 << 32), "x")
        field, vocab = int(rng.integers(0, 26)), int(rng.integers(1, 200_000))
        assert criteo._hash_token(tok, vocab, field) == jax_criteo._hash_token(tok, vocab, field)


@pytest.mark.parametrize("chunk_bytes", [1000, 4093])
def test_native_parser_small_chunks(tmp_path, chunk_bytes, jax_native):
    """A chunk boundary inside a line loses and repeats no row."""
    path = write_criteo(tmp_path / "c.tsv", 500)
    vocab = [100] * 26
    small = list(criteo_native.iter_criteo_batches_native(path, 100, vocab, chunk_bytes=chunk_bytes))
    assert len(small) == 5
    assert_batches_equal(small, jax_native.iter_criteo_batches_native(path, 100, vocab))
    assert_batches_equal(small, jax_criteo.iter_criteo_batches(path, 100, vocab), dense_ulps=1)


@pytest.mark.parametrize("chunk_bytes", [20_000, 64 << 20])
def test_native_parser_reads_malformed_lines_once(tmp_path, chunk_bytes, jax_native):
    """After malformed lines the reference's native iterator parses a
    chunk's last lines twice (its bytes-consumed counts the skipped lines
    out), so its rows part from its Python parser's; the port's rows are
    the Python parser's, whatever the chunk."""
    path = write_criteo(tmp_path / "c.tsv", 3000, malformed_every=97)
    vocab = [777] * 26
    want = list(jax_criteo.iter_criteo_batches(path, 100, vocab))
    got = list(criteo_native.iter_criteo_batches_native(path, 100, vocab, chunk_bytes=chunk_bytes))
    assert_batches_equal(got, want, dense_ulps=1)
    ref = list(jax_native.iter_criteo_batches_native(path, 100, vocab, chunk_bytes=chunk_bytes))
    assert sum(len(b[2]) for b in ref) > sum(len(b[2]) for b in want)  # the reference's repeats


@pytest.mark.parametrize("max_examples", [200, 256])
def test_criteo_max_examples(tmp_path, max_examples, jax_native):
    path = write_criteo(tmp_path / "c.tsv", 400, malformed_every=50)
    want = list(jax_criteo.iter_criteo_batches(path, 64, 100, max_examples=max_examples))
    assert len(want) == max_examples // 64
    assert_batches_equal(criteo.iter_criteo_batches(path, 64, 100, max_examples=max_examples), want)
    assert_batches_equal(
        criteo_native.iter_criteo_batches_native(path, 64, 100, max_examples=max_examples),
        jax_native.iter_criteo_batches_native(path, 64, 100, max_examples=max_examples))


def test_load_criteo_and_the_parser_record(tmp_path, monkeypatch):
    """``load_criteo`` reads through the Python parser, as the reference's
    does, so its arrays are the reference's bit for bit whether or not the
    native parser builds; only the stream's train batches take the native
    parser, and the batcher names it."""
    path = write_criteo(tmp_path / "c.tsv", 1000, malformed_every=33)
    want = jax_criteo.load_criteo(path, 500, max_examples=900)
    assert criteo_native.load() is not None  # the native parser builds here
    assert_batches_equal([criteo.load_criteo(path, 500, max_examples=900)], [want])
    monkeypatch.setattr(criteo_native, "load", lambda: (_ for _ in ()).throw(
        criteo_native.NativeUnavailable("no g++")))
    assert_batches_equal([criteo.load_criteo(path, 500, max_examples=900)], [want])
    stream = criteo.CriteoStreamBatcher(path, 100, vocab_sizes=500, eval_examples=200)
    assert stream.parser is None
    assert len(list(stream.epoch(0))) == 7 and stream.parser == "python"
    assert not hasattr(criteo, "PARSER_RUNS")
    with pytest.raises(ValueError, match="no complete batches"):
        criteo.load_criteo(path, 500, max_examples=0)


@pytest.mark.parametrize("eval_examples", [200, 230])
def test_stream_batcher_matches_jax(tmp_path, eval_examples, python_parser_only):
    """230 puts the eval boundary inside a batch: the batch across it starts
    at the first train line, as in the reference."""
    path = write_criteo(tmp_path / "c.tsv", 1000, malformed_every=41)
    ours = criteo.CriteoStreamBatcher(path, 100, vocab_sizes=1000, eval_examples=eval_examples)
    ref = jax_criteo.CriteoStreamBatcher(path, 100, vocab_sizes=1000, eval_examples=eval_examples)
    assert_batches_equal([ours.eval_arrays()], [ref.eval_arrays()])
    assert len(ours.eval_arrays()[2]) == eval_examples
    for epoch in range(2):
        assert_batches_equal(ours.epoch(epoch), ref.epoch(epoch))
    assert ours.parser == "python"
    assert ours.num_batches() == ref.num_batches() == -1
    capped = criteo.CriteoStreamBatcher(path, 100, 1000, eval_examples=200, max_examples=900)
    assert capped.num_batches() == 7


def test_stream_batcher_native_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_criteo_native, "load", _no_toolchain)  # the reference's Python rows
    path = write_criteo(tmp_path / "c.tsv", 1000, malformed_every=41)
    ours = criteo.CriteoStreamBatcher(path, 100, vocab_sizes=1000, eval_examples=230)
    ref = jax_criteo.CriteoStreamBatcher(path, 100, vocab_sizes=1000, eval_examples=230)
    assert_batches_equal([ours.eval_arrays()], [ref.eval_arrays()])  # both the Python parser's
    assert_batches_equal(ours.epoch(0), ref.epoch(0), dense_ulps=1)
    assert ours.parser == "native"


@pytest.mark.parametrize("num_shards", [2, 3])
def test_stream_batcher_shards_match_jax(tmp_path, num_shards, python_parser_only):
    path = write_criteo(tmp_path / "c.tsv", 1000)
    for p in range(num_shards):
        ours = criteo.CriteoStreamBatcher(path, 50, 1000, eval_examples=200,
                                          num_shards=num_shards, shard_index=p)
        ref = jax_criteo.CriteoStreamBatcher(path, 50, 1000, eval_examples=200,
                                             num_shards=num_shards, shard_index=p)
        got = list(ours.epoch(0))
        assert len(got) == 16 // num_shards
        assert_batches_equal(got, ref.epoch(0))
    with pytest.raises(ValueError, match="shard_index"):
        criteo.CriteoStreamBatcher(path, 50, num_shards=2, shard_index=2)


UIRT_CASES = {
    "tab": "1\t10\t5\t100\n2\t20\t3\t200\n1\t20\t4\t50\n",
    "double colon": "1::10::5::100\n2::20::3::200\n",
    "comma header": "userId,movieId,rating,timestamp\n1,10,5,100\n2,20,3,200\n",
    "space two fields": "5 7\n8 9\n",
    "blank fields": "1\t10\t\t99\n2\t20\t4.0\t\n\n",
    "no trailing newline": "1::10::3::1\n2::20::4::2",
    "header only": "userId,movieId,rating\n",
}


@pytest.mark.parametrize("case", sorted(UIRT_CASES))
def test_uirt_readers_match_jax(tmp_path, case):
    path = tmp_path / "r.txt"
    path.write_text(UIRT_CASES[case], encoding="latin-1")
    want = jax_movielens.load_uirt_raw(str(path), native=False)
    for native in (True, False):
        got = movielens.load_uirt_raw(str(path), native=native)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if case == "header only":
        return
    got, ref = movielens.load_uirt(str(path)), jax_movielens.load_uirt(str(path))
    for field in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, field.name), getattr(ref, field.name))


def test_uirt_malformed_field_raises_in_both_parsers(tmp_path):
    path = tmp_path / "bad.txt"
    path.write_text("1\t10\t3\t1\n2\tgarbage\t4\t2\n")
    for native in (True, False):
        with pytest.raises(ValueError):
            movielens.load_uirt_raw(str(path), native=native)
    with pytest.raises(FileNotFoundError):
        movielens.load_uirt_raw(str(tmp_path / "missing.dat"))
    with pytest.raises(ValueError, match="separator"):
        movielens._sniff_separator("12345")


def test_uirt_native_at_scale_matches_python(tmp_path):
    rng = np.random.default_rng(0)
    n = 20_000
    lines = [f"{u}::{i}::{r:.1f}::{t}" for u, i, r, t in zip(
        rng.integers(0, 5000, n), rng.integers(0, 9000, n),
        rng.integers(1, 11, n) / 2.0, rng.integers(0, 2**31, n))]
    path = tmp_path / "big.dat"
    path.write_text("\n".join(lines) + "\n")
    got = movielens.load_uirt_raw(str(path), native=True)
    for a, b in zip(got, jax_movielens.load_uirt_raw(str(path), native=False)):
        np.testing.assert_array_equal(a, b)
    one = uirt_native.parse_buffer(path.read_bytes(), "::", n_threads=1)
    many = uirt_native.parse_buffer(path.read_bytes(), "::", n_threads=13)
    for a, b in zip(one, many):
        np.testing.assert_array_equal(a, b)


def _write_ratings(path, rows):
    with open(path, "w") as f:
        for u, i, r, t in rows:
            f.write(f"{u}\t{i}\t{r}\t{t}\n")
    return str(path)


@pytest.mark.parametrize("splitter", ["given", "ratio", "leave_one_out"])
def test_movielens_build_dataset_matches_jax(tmp_path, splitter):
    rng = np.random.default_rng(5)
    rows = [(int(u), int(i), int(r), int(t)) for u, i, r, t in zip(
        rng.integers(1, 40, 600) * 7, rng.integers(1, 90, 600) * 3,
        rng.integers(1, 6, 600), rng.integers(0, 10**9, 600))]
    train = _write_ratings(tmp_path / "train.tsv", rows[:500])
    test = _write_ratings(tmp_path / "test.tsv", rows[500:])
    kw = dict(source="movielens", path=train, splitter=splitter, seed=2,
              test_path=test if splitter == "given" else None,
              binarize_threshold=0.0 if splitter == "given" else 3.0,
              min_interactions=1 if splitter == "given" else 2)
    got, want = build_dataset(DataConfig(**kw)), jax_build_dataset(JaxDataConfig(**kw))
    assert (got.num_users, got.num_items) == (want.num_users, want.num_items)
    for part in ("train", "test"):
        a, b = getattr(got, part), getattr(want, part)
        for field in ("users", "items", "ratings", "times"):
            assert getattr(a, field).dtype == getattr(b, field).dtype
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    if splitter == "given":
        assert len(got.train) == 500 and len(got.test) == 100
        with pytest.raises(ValueError, match="test_path"):
            build_dataset(DataConfig(**{**kw, "test_path": None}))


def test_ml1m_side_feature_readers_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    users = tmp_path / "users.dat"
    users.write_text("".join(
        f"{u}::{'MF'[rng.integers(0, 2)]}::{rng.choice([1, 18, 25, 35, 45, 50, 56])}::"
        f"{rng.integers(0, 21)}::{rng.integers(10000, 99999)}\n" for u in range(1, 200))
        + "bad line\n", encoding="latin-1")
    genres = ["Action", "Comedy", "Drama", "Children's", "Film-Noir"]
    movies = tmp_path / "movies.dat"
    movies.write_text("".join(
        f"{m}::Title {m} (1999)::{'|'.join(rng.choice(genres, rng.integers(1, 3), replace=False))}\n"
        for m in range(1, 150)) + "no genres\n", encoding="latin-1")
    got, want = movielens.load_ml1m_user_features(str(users)), \
        jax_movielens.load_ml1m_user_features(str(users))
    assert got[1] == want[1] and got[0].keys() == want[0].keys()
    for uid in want[0]:
        assert got[0][uid].dtype == want[0][uid].dtype
        np.testing.assert_array_equal(got[0][uid], want[0][uid])
    assert movielens.load_ml1m_item_genres(str(movies)) == \
        jax_movielens.load_ml1m_item_genres(str(movies))
