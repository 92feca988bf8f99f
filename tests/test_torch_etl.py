"""The port's ETL (clsr_tpu_torch/data/etl.py) against the JAX package's
pandas ETL (clsr_tpu/data/etl.py), all exact.

On small raw logs written here from a seed, in the public files'
schemas: a Taobao UserBehavior.csv (uid,iid,category,behavior,ts, no
header) with other behaviours, ties in time, items of two categories and
rows outside the date window; a Kuaishou log with a header, the five
named columns and extra ones (a float column with empty fields, a text
column):

  * `read_csv` against pd.read_csv: values and dtypes, by the C++ reader
    and by the csv-module route (a quoted field);
  * each filter and each `*_main` against JAX's, and the RandomState's
    next draw after `taobao_main`, `get_sampled_data` and
    `negative_sampling_offline`;
  * `data_preprocessing` for both sets, expanding (engines python and
    native, two worker processes) and not: the three TSVs and the three
    vocab pickles byte-identical to JAX's for the same seed and engine;
  * the native engine's fallback to Python on text ids, as JAX's
    tests/test_etl.py tests it, and its files equal to JAX's.
"""

import filecmp
import os
import time

import numpy as np
import pandas as pd
import pytest
import torch

from clsr_tpu import native as jax_native
from clsr_tpu.data import etl as jax_etl
from clsr_tpu_torch.data import etl

# Six xdist workers, each with torch's default intra-op pool (a thread a
# core), oversubscribe the cores several times over; under xdist a
# worker keeps one thread.  Run alone (or on the card) torch keeps its
# default.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CLAMP_LO, CLAMP_HI = 1511568000, 1512345599   # the window in UTC
TAOBAO = ["uid", "iid", "category", "behavior", "ts"]
KUAISHOU_HEADER = ("user_id,photo_id,time_ms,photo_kmeans_cluster_id,"
                   "effective_view,play_time,tag")


def write_taobao(path, n_users=800, seed=0):
    """A seeded UserBehavior.csv: 18-30 events a user over 29 items (item
    iid's category iid % 7 + 1; items 27 and 28 also carry category 99),
    hourly timestamps (ties within a user), ~2% of rows outside the
    window, ~10% cart / fav / buy rows."""
    rng = np.random.RandomState(seed)
    lines = []
    for uid in range(1, n_users + 1):
        n = rng.randint(18, 31)
        ts = CLAMP_LO + 3600 * rng.randint(0, 9 * 24, n)
        out = rng.uniform(size=n) < 0.02
        ts[out] += np.where(rng.uniform(size=out.sum()) < 0.5, -86400 * 3,
                            86400 * 12)
        for t in ts:
            iid = rng.randint(1, 30)
            cate = 99 if iid >= 27 and rng.uniform() < 0.3 else iid % 7 + 1
            beh = rng.choice(["pv", "pv", "pv", "pv", "pv", "pv", "pv",
                              "pv", "pv", "cart", "fav", "buy"])
            lines.append(f"{uid},{iid},{cate},{beh},{t}\n")
    with open(path, "w") as f:
        f.writelines(lines)
    return str(path)


def write_kuaishou(path, n_users=300, seed=1, quoted=False):
    """A seeded Kuaishou log with a header: 20-40 events a user over 60
    photos (cluster photo % 9), ~60% effective views, millisecond times
    over six days, and two extra columns (play_time with empty fields,
    a text tag)."""
    rng = np.random.RandomState(seed)
    t0 = 1_600_000_000_000
    lines = [KUAISHOU_HEADER + "\n"]
    for uid in range(1, n_users + 1):
        n = rng.randint(20, 41)
        ts = np.sort(t0 + rng.randint(0, 6 * 86400 * 1000, n))
        for t in ts:
            photo = rng.randint(1, 61)
            ev = int(rng.uniform() < 0.6)
            play = "" if rng.uniform() < 0.1 else f"{rng.uniform() * 30:.3f}"
            tag = f'"t,{photo % 4}"' if quoted else f"t{photo % 4}"
            lines.append(f"{uid},{photo},{t},{photo % 9},{ev},{play},{tag}\n")
    with open(path, "w") as f:
        f.writelines(lines)
    return str(path)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    d = tmp_path_factory.mktemp("raw")
    return {"taobao": write_taobao(d / "UserBehavior.csv"),
            "kuaishou": write_kuaishou(d / "kuaishou.csv"),
            "kuaishou_quoted": write_kuaishou(d / "kq.csv", quoted=True)}


def cols_of(df):
    return {c: df[c].to_numpy() for c in df.columns}


def assert_cols_equal(got, want_df, names=None):
    want = cols_of(want_df)
    names = names or list(want)
    assert list(got) == names
    for name in names:
        g, w = np.asarray(got[name]), want[name]
        assert len(g) == len(w), name
        if w.dtype.kind == "O":
            assert [str(x) for x in g] == [str(x) for x in w], name
        else:
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=name)


def same_next_draw(a, b):
    return a.randint(2 ** 31 - 1) == b.randint(2 ** 31 - 1)


# ----------------------------------------------------------------- reading

@pytest.mark.parametrize("name", ["taobao", "kuaishou", "kuaishou_quoted"])
def test_read_csv_matches_pandas(raw, name):
    if name == "taobao":
        got = etl.read_csv(raw[name], names=TAOBAO, strings=("behavior",))
        want = pd.read_csv(raw[name], header=None, names=TAOBAO)
    else:
        got = etl.read_csv(raw[name])
        want = pd.read_csv(raw[name], header=0)
    assert list(got) == list(want.columns)
    for c in want.columns:
        w = want[c].to_numpy()
        g = got[c]
        if w.dtype.kind in "iuf":
            assert g.dtype == w.dtype, c
            np.testing.assert_array_equal(g, w, err_msg=c)
        else:
            assert g.tolist() == [str(x) for x in w], c


def test_read_csv_usecols_and_missing_column(raw):
    got = etl.read_csv(raw["kuaishou"], usecols=["time_ms", "user_id"])
    want = pd.read_csv(raw["kuaishou"], header=0)
    assert list(got) == ["time_ms", "user_id"]
    np.testing.assert_array_equal(got["time_ms"], want["time_ms"])
    with pytest.raises(KeyError, match="no column"):
        etl.read_csv(raw["kuaishou"], usecols=["nope"])


# ----------------------------------------------------------------- filters

def _frame(rng, n=400):
    return pd.DataFrame({"uid": rng.randint(0, 40, n),
                         "iid": rng.randint(0, 25, n),
                         "category": rng.randint(0, 4, n)})


@pytest.mark.parametrize("k, col, count", [(2, "uid", "iid"),
                                           (17, "iid", "uid"),
                                           (40, "uid", "iid")])
def test_filter_k_core_matches_jax(k, col, count):
    df = _frame(np.random.RandomState(k))
    got = etl.filter_k_core(cols_of(df), k, col, count)
    assert_cols_equal(got, jax_etl.filter_k_core(df, k, col, count))


def test_filter_k_core_counts_non_null():
    df = pd.DataFrame({"uid": [1, 1, 1, 2, 2, 2],
                       "x": [1.0, np.nan, 2.0, 1.0, 2.0, 3.0]})
    got = etl.filter_k_core(cols_of(df), 3, "uid", "x")
    assert_cols_equal(got, jax_etl.filter_k_core(df, 3, "uid", "x"))
    assert got["uid"].tolist() == [2, 2, 2]


def test_filter_multiple_cids_matches_jax():
    df = _frame(np.random.RandomState(3), 60)
    got = etl.filter_items_with_multiple_cids(cols_of(df))
    assert_cols_equal(got, jax_etl.filter_items_with_multiple_cids(df))
    assert 0 < len(got["iid"]) < 60


@pytest.mark.parametrize("frac", [0.05, 0.5, 0.3])
def test_downsample_matches_jax_and_leaves_the_rng(frac):
    df = _frame(np.random.RandomState(4), 500)
    ra, rb = np.random.RandomState(9), np.random.RandomState(9)
    got = etl.downsample(cols_of(df), "uid", frac, ra)
    assert_cols_equal(got, jax_etl.downsample(df, "uid", frac, rb))
    assert same_next_draw(ra, rb)


# ------------------------------------------------------------ dataset mains

def test_taobao_main_matches_jax(raw):
    ra, rb = np.random.RandomState(5), np.random.RandomState(5)
    stages = {}
    reviews, meta = etl.taobao_main(raw["taobao"], ra, stages)
    jr, jm = jax_etl.taobao_main(raw["taobao"], rb)
    assert_cols_equal(reviews, jr)
    assert_cols_equal(meta, jm)
    assert same_next_draw(ra, rb)
    assert len(reviews["uid"]) > 200 and set(stages) == {"read", "filters"}
    # the filters had work: items 27 and 28 (two categories) are gone,
    # every ts is inside the window
    assert not np.isin(reviews["iid"], [27, 28]).any()
    assert reviews["ts"].min() >= CLAMP_LO and reviews["ts"].max() <= CLAMP_HI


def test_kuaishou_main_matches_jax(raw):
    for name in ("kuaishou", "kuaishou_quoted"):
        reviews, meta = etl.kuaishou_main(raw[name])
        jr, jm = jax_etl.kuaishou_main(raw[name])
        assert_cols_equal(reviews, jr)
        assert_cols_equal(meta, jm)
        assert len(reviews["uid"]) > 1000


# ---------------------------------------------------------------- instances

@pytest.mark.parametrize("sample_rate", [1.0, 0.5, 0.2])
def test_instances_sampling_and_split_match_jax(raw, sample_rate):
    ra, rb = np.random.RandomState(6), np.random.RandomState(6)
    reviews, meta = etl.taobao_main(raw["taobao"], ra)
    jr, jm = jax_etl.taobao_main(raw["taobao"], rb)
    inst = etl.create_instances(reviews, meta)
    jinst = jax_etl.create_instances(jr, jm)
    assert_cols_equal(inst, jinst)
    inst = etl.get_sampled_data(inst, sample_rate, ra)
    jinst = jax_etl.get_sampled_data(jinst, sample_rate, rb)
    assert_cols_equal(inst, jinst)
    assert same_next_draw(ra, rb)
    splits = etl.split_global_time(inst, 24 * 3600)
    assert splits.tolist() == \
        jax_etl.split_global_time(jinst, 24 * 3600).tolist()
    assert set(splits.tolist()) == {"train", "valid", "test"}


def test_create_instances_default_category_and_ties():
    reviews = pd.DataFrame({"uid": [2, 1, 2, 1, 2], "iid": [5, 6, 7, 5, 6],
                            "ts": [30, 10, 30, 10, 20]})
    meta = pd.DataFrame({"iid": [5, 6], "category": [50, 60]})
    got = etl.create_instances(cols_of(reviews), cols_of(meta))
    assert_cols_equal(got, jax_etl.create_instances(reviews, meta))
    assert got["cate_id"].tolist()[-1] == "default_cat"


def test_split_global_time_matches_jax():
    df = pd.DataFrame({"timestamp": [0, 50, 100, 150, 190, 199, 200]})
    got = etl.split_global_time(cols_of(df), 50)
    assert got.tolist() == jax_etl.split_global_time(df, 50).tolist()


# ---------------------------------------------------------------- pipeline

def _files(d):
    return {k: str(d / k) for k in ("train_data", "valid_data", "test_data",
                                    "user_vocab.pkl", "item_vocab.pkl",
                                    "category_vocab.pkl")}


PIPELINES = {
    "taobao-python": dict(dataset="taobao"),
    "taobao-native": dict(dataset="taobao", engine="native"),
    "taobao-processes": dict(dataset="taobao", processes=2),
    "taobao-no-expanding": dict(dataset="taobao",
                                is_history_expanding=False),
    "taobao-sampled": dict(dataset="taobao", sample_rate=0.5),
    "kuaishou-python": dict(dataset="kuaishou"),
    "kuaishou-native": dict(dataset="kuaishou", engine="native"),
    "kuaishou-processes": dict(dataset="kuaishou", processes=2),
}


def load_jax_native(timeout_s=120.0):
    """Load JAX's native library before a comparison that needs it.

    clsr_tpu/native builds libfastparse.so with g++ into its final path
    on first use, with no lock across processes, so under xdist another
    worker may be writing the file when this one loads it; JAX's ETL
    then turns the failed load into a silent fall back to its Python
    engine, whose subsample draws differ from the native engine's.  So
    the load is retried here (a failed build once more: it may have
    raced another process's) until it succeeds or `timeout_s` passes."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            if jax_native.available():
                return
            reason = "its g++ build failed"
        except OSError as e:            # a half-written file
            reason = str(e)
        if time.monotonic() > deadline:
            raise AssertionError(f"JAX's native library did not load in "
                                 f"{timeout_s} s: {reason}")
        jax_native._build_failed = False
        time.sleep(0.5)


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_data_preprocessing_byte_identical_to_jax(raw, tmp_path, name,
                                                  monkeypatch):
    kw = dict(PIPELINES[name], valid_num_ngs=3, test_num_ngs=5, seed=11)
    native_runs = []
    if kw.get("engine") == "native":
        load_jax_native()
        expand = jax_etl._try_native_expand
        monkeypatch.setattr(jax_etl, "_try_native_expand", lambda *a, **k: (
            native_runs.append(expand(*a, **k)), native_runs[-1])[1])
    out = {}
    for side, fn in (("port", etl.data_preprocessing),
                     ("jax", jax_etl.data_preprocessing)):
        d = tmp_path / side
        d.mkdir()
        out[side] = _files(d)
        f = out[side]
        fn(raw[kw["dataset"]], f["train_data"], f["valid_data"],
           f["test_data"], f["user_vocab.pkl"], f["item_vocab.pkl"],
           f["category_vocab.pkl"], **kw)
    if kw.get("engine") == "native":
        assert native_runs and None not in native_runs, (
            "JAX's ETL fell back from its native engine to Python")
    for key in out["port"]:
        assert filecmp.cmp(out["port"][key], out["jax"][key],
                           shallow=False), key
    with open(out["port"]["train_data"]) as f:
        # without expanding, one line a user (the split of its last event)
        assert sum(1 for _ in f) > (50 if kw.get("is_history_expanding",
                                                 True) else 0)
    with open(out["port"]["test_data"]) as f:
        assert sum(1 for _ in f) % 6 == 0


def test_negative_sampling_offline_matches_jax_and_leaves_the_rng(
        raw, tmp_path):
    r = np.random.RandomState(2)
    reviews, meta = jax_etl.taobao_main(raw["taobao"], r)
    inst = jax_etl.create_instances(reviews, meta)
    splits = jax_etl.split_global_time(inst, 24 * 3600)
    paths = {}
    for side in ("port", "jax"):
        paths[side] = [str(tmp_path / f"{side}_{s}") for s in
                       ("train", "valid", "test")]
        jax_etl.generate_expanding(inst, splits, *paths[side],
                                   {"train": 1.0, "valid": 1.0, "test": 1.0},
                                   rng=np.random.RandomState(3))
    ra, rb = np.random.RandomState(8), np.random.RandomState(8)
    etl.negative_sampling_offline(cols_of(inst), *paths["port"][1:],
                                  valid_num_ngs=4, test_num_ngs=12, rng=ra)
    jax_etl.negative_sampling_offline(inst, *paths["jax"][1:],
                                      valid_num_ngs=4, test_num_ngs=12,
                                      rng=rb)
    for a, b in zip(paths["port"], paths["jax"]):
        assert filecmp.cmp(a, b, shallow=False)
    assert same_next_draw(ra, rb)


def test_negative_sampling_refuses_a_too_small_pool(tmp_path):
    inst = {"item_id": np.array([1, 2, 2]), "cate_id": np.array([1, 1, 1])}
    p = tmp_path / "v"
    p.write_text("1\tu\t1\t1\t5\t2\t1\t4\n")
    with pytest.raises(ValueError, match="distinct negatives"):
        etl.negative_sampling_offline(inst, str(p), str(p), 2, 2,
                                      np.random.RandomState(0))


def test_native_expand_falls_back_on_string_ids(tmp_path, caplog):
    """Text user/item ids do not convert to int64: the Python engine
    runs (and says so), and its file equals JAX's."""
    df = pd.DataFrame({
        "user_id": ["uA", "uA", "uA", "uB", "uB", "uB"],
        "item_id": ["i1", "i2", "i3", "i2", "i4", "i5"],
        "cate_id": ["c1", "c1", "c2", "c1", "c2", "c2"],
        "timestamp": [10, 20, 30, 15, 25, 35],
    })
    splits = pd.Series(["train"] * 6)
    out = {s: str(tmp_path / s) for s in ("tr", "va", "te", "jtr", "jva",
                                          "jte")}
    with caplog.at_level("INFO", logger=etl.__name__):
        etl.generate_expanding(
            {c: np.asarray(df[c].tolist()) for c in df.columns},
            splits.to_numpy(), out["tr"], out["va"], out["te"],
            {"train": 1.0}, rng=np.random.RandomState(0), engine="native")
    assert "Python engine" in caplog.text
    lines = open(out["tr"]).read().splitlines()
    assert len(lines) == 4                      # 2 users x (3-1) events
    assert lines[0].split("\t")[1] == "uA"      # string ids intact
    jax_etl.generate_expanding(df, splits, out["jtr"], out["jva"],
                               out["jte"], {"train": 1.0},
                               rng=np.random.RandomState(0), engine="native")
    assert filecmp.cmp(out["tr"], out["jtr"], shallow=False)


def test_native_engine_equals_the_python_train_split(raw, tmp_path):
    """The C++ engine's train file equals the Python engine's (the train
    split draws nothing)."""
    r = np.random.RandomState(1)
    inst = etl.create_instances(*etl.taobao_main(raw["taobao"], r))
    splits = etl.split_global_time(inst, 24 * 3600)
    sub = {"train": 1.0, "valid": 0.2, "test": 0.2}
    p = {e: [str(tmp_path / f"{e}_{s}") for s in range(3)]
         for e in ("python", "native")}
    for engine in p:
        etl.generate_expanding(inst, splits, *p[engine], sub,
                               rng=np.random.RandomState(3), engine=engine)
    assert filecmp.cmp(p["python"][0], p["native"][0], shallow=False)
