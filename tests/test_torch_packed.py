"""The port's packed format (clsr_tpu_torch/data/packed.py) against the
JAX package's (clsr_tpu/data/packed.py), and against the port's own TSV
path.

On a seeded instance stream shaped like `create_instances`' output (as
JAX's tests/test_packed.py:30-56 makes it), all exact:

  * `build_packed`: every array, the three vocabs and the RandomState's
    next draw equal JAX's for the same seed;
  * `PackedView` of each split (and with `recent_k`), every `make_loader`
    batch (train, the stacked K-step epoch, grouped eval, per-row
    predict) and `build_interaction_graph_packed`'s edges equal JAX's;
  * a pack saved by either package loads in the other;
  * against the port's TSV path on the same stream and seed: the vocabs,
    the train view, the eval views' shared fields, the grouped eval
    metrics through the strided view with the TSV's negatives, and a
    resident fit on the packed loader against one on the TSV loader,
    bit for bit;
  * the port's CLI from a raw Taobao-format CSV with `--etl_format
    packed`, then `--only_test` (the same test dict), on the CPU; its
    pack equals JAX's `data_preprocessing` pack for the seed.
"""

import ast
import copy
import dataclasses
import os

import numpy as np
import pandas as pd
import pytest
import torch

from clsr_tpu.data import packed as jax_packed
from clsr_tpu.data.etl import data_preprocessing as jax_data_preprocessing
from clsr_tpu_torch import cli
from clsr_tpu_torch.config import load_config
from clsr_tpu_torch.data import etl, packed
from clsr_tpu_torch.data.loader import SequenceLoader
from clsr_tpu_torch.data.parser import parse_file, time_range_for_unit
from clsr_tpu_torch.data.vocab import load_vocab
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.training.evaluator import run_weighted_eval
from clsr_tpu_torch.training.trainer import Trainer
from test_torch_common import small_jax_cfg

# Six xdist workers, each with torch's default intra-op pool (a thread a
# core), oversubscribe the cores several times over; under xdist a
# worker keeps one thread.  Run alone (or on the card) torch keeps its
# default.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SUBSAMPLE = {"train": 1.0, "valid": 0.5, "test": 0.5}
L, TR = 12, time_range_for_unit("s")
NGS = {"valid": 3, "test": 5}
FIELDS = ("users", "items", "cates", "labels", "lengths", "item_hist",
          "cate_hist", "mask", "time_diff", "time_from_first", "time_to_now")


def _instances(n_users=30, n_items=60, n_cates=8, seed=11, min_events=12,
               max_events=30):
    """A stream sorted by (uid, ts) with integer ids and second times."""
    rng = np.random.RandomState(seed)
    cols = {k: [] for k in ("user_id", "item_id", "cate_id", "timestamp")}
    t0 = 1_500_000_000
    for u in range(1, n_users + 1):
        n_ev = rng.randint(min_events, max_events)
        t = t0 + np.cumsum(rng.randint(10, 50_000, size=n_ev))
        items = rng.randint(1, n_items + 1, size=n_ev)
        cols["user_id"] += [u] * n_ev
        cols["item_id"] += items.tolist()
        cols["cate_id"] += (items % n_cates + 1).tolist()
        cols["timestamp"] += t.tolist()
    out = {k: np.asarray(v, np.int64) for k, v in cols.items()}
    out["label"] = np.ones(len(out["user_id"]), np.int64)
    return out


def _splits(inst):
    t = inst["timestamp"]
    hi, mid = np.quantile(t, 0.9), np.quantile(t, 0.8)
    return np.where(t >= hi, "test", np.where(t >= mid, "valid", "train"))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The port's and JAX's packs of one stream and seed, and the port's
    TSV path from the same."""
    out = tmp_path_factory.mktemp("packed")
    inst = _instances()
    splits = _splits(inst)
    ra, rb = np.random.RandomState(5), np.random.RandomState(5)
    pack, vocabs = packed.build_packed(
        inst, splits, SUBSAMPLE, rng=ra, valid_num_ngs=NGS["valid"],
        test_num_ngs=NGS["test"])
    jpack, jvocabs = jax_packed.build_packed(
        pd.DataFrame(inst), pd.Series(splits), SUBSAMPLE, rng=rb,
        valid_num_ngs=NGS["valid"], test_num_ngs=NGS["test"])
    paths = {s: str(out / f"{s}_data") for s in ("train", "valid", "test")}
    etl.generate_expanding(inst, splits, paths["train"], paths["valid"],
                           paths["test"], SUBSAMPLE,
                           rng=np.random.RandomState(5))
    vpaths = {v: str(out / f"{v}_vocab.pkl") for v in ("user", "item",
                                                       "cate")}
    etl.create_vocab(paths["train"], vpaths["user"], vpaths["item"],
                     vpaths["cate"])
    etl.negative_sampling_offline(inst, paths["valid"], paths["test"],
                                  valid_num_ngs=NGS["valid"],
                                  test_num_ngs=NGS["test"],
                                  rng=np.random.RandomState(6))
    tsv_vocabs = [load_vocab(vpaths[v]) for v in ("user", "item", "cate")]
    return dict(inst=inst, splits=splits, pack=pack, vocabs=vocabs,
                jpack=jpack, jvocabs=jvocabs, rngs=(ra, rb), paths=paths,
                tsv_vocabs=tsv_vocabs)


def _pack_arrays(p):
    out = {k: getattr(p, k) for k in ("ev_user", "ev_item", "ev_cate",
                                      "ev_time", "group_offsets")}
    for name, s in p.splits.items():
        for f in ("line_group", "line_k", "neg_item", "neg_cate"):
            out[f"{name}_{f}"] = getattr(s, f)
    return out


def _assert_packs_equal(a, b):
    pa, pb = _pack_arrays(a), _pack_arrays(b)
    assert list(pa) == list(pb)
    for k in pa:
        if pb[k] is None:
            assert pa[k] is None, k
            continue
        assert pa[k].dtype == pb[k].dtype, k
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


def test_build_packed_matches_jax(both):
    _assert_packs_equal(both["pack"], both["jpack"])
    for v, jv in zip(both["vocabs"], both["jvocabs"]):
        assert list(v.mapping.items()) == list(jv.mapping.items())
    ra, rb = both["rngs"]
    assert ra.randint(2 ** 31 - 1) == rb.randint(2 ** 31 - 1)
    assert both["pack"].splits["test"].num_ngs == NGS["test"]
    assert both["pack"].nbytes() == both["jpack"].nbytes()


def _view_rows(view):
    rows = np.arange(view.n_rows)
    return {f: np.asarray(getattr(view, f)[rows]) for f in FIELDS}


@pytest.mark.parametrize("split, recent_k", [
    ("train", None), ("valid", None), ("test", None), ("train", 5),
    ("test", 4)])
def test_packed_view_matches_jax(both, split, recent_k):
    got = packed.PackedView(both["pack"], split, L, TR, recent_k)
    want = jax_packed.PackedView(both["jpack"], split, L, TR, recent_k)
    assert (got.n_rows, got.group) == (want.n_rows, want.group)
    g, w = _view_rows(got), _view_rows(want)
    for f in FIELDS:
        assert g[f].dtype == w[f].dtype, f
        np.testing.assert_array_equal(g[f], w[f], err_msg=f)


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            np.testing.assert_array_equal(getattr(g, f.name),
                                          getattr(w, f.name),
                                          err_msg=f.name)


def test_make_loader_batches_match_jax(both):
    port = {s: packed.make_loader(both["pack"], s, L, TR)
            for s in ("train", "valid", "test")}
    jax_l = {s: jax_packed.make_loader(both["jpack"], s, L, TR)
             for s in ("train", "valid", "test")}
    for epoch in range(2):
        _assert_batches_equal(
            port["train"].train_batches(16, np.random.RandomState(epoch)),
            jax_l["train"].train_batches(16, np.random.RandomState(epoch)))
    _assert_batches_equal(
        port["train"].train_batches_stacked(8, 3, np.random.RandomState(4)),
        jax_l["train"].train_batches_stacked(8, 3, np.random.RandomState(4)))
    for s in ("valid", "test"):
        G = NGS[s] + 1
        _assert_batches_equal(port[s].eval_batches(G, 4),
                              jax_l[s].eval_batches(G, 4))
    _assert_batches_equal(port["test"].eval_batches(1, 8),
                          jax_l["test"].eval_batches(1, 8))


def test_graph_from_pack_matches_jax(both):
    n_users, n_items = len(both["vocabs"][0]), len(both["vocabs"][1])
    pg = packed.build_interaction_graph_packed(both["pack"], n_users,
                                               n_items)
    jg = jax_packed.build_interaction_graph_packed(both["jpack"], n_users,
                                                   n_items)
    assert (pg.n_users, pg.n_items) == (jg.n_users, jg.n_items)
    order = np.lexsort((jg.dst, jg.src))
    for f in ("src", "dst", "weight"):
        g, w = getattr(pg, f), getattr(jg, f)[order]
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    np.testing.assert_array_equal(pg.item2cate, jg.item2cate)


def test_pack_saved_by_either_loads_in_the_other(both, tmp_path):
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    both["pack"].save(a)
    both["jpack"].save(b)
    _assert_packs_equal(jax_packed.load_packed(a), both["jpack"])
    _assert_packs_equal(packed.load_packed(b), both["pack"])
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        assert int(za["format_version"]) == packed._FORMAT_VERSION == 1


def test_packed_refuses_a_newer_format(both, tmp_path):
    p = str(tmp_path / "new.npz")
    both["pack"].save(p)
    with np.load(p) as z:
        arrays = dict(z)
    arrays["format_version"] = np.int64(2)
    np.savez(p, **arrays)
    with pytest.raises(ValueError, match="format version 2"):
        packed.load_packed(p)


# ------------------------------------------------ against the TSV path

def test_packed_equals_the_tsv_path(both):
    for v, tv in zip(both["vocabs"], both["tsv_vocabs"]):
        assert list(v.mapping.items()) == list(tv.mapping.items())
    for split, recent_k in (("train", None), ("train", 5), ("valid", None)):
        ds = parse_file(both["paths"][split], *both["tsv_vocabs"],
                        time_unit="s", recent_k=recent_k)
        ref = SequenceLoader(ds, L).view
        got = packed.make_loader(both["pack"], split, L, TR,
                                 recent_k=recent_k).view
        rows = np.arange(got.n_rows)
        assert got.n_rows == len(ref.labels)
        shared = FIELDS if split == "train" else (
            "users", "lengths", "labels", "item_hist", "cate_hist", "mask",
            "time_diff", "time_from_first", "time_to_now")
        for f in shared:
            np.testing.assert_array_equal(getattr(got, f)[rows],
                                          getattr(ref, f), err_msg=f)


def _small_cfg(vocabs, **kw):
    base = dataclasses.asdict(small_jax_cfg(max_seq_length=L))
    base.update(dict(batch_size=16, train_steps_per_call=1, epochs=1,
                     valid_num_ngs=NGS["valid"], test_num_ngs=NGS["test"],
                     save_model=False, show_step=0, embed_l2=1e-4,
                     layer_l2=1e-4, contrastive_length_threshold=2), **kw)
    return load_config(None, **base)


def test_strided_eval_and_resident_fit_equal_the_tsv_path(both):
    """The eval path on the strided view, with the TSV file's negatives
    put in the pack, gives the TSV path's metrics bit for bit; a resident
    fit (K = 2) on the packed train loader equals one on the TSV loader."""
    vocabs = both["tsv_vocabs"]
    ds = {s: parse_file(both["paths"][s], *vocabs, time_unit="s")
          for s in ("train", "valid")}
    tsv = {s: SequenceLoader(d, L) for s, d in ds.items()}
    pk = copy.deepcopy(both["pack"])
    G = NGS["valid"] + 1
    pk.splits["valid"].neg_item = ds["valid"].items.reshape(-1, G)[:, 1:] \
        .astype(np.int32)
    pk.splits["valid"].neg_cate = ds["valid"].cates.reshape(-1, G)[:, 1:] \
        .astype(np.int32)
    pkd = {s: packed.make_loader(pk, s, L, TR) for s in ("train", "valid")}
    cfg = _small_cfg(vocabs, resident_data="on", train_steps_per_call=2)
    sizes = tuple(map(len, vocabs))
    fits = {}
    for name, loaders in (("tsv", tsv), ("packed", pkd)):
        torch.manual_seed(0)
        model = get_model_class("clsr")(cfg, *sizes, device="cpu")
        t = Trainer(model, cfg, log=lambda *a: None)
        t.fit(loaders["train"], loaders["valid"])
        assert t.feeds is not None
        res = run_weighted_eval(t.eval_step, t.state.model,
                                loaders["valid"], cfg, NGS["valid"])
        fits[name] = (t.state.model.state_dict(), t.eval_history, res)
    (sa, ha, ra), (sb, hb, rb) = fits["tsv"], fits["packed"]
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert ha == hb and ra == rb


# ------------------------------------------------------------------- CLI

def _raw_taobao(path):
    """A dense Taobao-format log (15 items, 40-60 events a user) whose
    10-core filters survive any 5% user sample (JAX's
    test_cli_end_to_end_packed)."""
    inst = _instances(n_users=400, n_items=15, seed=2, min_events=40,
                      max_events=60)
    ts = 1511568000 + (inst["timestamp"] % (8 * 86400))
    with open(path, "w") as f:
        f.writelines(f"{u},{i},{c},pv,{t}\n" for u, i, c, t in zip(
            inst["user_id"], inst["item_id"], inst["cate_id"], ts))
    return str(path)


def test_cli_raw_csv_to_packed_then_only_test(tmp_path, capsys):
    raw = _raw_taobao(tmp_path / "raw.csv")
    args = ["--dataset", "taobao", "--model", "CLSR", "--epochs", "1",
            "--batch_size", "32", "--data_path", str(tmp_path / "run"),
            "--val_num_ngs", "2", "--test_num_ngs", "3", "--seed", "4",
            "--show_step", "0", "--device", "cpu"]
    assert cli.main(args + ["--raw_data", raw, "--etl_format", "packed"]) \
        == 0
    out = capsys.readouterr().out
    d = tmp_path / "run" / "taobao"
    assert (d / packed.PACKED_FILENAME).exists()
    assert not (d / "train_data").exists()
    assert "etl packed:" in out and "view test:" in out
    res = ast.literal_eval(out.strip().splitlines()[-1])
    assert 0.0 <= res["auc"] <= 1.0
    # --only_test reads the pack (no new ETL) and prints the same dict
    assert cli.main(args + ["--only_test"]) == 0
    out = capsys.readouterr().out
    assert "etl" not in out
    again = ast.literal_eval(out.strip().splitlines()[-1])
    assert {k: again[k] for k in res} == res and "mean_alpha" in again
    # the CLI's pack and vocabs are JAX's for the seed
    j = tmp_path / "jax"
    jax_data_preprocessing(
        raw, str(j / "train_data"), str(j / "valid_data"),
        str(j / "test_data"), str(j / "user_vocab.pkl"),
        str(j / "item_vocab.pkl"), str(j / "category_vocab.pkl"),
        valid_num_ngs=2, test_num_ngs=3, dataset="taobao", seed=4,
        output_format="packed")
    _assert_packs_equal(packed.load_packed(str(d / packed.PACKED_FILENAME)),
                        jax_packed.load_packed(str(j / "packed.npz")))
    for v in ("user_vocab.pkl", "item_vocab.pkl", "category_vocab.pkl"):
        assert (d / v).read_bytes() == (j / v).read_bytes(), v


def test_cli_refuses_a_pack_with_other_negatives(tmp_path):
    d = tmp_path / "taobao"
    etl.data_preprocessing(
        _raw_taobao(tmp_path / "raw.csv"), str(d / "train_data"),
        str(d / "valid_data"), str(d / "test_data"),
        str(d / "user_vocab.pkl"), str(d / "item_vocab.pkl"),
        str(d / "category_vocab.pkl"), valid_num_ngs=2, test_num_ngs=3,
        seed=1, output_format="packed")
    base = ["--dataset", "taobao", "--data_path", str(tmp_path),
            "--device", "cpu", "--val_num_ngs", "2"]
    with pytest.raises(SystemExit, match="has 3 negatives per line"):
        cli.main(base + ["--test_num_ngs", "5"])
    with pytest.raises(SystemExit, match="needs the TSV path"):
        cli.main(base + ["--data_format", "packed",
                         "--shuffle_history_seed", "3"])
    with pytest.raises(SystemExit, match="--raw_data"):
        cli.main(["--dataset", "kuaishou", "--data_path", str(tmp_path),
                  "--device", "cpu"])
