"""Kill and resume in the port's fit, against the uninterrupted fit.

The counterpart of tests/test_resume.py for `Trainer.fit` of the port
(training/trainer.py, training/checkpoint.py `save_run_state` /
`load_run_state`), on the 50-user synthetic set at the narrow widths of
tests/test_torch_common.py, two epochs:

  * fit A runs uninterrupted with an autosave after every call; fit B,
    the same, is killed right after its n-th autosave (mid-epoch, or at
    the epoch boundary); fit C, a fresh trainer on B's model_dir,
    resumes with `fit(resume=True)`.  C's final state (every model and
    optimizer tensor), its valid metrics from the resumed epoch on and
    its best epoch equal A's bit for bit: resident with K = 2 steps a
    call under lazyadam, streamed with K = 1 (dense Adam) and K = 3;
  * the run state round trip: the RandomState's MT19937 state as JAX
    saves it, the generator state, the layout;
  * `resume=True` without an autosave starts fresh, and without
    model_dir raises; a finished fit removes its autosave;
  * the refusals of a resume in the other mode (resident / streamed)
    and under length_buckets carry JAX's messages, read from JAX's
    `Trainer.fit` on the same autosave.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from clsr_tpu.data.loader import SequenceLoader as JaxLoader
from clsr_tpu.data.parser import parse_file as jax_parse_file
from clsr_tpu.data.vocab import load_vocab as jax_load_vocab
from clsr_tpu.training.checkpoint import load_run_state as jax_load_run
from clsr_tpu.training.trainer import Trainer as JaxTrainer
from clsr_tpu_torch.config import load_config
from clsr_tpu_torch.data.loader import SequenceLoader
from clsr_tpu_torch.data.parser import parse_file
from clsr_tpu_torch.data.synthetic import write_synthetic_dataset
from clsr_tpu_torch.data.vocab import load_vocab
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.training import checkpoint
from clsr_tpu_torch.training.lazy_adam import LazyAdamState
from clsr_tpu_torch.training.trainer import Trainer

from test_torch_common import small_jax_cfg

L = 10
SPLITS = ("train", "valid")
FIT = dict(max_seq_length=L, batch_size=64, epochs=2, show_step=0,
           valid_num_ngs=4, save_model=True, early_stop=0,
           contrastive_length_threshold=2, autosave_every_calls=1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = tmp_path_factory.mktemp("resume")
    paths = write_synthetic_dataset(str(out), valid_num_ngs=4,
                                    test_num_ngs=4)
    pv = [load_vocab(paths[f"{n}_vocab"]) for n in ("user", "item", "cate")]
    port = {s: SequenceLoader(parse_file(paths[s], *pv), L) for s in SPLITS}
    return paths, pv, port


def _trainer(pv, model_dir, logs=None, **kw):
    cfg = load_config(None, **dict(
        dataclasses.asdict(small_jax_cfg(**FIT, model_dir=str(model_dir))),
        seed=5, **kw))
    model = get_model_class("clsr")(cfg, *map(len, pv), device="cpu")
    log = logs.append if logs is not None else (lambda *a: None)
    return Trainer(model, cfg, log=log)


def _tensors(state):
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    opt = state.optimizer
    dense = opt.dense_opt if isinstance(opt, LazyAdamState) else opt
    if isinstance(opt, LazyAdamState):
        out.update({f"moments/{k}": v for k, v in opt.moments.items()})
        out["count"] = opt.count
    for i, st in enumerate(dense.state_dict()["state"].values()):
        out.update({f"opt/{i}/{k}": v for k, v in st.items()})
    return out


class Killed(Exception):
    pass


MODES = {"resident_k2": dict(resident_data="on", train_steps_per_call=2,
                             optimizer="lazyadam"),
         "stream_k1": dict(resident_data="off", train_steps_per_call=1,
                           optimizer="adam"),
         "stream_k3": dict(resident_data="off", train_steps_per_call=3,
                           optimizer="lazyadam")}


@pytest.mark.parametrize("mode, kill_at", [
    ("resident_k2", 4), ("stream_k1", "boundary"), ("stream_k3", 2)])
def test_kill_and_resume_is_bit_identical(data, tmp_path, mode, kill_at):
    _, pv, port = data
    kw = MODES[mode]
    a = _trainer(pv, tmp_path / "a", **kw)
    a.fit(port["train"], port["valid"])
    assert not os.path.exists(tmp_path / "a" / "autosave")
    calls = a.epoch_stats[0]["steps"]
    if kw["train_steps_per_call"] > 1:
        K = kw["train_steps_per_call"]
        calls = calls // K + calls % K
    # the epoch boundary's autosave follows the first epoch's calls
    n_kill = calls + 1 if kill_at == "boundary" else kill_at
    assert n_kill <= calls + 1

    b = _trainer(pv, tmp_path / "b", **kw)
    name = "_autosave" if kw["resident_data"] == "on" else "_autosave_stream"
    save, seen = getattr(b, name), []

    def kill(*args, **kwargs):
        save(*args, **kwargs)
        seen.append(args[1])
        if len(seen) == n_kill:
            raise Killed
    setattr(b, name, kill)
    with pytest.raises(Killed):
        b.fit(port["train"], port["valid"])
    assert seen[-1] == (0 if kill_at == "boundary" else kill_at)

    logs = []
    c = _trainer(pv, tmp_path / "b", logs, **kw)
    c.fit(port["train"], port["valid"], resume=True)
    epoch = 2 if kill_at == "boundary" else 1
    assert f"resuming at epoch {epoch}, call {seen[-1]}" in " ".join(logs)
    assert not os.path.exists(tmp_path / "b" / "autosave")
    want = dict(a.eval_history)
    assert [e for e, _ in c.eval_history] == list(range(epoch, 3))
    for e, res in c.eval_history:
        assert res == want[e], e
    assert c.best_epoch == a.best_epoch
    got, ref = _tensors(c.state), _tensors(a.state)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    assert c.state.step == a.state.step


def test_run_state_round_trip(tmp_path):
    np_rng = np.random.RandomState(3)
    np_rng.randn(7)                 # a cached gaussian in the state
    g = torch.Generator().manual_seed(9)
    torch.rand(5, generator=g)
    perm = np.arange(12, dtype=np.int32)[::-1].copy()
    checkpoint.save_run_state(
        str(tmp_path), epoch=2, calls_done=5, step=17, generator=g,
        np_rng=np_rng, perm=perm, n_use=11, n_calls=3, n_tail=1,
        total=1.5, data_total=0.0, best_metric=0.75, best_epoch=1)
    got = checkpoint.load_run_state(str(tmp_path))
    want_mt = np_rng.get_state()
    got_mt = got["np_rng"].get_state()
    assert got_mt[0] == want_mt[0] and got_mt[2:] == want_mt[2:]
    np.testing.assert_array_equal(got_mt[1], want_mt[1])
    assert torch.equal(got["rng"], g.get_state())
    np.testing.assert_array_equal(got["perm"], perm)
    assert {k: got[k] for k in ("epoch", "calls_done", "step", "n_use",
                                "n_calls", "n_tail", "total",
                                "best_metric", "best_epoch", "mode")} == dict(
        epoch=2, calls_done=5, step=17, n_use=11, n_calls=3, n_tail=1,
        total=1.5, best_metric=0.75, best_epoch=1, mode="resident")
    # JAX's reader takes the same file: the same RandomState, the layout
    jax_got = jax_load_run(str(tmp_path))
    assert jax_got["np_rng"].randn() == got["np_rng"].randn()
    assert (jax_got["calls_done"], jax_got["n_calls"]) == (5, 3)
    assert checkpoint.load_run_state(str(tmp_path / "none")) is None


def test_resume_without_autosave_starts_fresh(data, tmp_path):
    _, pv, port = data
    logs = []
    t = _trainer(pv, tmp_path, logs, epochs=1, autosave_every_calls=0)
    t.fit(port["train"], port["valid"], resume=True)
    assert any("no autosave found" in line for line in logs)
    assert t.eval_history
    t = _trainer(pv, tmp_path, epochs=1, autosave_every_calls=0)
    t.cfg = t.cfg.replace(model_dir=None)
    with pytest.raises(ValueError, match="resume requires model_dir"):
        t.fit(port["train"], port["valid"], resume=True)


@pytest.fixture(scope="module")
def jax_trainer(data):
    """JAX's Trainer as far as fit's resume branch reads it (its config,
    log and mesh); the branch raises before any model is needed."""
    paths, _, _ = data
    jv = [jax_load_vocab(paths[f"{n}_vocab"])
          for n in ("user", "item", "cate")]
    loaders = {s: JaxLoader(jax_parse_file(paths[s], *jv), L)
               for s in SPLITS}
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.cfg = small_jax_cfg(**FIT, model_dir="unused")
    jt.log, jt._mesh, jt._hist_step = (lambda *a: None), None, None
    return jt, loaders


@pytest.mark.parametrize("saved, run", [
    ("stream", dict(resident_data="on")),
    ("resident", dict(resident_data="off")),
    ("resident", dict(resident_data="on", length_buckets="auto",
                      autosave_every_calls=0))])
def test_resume_refusals_match_jax(data, jax_trainer, tmp_path, saved, run):
    _, pv, port = data
    jt, jax_loaders = jax_trainer
    auto = tmp_path / "autosave"
    checkpoint.save_run_state(
        str(auto), epoch=1, calls_done=2, step=2,
        generator=torch.Generator(), np_rng=np.random.RandomState(0),
        perm=np.zeros(0, np.int32), n_use=0, n_calls=-1, n_tail=0,
        total=0.0, data_total=0.0, best_metric=0.0, best_epoch=0,
        mode=saved)
    jt.cfg = jt.cfg.replace(model_dir=str(tmp_path), **run)
    with pytest.raises(ValueError) as want:
        jt.fit(jax_loaders["train"], jax_loaders["valid"], resume=True)
    t = _trainer(pv, tmp_path, **run)
    with pytest.raises(ValueError) as got:
        t.fit(port["train"], port["valid"], resume=True)
    assert str(got.value) == str(want.value)
    assert "length_buckets" in str(got.value) or "path" in str(got.value)
