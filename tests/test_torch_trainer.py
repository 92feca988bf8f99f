"""The port's fit loop, checkpoints and CLI against the JAX package's.

On the 50-user synthetic set (valid 1 + 4, test 1 + 9 groups) at the
narrow widths of tests/test_torch_common.py:

  * two epochs of `Trainer.fit` with dense Adam against JAX's
    `Trainer.fit` (`resident_data: off`, `train_steps_per_call: 1`), both
    from the same weights (carried over by `weights.from_flax`) and the
    same RandomState shuffle.  The in-batch negatives differ by design
    (a torch.Generator against JAX's PRNG), so both step modules get the
    same deterministic ones: the negatives of row b are the positives of
    rows b + 1 ... b + k (mod the valid rows).  Both start from JAX's init
    perturbed as tests/test_torch_common.py does: at the init the scores
    are near ties, and the gradients that are zero by construction (a
    bias under train-mode BN, the output bias under the softmax) are
    rounding noise that Adam turns into steps of +-lr on either side, so
    near ties would reorder.  Per show_step the loss and
    data loss to 1e-4 relative (from scalars.jsonl, unrounded), per epoch
    each valid metric within 2e-4, the same best epoch;
  * `train_steps_per_call` K = 4 runs the same single steps as K = 1
    (the same parameters, bit for bit) and logs at the JAX stacked
    path's call boundaries;
  * a checkpoint round trip for dense Adam and for lazyadam, compact and
    legacy: the eval after `load_latest` into a fresh model equals the
    eval before the save exactly, model and optimizer state are equal,
    the tables equal pmn[:, :D], and one more step from each is
    bit-identical; `ScoringService.load_latest` scores the test groups
    as the eval step does, to 1e-6;
  * the CLI (`--device cpu`) end to end with `--write_prediction_to_file`,
    then `--only_test` printing the same test dict (every key exactly; as
    in the JAX CLI, `--only_test` adds `mean_alpha`), the counterpart of
    tests/test_cli_and_io.py:10; without `--device` and without a card it
    raises; every unported flag raises naming its ROADMAP item, and the
    flags of item 5 (resident data, length buckets) reach the Config;
  * the Trainer's refusals of unported settings; `resident_data: on`
    fits.
"""

import ast
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import clsr_tpu.training.steps as jax_steps
from clsr_tpu import cli as jax_cli
from clsr_tpu.data.loader import SequenceLoader as JaxLoader
from clsr_tpu.data.parser import parse_file as jax_parse_file
from clsr_tpu.data.vocab import load_vocab as jax_load_vocab
from clsr_tpu.models.registry import get_model_class as jax_model_class
from clsr_tpu.training.trainer import Trainer as JaxTrainer
import clsr_tpu_torch.training.steps as port_steps
from clsr_tpu_torch import cli, weights
from clsr_tpu_torch.config import load_config
from clsr_tpu_torch.data.loader import SequenceLoader
from clsr_tpu_torch.data.parser import parse_file
from clsr_tpu_torch.data.prefetch import to_device
from clsr_tpu_torch.data.synthetic import write_synthetic_dataset
from clsr_tpu_torch.data.vocab import load_vocab
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.ops import fused_scan as fs
from clsr_tpu_torch.serving import ScoreRequest, ScoringService
from clsr_tpu_torch.training import kernel_check
from clsr_tpu_torch.training.evaluator import run_weighted_eval
from clsr_tpu_torch.training.lazy_adam import LazyAdamState, is_pmn
from clsr_tpu_torch.training.trainer import Trainer
from clsr_tpu_torch.utils import summaries

from test_torch_common import (REPO, perturb, port_cfg, small_jax_cfg,
                               to_np)

L = 10
TEST_NGS = 9
SPLITS = ("train", "valid", "test")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = tmp_path_factory.mktemp("fit")
    paths = write_synthetic_dataset(str(out), valid_num_ngs=4,
                                    test_num_ngs=TEST_NGS)
    pv = [load_vocab(paths[f"{n}_vocab"]) for n in ("user", "item", "cate")]
    jv = [jax_load_vocab(paths[f"{n}_vocab"])
          for n in ("user", "item", "cate")]
    port = {s: SequenceLoader(parse_file(paths[s], *pv), L) for s in SPLITS}
    jax_l = {s: JaxLoader(jax_parse_file(paths[s], *jv), L) for s in SPLITS}
    return paths, pv, port, jax_l


def _sizes(pv):
    return tuple(map(len, pv))


# ------------------------------------------- deterministic negatives


def _neg_index(B, num_ngs, n_valid, arange, mod):
    return mod(arange(B)[:, None] + arange(1, num_ngs + 1)[None, :],
               n_valid)


def _jax_negatives(rng, batch, num_ngs):
    B = batch.items.shape[0]
    n_valid = jnp.maximum(batch.valid.sum().astype(jnp.int32), 1)
    idx = _neg_index(B, num_ngs, n_valid, jnp.arange, jnp.mod)
    pi, pc = batch.items[:, 0], batch.cates[:, 0]
    items = jnp.concatenate([pi[:, None], pi[idx]], axis=1)
    cates = jnp.concatenate([pc[:, None], pc[idx]], axis=1)
    labels = jnp.zeros(items.shape, jnp.float32).at[:, 0].set(1.0)
    return batch.replace(items=items, cates=cates, labels=labels)


def _port_negatives(generator, batch, num_ngs):
    B = batch.items.shape[0]
    n_valid = batch.valid.sum().to(torch.int64).clamp_min(1)
    idx = _neg_index(B, num_ngs, n_valid,
                     lambda *a: torch.arange(*a, device=batch.items.device),
                     torch.remainder)
    pi, pc = batch.items[:, 0], batch.cates[:, 0]
    items = torch.cat([pi[:, None], pi[idx]], dim=1)
    cates = torch.cat([pc[:, None], pc[idx]], dim=1)
    labels = torch.zeros(items.shape, dtype=torch.float32,
                         device=items.device)
    labels[:, 0] = 1.0
    return dataclasses.replace(batch, items=items, cates=cates,
                               labels=labels)


def _scalars(path):
    with open(os.path.join(path, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


# ------------------------------------------------ the fit trajectory

FIT = dict(max_seq_length=L, batch_size=64, epochs=2, show_step=2,
           train_steps_per_call=1, resident_data="off", valid_num_ngs=4,
           test_num_ngs=TEST_NGS, save_model=False, early_stop=10,
           contrastive_length_threshold=2, embed_l2=1e-4, layer_l2=1e-4)


def test_fit_trajectory_matches_jax(data, tmp_path, monkeypatch):
    _, pv, port, jax_l = data
    monkeypatch.setattr(jax_steps, "expand_with_negatives", _jax_negatives)
    monkeypatch.setattr(port_steps, "expand_with_negatives",
                        _port_negatives)
    jcfg = small_jax_cfg(**FIT, summaries_dir=str(tmp_path / "jax"))
    sizes = _sizes(pv)
    jmodel = jax_model_class("clsr")(cfg=jcfg, n_users=sizes[0],
                                     n_items=sizes[1], n_cates=sizes[2])
    sample = next(jax_l["train"].train_batches(jcfg.batch_size,
                                               np.random.RandomState(0)))
    jt = JaxTrainer(jmodel, jcfg, sample, log=lambda *a: None)
    rng = np.random.RandomState(7)
    jt.state = jt.state.replace(params=perturb(jt.state.params, rng),
                                batch_stats=perturb(jt.state.batch_stats,
                                                    rng))
    cfg = port_cfg(jcfg, summaries_dir=str(tmp_path / "port"))
    model = get_model_class("clsr")(cfg, *sizes, device="cpu")
    weights.from_flax(model, jt.state.params, jt.state.batch_stats)
    pt = Trainer(model, cfg, log=lambda *a: None)

    jt.fit(jax_l["train"], jax_l["valid"])
    pt.fit(port["train"], port["valid"])

    got, want = _scalars(tmp_path / "port"), _scalars(tmp_path / "jax")
    assert [r["step"] for r in got] == [r["step"] for r in want]
    n_logged = 0
    for g, w in zip(got, want):
        for key in set(w) - {"step", "time"}:
            assert key in g, key
            if key.startswith("valid/"):
                assert abs(g[key] - w[key]) <= 2e-4 + 1e-9, (g, w)
            else:
                n_logged += 1
                np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                           err_msg=f"{key} at {g['step']}")
    assert n_logged >= 2 * 2 * 5            # losses at >= 5 show_steps
    assert len(pt.eval_history) == len(jt.eval_history) == 2
    for (ep, g), (jep, w) in zip(pt.eval_history, jt.eval_history):
        assert ep == jep and g.keys() == w.keys()
        for k in g:
            assert abs(g[k] - w[k]) <= 2e-4 + 1e-9, (ep, k, g[k], w[k])
    assert pt.best_epoch == jt.best_epoch > 0
    assert [s["steps"] for s in pt.epoch_stats] == [
        len(list(port["train"].train_batches(64, np.random.RandomState(0))))
    ] * 2


def _port_trainer(pv, seed=3, log=None, **kw):
    cfg = load_config(None, **dict(
        dataclasses.asdict(small_jax_cfg(**FIT)), seed=seed, **kw))
    model = get_model_class("clsr")(cfg, *_sizes(pv), device="cpu")
    return Trainer(model, cfg, log=log or (lambda *a: None))


def test_steps_per_call_runs_the_same_single_steps(data, monkeypatch):
    _, pv, port, _ = data
    monkeypatch.setattr(port_steps, "expand_with_negatives",
                        _port_negatives)
    logs = {1: [], 4: []}
    trainers = {k: _port_trainer(pv, log=logs[k].append, epochs=1,
                                 show_step=3, train_steps_per_call=k)
                for k in logs}
    for t in trainers.values():
        t.fit(port["train"], port["valid"])
    one, four = (dict(trainers[k].model.state_dict()) for k in (1, 4))
    for name, value in one.items():
        torch.testing.assert_close(four[name], value, rtol=0, atol=0)
    n = trainers[1].epoch_stats[0]["steps"]
    grouped = (len(port["train"].view.labels) // 64) // 4 * 4
    calls = list(range(4, grouped + 1, 4)) + list(range(grouped + 1, n + 1))
    want = [s for p, s in zip([0] + calls, calls) if s // 3 > p // 3]
    steps = [int(line.split(",")[0].split()[1]) for line in logs[4]
             if line.startswith("step ")]
    assert steps == want and steps != [3 * i for i in range(1, n // 3 + 1)]


# ------------------------------------------------------- checkpoints

OPTIMIZERS = {"adam": dict(optimizer="adam"),
              "lazy_compact": dict(optimizer="lazyadam", compact_rows="auto"),
              "lazy_legacy": dict(optimizer="lazyadam", compact_rows="off")}


def _state_tensors(state):
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    opt = state.optimizer
    if isinstance(opt, LazyAdamState):
        out.update({f"moments/{k}": v for k, v in opt.moments.items()})
        dense = opt.dense_opt
    else:
        dense = opt
    for i, st in enumerate(dense.state_dict()["state"].values()):
        out.update({f"opt/{i}/{k}": v for k, v in st.items()})
    return out


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_checkpoint_round_trip(data, tmp_path, opt):
    _, pv, port, _ = data
    kw = dict(OPTIMIZERS[opt], model_dir=str(tmp_path / "model"),
              save_model=True, epochs=1)
    before = _port_trainer(pv, **kw)
    before.fit(port["train"], port["valid"])
    assert os.path.isdir(tmp_path / "model" / "epoch_1")
    evaluate = lambda t: run_weighted_eval(
        t.eval_step, t.state.model, port["test"], t.cfg, TEST_NGS,
        calc_mean_alpha=True)
    want = evaluate(before)

    after = _port_trainer(pv, seed=11, **kw)        # other weights
    assert evaluate(after) != want
    after.load_latest(kw["model_dir"])
    assert evaluate(after) == want
    got_t, want_t = _state_tensors(after.state), _state_tensors(before.state)
    assert got_t.keys() == want_t.keys()
    for k, v in want_t.items():
        torch.testing.assert_close(got_t[k], v, rtol=0, atol=0, msg=k)
    assert after.state.step == before.state.step > 0
    if opt.startswith("lazy"):
        assert after.state.optimizer.count == before.state.optimizer.count
        params = dict(after.model.named_parameters())
        for name, mn in after.state.optimizer.moments.items():
            assert is_pmn(params[name], mn) == (opt == "lazy_compact")
            if opt == "lazy_compact":
                torch.testing.assert_close(
                    params[name], mn[:, :params[name].shape[1]], rtol=0,
                    atol=0)
    batch = to_device(next(port["train"].train_batches(
        64, np.random.RandomState(5))), "cpu")
    for t in (before, after):
        t.state, _ = t.train_step(t.state, batch,
                                  torch.Generator().manual_seed(2))
    got_t, want_t = _state_tensors(after.state), _state_tensors(before.state)
    for k, v in want_t.items():
        torch.testing.assert_close(got_t[k], v, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_kernel_check_holds_the_plain_steps_to_themselves(data, opt):
    """kernel_check.compare_steps on CPU tensors, where both sides run
    the plain versions: every gate holds, no launch is counted, K5's
    groups (under lazyadam) agree with their plain version."""
    _, pv, port, _ = data
    t = _port_trainer(pv, use_pallas_scan=True,
                      use_pallas_train_attention="on", **OPTIMIZERS[opt])
    train = to_device(next(port["train"].train_batches(
        64, np.random.RandomState(0))), "cpu")
    test = to_device(next(port["test"].eval_batches(
        group_size=TEST_NGS + 1, batch_groups=6)), "cpu")
    res = kernel_check.compare_steps(t.cfg, t.state.model.state_dict(),
                                     _sizes(pv), train, test)
    assert kernel_check.failures(res) == []
    assert not res["bad_grads"] and res["grad_rel_err"] <= 1e-4
    assert all(n == 0 for counts in res["launches"].values()
               for n in counts.values())
    assert res["k5_groups"] == (opt != "adam")
    assert res["k5_identical"] is (True if opt != "adam" else None)
    assert (res["table_grad_rel_err"] is None) == (opt != "lazy_compact")
    assert np.isfinite(res["loss"])


def test_relu_sides_takes_the_recorded_side_of_each_kink():
    """ReluSides sees torch.relu, F.relu, Tensor.relu and nn.ReLU; a run
    under another run's masks takes that run's side of each kink, with
    its gradient; `kinks` counts the inputs that changed sign and how
    far apart they lie, and `failures` refuses a flip past KINK_ABS."""
    w = torch.tensor([2.0, 3.0, 5.0])

    def run(x, mode):
        x = x.clone().requires_grad_(True)
        with mode:
            y = (torch.relu(x) + F.relu(x) + x.relu()
                 + torch.nn.ReLU()(x)) @ w
        y.backward()
        return x.grad

    near = torch.tensor([1e-7, -2.0, 3.0])
    rec = kernel_check.ReluSides()
    want = run(near, rec)
    assert len(rec.inputs) == 4
    torch.testing.assert_close(want, 4 * torch.tensor([2.0, 0.0, 5.0]))
    for moved, n_kinks, far in ((-1e-7, 4, 2e-7), (-0.5, 4, 0.5)):
        x = torch.tensor([moved, -2.0, 3.0])
        other = kernel_check.ReluSides([t > 0 for t in rec.inputs])
        assert torch.equal(run(x, other), want)
        n, gap = kernel_check.kinks(rec.inputs, other.inputs)
        assert n == n_kinks and gap == pytest.approx(far, rel=1e-6)
        res = dict(score_err=0.0, loss_rel_err=0.0, bad_grads=[],
                   bn_err=0.0, k5_identical=None, kinks=n, kink_abs=gap)
        assert bool(kernel_check.failures(res)) == (far > 1e-4)
    assert not torch.equal(run(x, contextlib.nullcontext()), want)
    with pytest.raises(AssertionError, match="other ReLUs"):
        kernel_check.kinks(rec.inputs, rec.inputs[:3])


@pytest.mark.parametrize("fault", ["none", "backward", "forward"])
def test_kernel_check_same_kinks_fails_a_faulty_step(data, monkeypatch,
                                                     fault):
    """compare_steps with same_kinks on CPU tensors (both sides plain,
    the kernel side through fused_scan): every gate holds and no ReLU
    input changes sign; a backward with the Time4LSTM's input gradient
    1% off still fails the gradients' gate; a forward with its outputs
    moved by 1e-2 fails the kink gate."""
    _, pv, port, _ = data
    t = _port_trainer(pv, use_pallas_scan=True,
                      use_pallas_train_attention="off")
    train = to_device(next(port["train"].train_batches(
        64, np.random.RandomState(0))), "cpu")
    test = to_device(next(port["test"].eval_batches(
        group_size=TEST_NGS + 1, batch_groups=6)), "cpu")
    if fault == "backward":
        bwd = fs.scan_backward
        monkeypatch.setattr(fs, "scan_backward", lambda *a: (
            lambda g: g[:2] + (g[2] * 1.01,) + g[3:])(bwd(*a)))
    if fault == "forward":
        fwd = fs._forward
        monkeypatch.setattr(fs, "_forward", lambda *a, **kw: (
            lambda o: (o[0], o[1] + 1e-2 * a[8][..., None], o[2], o[3]))(
                fwd(*a, **kw)))
    res = kernel_check.compare_steps(t.cfg, t.state.model.state_dict(),
                                     _sizes(pv), train, test,
                                     same_kinks=True)
    bad = kernel_check.failures(res)
    assert res["relus"] > 0
    if fault == "none":
        assert bad == [] and res["kinks"] == 0
    elif fault == "backward":
        assert res["bad_grads"] and res["kinks"] == 0
    else:
        assert res["kink_abs"] > kernel_check.KINK_ABS
        assert any("ReLU" in b for b in bad)


def test_checkpoint_refuses_another_optimizer(data, tmp_path):
    _, pv, port, _ = data
    t = _port_trainer(pv, optimizer="adam", model_dir=str(tmp_path))
    t.save(str(tmp_path / "epoch_3"))
    lazy = _port_trainer(pv, optimizer="lazyadam")
    with pytest.raises(ValueError, match="adam state"):
        lazy.load_latest(str(tmp_path))
    with pytest.raises(IOError, match="Failed to find"):
        t.load_latest(str(tmp_path / "missing"))
    (tmp_path / "orbax" / "epoch_1").mkdir(parents=True)
    with pytest.raises(IOError, match="not a checkpoint"):
        t.load_latest(str(tmp_path / "orbax"))


def _requests(path, n_groups, group):
    with open(path) as f:
        lines = [line.rstrip("\n").split("\t") for line in f]
    reqs = []
    for g in range(n_groups):
        rows = lines[g * group:(g + 1) * group]
        c = rows[0]
        reqs.append(ScoreRequest(
            user=c[1], hist_items=c[5].split(","), hist_cates=c[6].split(","),
            hist_times=[float(t) for t in c[7].split(",")],
            current_time=float(c[4]), cand_items=[r[2] for r in rows],
            cand_cates=[r[3] for r in rows]))
    return reqs


def test_scoring_service_load_latest(data, tmp_path):
    paths, pv, port, _ = data
    t = _port_trainer(pv, model_dir=str(tmp_path), save_model=True,
                      epochs=1)
    t.fit(port["train"], port["valid"])
    svc = ScoringService(t.cfg, *_sizes(pv), *pv, device="cpu")
    svc.load_latest(str(tmp_path))
    n = 12
    scores = svc.score(_requests(paths["test"], n, TEST_NGS + 1))
    batch = next(port["test"].eval_batches(TEST_NGS + 1, n))
    preds, _ = t.eval_step(t.state.model, to_device(batch, "cpu"))
    np.testing.assert_allclose(np.stack(scores), to_np(preds), rtol=0,
                               atol=1e-6)


# --------------------------------------------------------------- CLI


def _cli_args(tmp_path, *extra):
    return ["--dataset", "synthetic", "--model", "CLSR", "--epochs", "2",
            "--batch_size", "64", "--data_path", str(tmp_path),
            "--test_num_ngs", str(TEST_NGS), "--val_num_ngs", "4",
            "--show_step", "5", "--seed", "7", *extra]


def _printed_dict(out):
    return ast.literal_eval(out.strip().splitlines()[-1])


def test_cli_end_to_end_then_only_test(tmp_path, capsys):
    """Also the host remainder's flags on the same run: --resume with no
    autosave starts fresh, --autosave_every_calls leaves no autosave
    behind a finished fit, --write_histograms and --write_tfevents
    write JSONL histogram records and an event file that the port's
    reader reads back (TensorFlow reads them in
    tests/test_torch_summaries.py), and change no number."""
    assert cli.main(_cli_args(tmp_path, "--device", "cpu",
                              "--write_prediction_to_file", "--resume",
                              "--autosave_every_calls", "3",
                              "--write_histograms",
                              "--write_tfevents")) == 0
    out = capsys.readouterr().out
    assert "no autosave found" in out
    assert not (tmp_path / "model" / "synthetic-clsr" / "autosave").exists()
    summary = tmp_path / "summary" / "synthetic-clsr"
    hists = [json.loads(line) for line in open(summary / "scalars.jsonl")
             if '"hist"' in line]
    assert hists and {h["step"] for h in hists} == {5 * i for i in range(
        1, len(hists) // len({h["hist"] for h in hists}) + 1)}
    assert {h["hist"] for h in hists} >= {"logit", "alpha", "att_fea2",
                                          "item_embedding_output"}
    (events_file,) = (summary).glob("events.out.tfevents.*")
    events = summaries.read_events(str(events_file))
    tags = {v["tag"] for e in events for v in e.get("values", [])}
    assert tags >= {"loss", "data_loss", "valid/wauc", "logit"}
    res = _printed_dict(out)
    for key in ("auc", "logloss", "mean_mrr", "ndcg@2", "hit@6", "wauc"):
        assert 0.0 <= res[key] <= 1.0 or key == "logloss", key
    assert "best epoch:" in out and "eval valid at epoch 2" in out
    model_dir = tmp_path / "model" / "synthetic-clsr"
    assert any(d.startswith("epoch_") for d in os.listdir(model_dir))
    assert (tmp_path / "synthetic" / "category_vocab.pkl").exists()
    with open(tmp_path / "synthetic" / "test_data") as f:
        n_lines = sum(1 for _ in f)
    scores = np.loadtxt(tmp_path / "output.txt")
    assert scores.shape == (n_lines,) and np.isfinite(scores).all()

    assert cli.main(_cli_args(tmp_path, "--device", "cpu",
                              "--only_test")) == 0
    again = _printed_dict(capsys.readouterr().out)
    assert {k: again[k] for k in res} == res
    assert set(again) - set(res) == {"mean_alpha"}


def _cli_epoch_steps(tmp_path, capsys, *flags):
    """The steps of the CLI's one epoch, from its log line."""
    assert cli.main(_cli_args(tmp_path, "--device", "cpu", "--epochs", "1",
                              "--batch_size", "60", *flags)) == 0
    return int(re.search(r"epoch 1 train time [0-9.]+s \((\d+) steps",
                         capsys.readouterr().out).group(1))


def test_cli_streamed_loader_takes_drop_remainder_min(tmp_path, capsys,
                                                      monkeypatch):
    """A deliberate deviation: the port's CLI hands cfg.drop_remainder_min
    to its loaders, where JAX's CLI keeps the loader's default of 5 (its
    resident path reads the Config).  At 5 the port's streamed epoch
    runs JAX's loader's batches; at another value (the batch size, 60:
    every partial last batch dropped) the streamed epoch equals the
    resident one, the invariant the port keeps, where JAX's CLI would
    stream one batch more than it keeps resident."""
    streamed = _cli_epoch_steps(tmp_path, capsys, "--resident_data", "off")
    cfg = cli.make_config(cli.build_arg_parser().parse_args(
        _cli_args(tmp_path, "--batch_size", "60")))
    jv = [jax_load_vocab(getattr(cfg, f"{n}_vocab"))
          for n in ("user", "item", "cate")]
    jl = JaxLoader(jax_parse_file(str(tmp_path / "synthetic" /
                                      "train_data"), *jv), L)
    jax_batches = list(jl.train_batches(cfg.batch_size,
                                        np.random.RandomState(7),
                                        min_seq_length=cfg.min_seq_length))
    assert cfg.drop_remainder_min == 5
    assert streamed == len(jax_batches)
    tail = int(jax_batches[-1].valid.sum())
    assert 5 <= tail < cfg.batch_size       # a tail that 5 keeps, 60 drops
    make_config = cli.make_config
    monkeypatch.setattr(cli, "make_config", lambda args: make_config(
        args).replace(drop_remainder_min=cfg.batch_size))
    got = {mode: _cli_epoch_steps(tmp_path / mode, capsys,
                                  "--resident_data", mode)
           for mode in ("off", "on")}
    assert got["off"] == got["on"] == streamed - 1


def test_cli_without_device_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(_cli_args(tmp_path))
    assert not (tmp_path / "synthetic").exists()


def test_cli_module_runs_and_refuses_without_a_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "clsr_tpu_torch.cli", *_cli_args(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


UNPORTED = {
    "raw_data": (["--raw_data", "x.csv"], "11b"),
    "packed": (["--data_format", "packed"], "11b"),
    "etl_processes": (["--etl_processes", "4"], "11b"),
    "etl_native": (["--etl_native"], "11b"),
    "etl_format": (["--etl_format", "packed"], "11b"),
    "data_parallel": (["--data_parallel", "2", "--dist_backend", "gloo"],
                      "10a"),
    "model_parallel": (["--model_parallel", "2", "--dist_backend", "gloo"],
                       "10a"),
    "mesh_routing": (["--mesh_update_routing", "owner"], "10b"),
    "mesh_layout": (["--mesh_row_layout", "contiguous"], "10a"),
    "mesh_flat_batch": (["--mesh_flat_batch", "off"], "10a"),
    "mesh_capacity": (["--mesh_owner_capacity", "2"], "10b"),
    "mesh_resident": (["--data_parallel", "2", "--dist_backend", "gloo",
                       "--resident_data", "on"], "10b"),
    "mesh_lgn": (["--data_parallel", "2", "--dist_backend", "gloo",
                  "--model", "LGN"], "10c"),
    "mesh_resume": (["--model_parallel", "2", "--dist_backend", "gloo",
                     "--resume"], "10c"),
    "mesh_histograms": (["--data_parallel", "2", "--dist_backend", "gloo",
                         "--write_histograms"], "10c"),
    "mesh_autosave": (["--data_parallel", "2", "--dist_backend", "gloo",
                       "--autosave_every_calls", "5"], "10c"),
    "resume": (["--resume"], 11),
    "autosave": (["--autosave_every_calls", "5"], 11),
    "resident_on": (["--resident_data", "on"], 5),
    "length_buckets": (["--length_buckets", "auto"], 5),
    "resident_round_rows": (["--resident_round_rows", "1024"], 5),
    "compute_bf16": (["--compute_dtype", "bfloat16"], 6),
    "embedding_bf16": (["--embedding_dtype", "bfloat16", "--optimizer",
                        "lazyadam"], 6),
    "attention_block": (["--attention_block_size", "64"], 9),
    "histograms": (["--write_histograms"], 11),
    "tfevents": (["--write_tfevents"], 11),
    "model": (["--model", "CASER"], "8b"),
    "sequential_model": (["--sequential_model", "gru"], 8),
    "optimizer": (["--optimizer", "adagrad"], 3),
}


# ROADMAP items ported since their flags were refused: those flags now
# parse and reach the Config (--resume and item 11b's ETL and data-format
# flags reach main: the parsed args), and those settings fit (items 8 and
# 8b are the two halves of the model zoo; 11 and 11b the host remainder,
# 11b the ETL and the packed format; 10a the mesh's main path, 10b its
# owner-routed merge, resident data and zoo; 10c LGN, autosave and
# resume and histograms on a mesh).  Under
# --attention_block_size the config refuses clsr.yaml's enable_bn, as
# the JAX CLI's does (REFUSED_BY_CONFIG).
PORTED_ITEMS = {3, 5, 6, 8, "8b", 9, "10a", "10b", "10c", 11, "11b"}
REFUSED_BY_CONFIG = {"attention_block": "requires enable_bn: False"}
PORTED_FIELDS = {"model": ("model_type", "caser"),
                 "raw_data": ("raw_data", "x.csv"),
                 "packed": ("data_format", "packed"),
                 "etl_processes": ("etl_processes", 4),
                 "etl_native": ("etl_native", True),
                 "etl_format": ("etl_format", "packed"),
                 "attention_block": ("attention_block_size", 64),
                 "resume": ("resume", True),
                 "autosave": ("autosave_every_calls", 5),
                 "histograms": ("write_histograms", True),
                 "tfevents": ("write_tfevents", True),
                 "resident_on": ("resident_data", "on"),
                 "length_buckets": ("length_buckets", "auto"),
                 "resident_round_rows": ("resident_round_rows", 1024),
                 "compute_bf16": ("compute_dtype", "bfloat16"),
                 "embedding_bf16": ("embedding_dtype", "bfloat16"),
                 "optimizer": ("optimizer", "adagrad"),
                 "data_parallel": ("data_parallel", 2),
                 "model_parallel": ("model_parallel", 2),
                 "mesh_layout": ("mesh_row_layout", "contiguous"),
                 "mesh_flat_batch": ("mesh_flat_batch", "off"),
                 "mesh_routing": ("mesh_update_routing", "owner"),
                 "mesh_capacity": ("mesh_owner_capacity", 2.0),
                 "mesh_resident": ("resident_data", "on"),
                 "mesh_lgn": ("model_type", "lgn"),
                 "mesh_resume": ("resume", True),
                 "mesh_histograms": ("write_histograms", True),
                 "mesh_autosave": ("autosave_every_calls", 5),
                 "sequential_model": ("sequential_model", "gru")}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_cli_unported_flags_raise_naming_their_item(tmp_path, name):
    flags, item = UNPORTED[name]
    args = _cli_args(tmp_path, "--device", "cpu", *flags)
    parsed = cli.build_arg_parser().parse_args(args)   # parses as in JAX
    if item in PORTED_ITEMS:
        cli.refuse_unported(parsed)
        field, value = PORTED_FIELDS[name]
        if name in REFUSED_BY_CONFIG:
            jax_args = jax_cli.build_arg_parser().parse_args(
                _cli_args(tmp_path, *flags))
            with pytest.raises(ValueError) as want:
                jax_cli.make_config(jax_args)
            with pytest.raises(ValueError) as got:
                cli.make_config(parsed)
            assert str(got.value) == str(want.value)
            assert REFUSED_BY_CONFIG[name] in str(got.value)
            assert getattr(parsed, field) == value
            return
        cfg = cli.make_config(parsed)
        assert getattr(cfg if hasattr(cfg, field) else parsed,
                       field) == value
        return
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP queue 1 item {item}\\b"):
        cli.main(args)
    assert not (tmp_path / "synthetic").exists()


@pytest.mark.parametrize("kw, item", [
    (dict(resident_data="on"), 5),
    # the mesh is ported (items 10a and 10b, mesh-resident data with
    # it; histograms on a mesh with 10c): nothing refuses the setting,
    # and its Trainer asks for the ranks' process group
    # (tests/test_torch_mesh_resident.py fits it in a 4-rank world)
    pytest.param(dict(data_parallel=2, write_histograms=True,
                      summaries_dir="<tmp>"), "10c", id="kw1-10"),
    (dict(autosave_every_calls=2, model_dir="<tmp>"), 11),
    (dict(write_histograms=True, summaries_dir="<tmp>"), 11)])
def test_trainer_refuses_unported_settings(data, tmp_path, kw, item):
    _, pv, port, _ = data
    model = _port_trainer(pv).model
    kw = {k: str(tmp_path) if v == "<tmp>" else v for k, v in kw.items()}
    if item in PORTED_ITEMS and kw.get("data_parallel", 1) > 1:
        with pytest.raises(RuntimeError) as e:
            Trainer(model, model.cfg.replace(**kw))
        # make_mesh's own message, word for word: no refusal of the item
        assert str(e.value) == (
            f"a mesh of {kw['data_parallel']} x 1 ranks needs a "
            f"torch.distributed process group: run under torchrun or spawn "
            f"the ranks with parallel.distributed.run_local_world")
        return
    if item in PORTED_ITEMS:        # it fits, on the resident path
        t = Trainer(model, model.cfg.replace(**{"epochs": 1,
                                                "resident_data": "on", **kw}),
                    log=lambda *a: None)
        t.fit(port["train"], port["valid"])
        assert t.feeds is not None and t.epoch_stats[0]["steps"] > 0
        return
    with pytest.raises(NotImplementedError, match=f"item {item}\\b"):
        Trainer(model, model.cfg.replace(**kw))


def test_fit_resume_raises(data):
    """Resume is ported (tests/test_torch_resume.py); without model_dir
    it raises as JAX's does."""
    _, pv, port, _ = data
    with pytest.raises(ValueError, match="resume requires model_dir"):
        _port_trainer(pv).fit(port["train"], port["valid"], resume=True)
