"""The fit loop on the card (marked `gpu`; skips without one).

Without JAX (the card's machine has none), so it runs there with
`python -m pytest tests/test_torch_fit_gpu.py -m gpu --noconftest -q`.
On the 200-user synthetic set at the clsr.yaml widths, batch 100:

  * streamed (`resident_data: off`): a one-epoch fit with
    `prefetch_batches: 2` (pinned host copies on a
    copy stream, the compute stream waiting on an event) and one with
    `prefetch_batches: 0` (a plain copy per batch) from the same seed:
    every model tensor and every valid metric bit-identical, with every
    kernel gate on and dense Adam, also a second fit without prefetch,
    and two lazyadam fits.  Deterministic algorithms stay off: the train
    lookups sum a repeated row's gradient in sorted order
    (`ops.segment_sum`), so two fits give the same bits;
  * a resident fit (`resident_data: on`, K = 4 replays of a step that
    gathers its own batch on the card) against the streamed fit from the
    same seed, dense Adam and lazyadam: every model and optimizer tensor
    and every valid metric bit-identical;
  * a length-bucketed fit (edges 16, 32; masked BN statistics, lazyadam,
    every kernel gate): K5 and K2's backward once a step, K3a, K3b and
    K1 never in training (the masked scorer runs plain), K2's forward
    once a step, once a refresh batch and once a valid dispatch, one
    graph a bucket;
  * the train step graphed (`make_multi_train_step`, two calls of K = 4
    and a tail step, every kernel gate on) against 9 eager single steps
    from the same state and generator seed: every model and optimizer
    tensor and every loss part bit-identical, for dense Adam, lazyadam
    compact, each of the seven other optimizers, and lazyadam with bf16
    tables and bf16 compute (K2 not launched there); the launch counts
    of the graphed calls are K times the eager step's (the capture's
    counts added at each replay);
  * `table_grad` on the 41-row table with 25,000 ids: two calls
    bit-identical and within 1e-4 of `F.embedding`'s gradient;
  * after a fit and a graphed call, `Trainer.load` of the fit's
    checkpoint and a second call with the same generator equal a fresh
    trainer that loads the checkpoint and makes that call, bit for bit
    (the load drops the graph, which would keep writing dense Adam's old
    tensors);
  * a short lazyadam fit with every kernel gate on: finite losses, each
    kernel of the path launched (K5 once a step, K2's backward once a
    step, K3a/K3b/K1 twice a step), every test prediction with K1 on
    within 1e-4 of K1 off, a checkpoint restored by `load_latest` giving
    the same test dict exactly;
  * at that fit's shapes (its first train batch, B = 100, and one test
    batch of 5 x 20) on its weights, the kernel-gated eval and train
    steps against the plain ones (`training.kernel_check`): scores 1e-4
    abs, loss parts 1e-4 relative, gradients 1e-4 of their max abs, BN
    running statistics 1e-5, K5 bit-identical to its plain version.
"""

import os
import dataclasses

import numpy as np
import pytest
import torch

from clsr_tpu_torch.config import CONFIG_DIR, load_config
from clsr_tpu_torch.data.loader import SequenceLoader
from clsr_tpu_torch.data.parser import parse_file
from clsr_tpu_torch.data.prefetch import to_device
from clsr_tpu_torch.data.synthetic import write_synthetic_dataset
from clsr_tpu_torch.data.vocab import load_vocab
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.ops import fused_attention as fa
from clsr_tpu_torch.ops import fused_scan as fs
from clsr_tpu_torch.ops import fused_train_attention as fta
from clsr_tpu_torch.ops import row_update as ru
from clsr_tpu_torch.ops.segment_sum import table_grad
from clsr_tpu_torch.training import kernel_check
from clsr_tpu_torch.training.evaluator import run_weighted_eval
from clsr_tpu_torch.training.kernel_check import counted
from clsr_tpu_torch.training.lazy_adam import LazyAdamState
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import (LOSS_FIELDS, make_eval_step_fn,
                                           make_multi_train_step,
                                           make_train_step, stack_batches)
from clsr_tpu_torch.training.trainer import Trainer

# Six xdist workers, each with torch's default intra-op pool (a thread a
# core), oversubscribe the cores several times over; under xdist a
# worker keeps one thread.  Run alone (or on the card) torch keeps its
# default.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


pytestmark = pytest.mark.gpu
TEST_NGS = 19


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = tmp_path_factory.mktemp("fit_gpu")
    paths = write_synthetic_dataset(str(out), n_users=200, n_items=1000,
                                    n_cates=40, valid_num_ngs=4,
                                    test_num_ngs=TEST_NGS)
    vocabs = [load_vocab(paths[f"{n}_vocab"])
              for n in ("user", "item", "cate")]
    loaders = {s: SequenceLoader(parse_file(paths[s], *vocabs), 50)
               for s in ("train", "valid", "test")}
    return tuple(map(len, vocabs)), loaders


def _cfg(**kw):
    return load_config(f"{CONFIG_DIR}/clsr.yaml", user_vocab="u",
                       item_vocab="i", cate_vocab="c", batch_size=100,
                       epochs=1, seed=4, show_step=0, test_num_ngs=TEST_NGS,
                       use_pallas_scan=True, use_pallas_train_attention="on",
                       **kw)


def _state_tensors(state):
    """Every tensor of a TrainState: the model's, the lazy rows and the
    dense Adam state."""
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    opt = state.optimizer
    if isinstance(opt, LazyAdamState):
        out.update({f"moments/{k}": v for k, v in opt.moments.items()})
        out["count"] = opt.count
        opt = opt.dense_opt
    for i, st in enumerate(opt.state_dict()["state"].values()):
        out.update({f"opt/{i}/{k}": v for k, v in st.items()})
    return out


def _row(parts):
    """Loss parts as [..., 5], a field a column."""
    return torch.stack([getattr(parts, f) for f in LOSS_FIELDS], -1)


def _fit(sizes, loaders, cfg):
    t = Trainer(get_model_class("clsr")(cfg, *sizes), cfg,
                log=lambda *_: None)
    t.fit(loaders["train"], loaders["valid"])
    return t


def _recording(step, out):
    def run(model, batch):
        preds, alpha = step(model, batch)
        out.append(preds[batch.valid > 0])
        return preds, alpha
    return run


def _same_states(a, b):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def test_prefetch_on_and_off_fits_are_bit_identical(cuda, data):
    sizes, loaders = data
    assert not torch.are_deterministic_algorithms_enabled()
    runs = [_fit(sizes, loaders, _cfg(prefetch_batches=d,
                                      resident_data="off"))
            for d in (2, 0, 0)]
    lazy = [_fit(sizes, loaders, _cfg(optimizer="lazyadam",
                                      resident_data="off"))
            for _ in range(2)]
    want = runs[1].state.model.state_dict()
    for t in (runs[0], runs[2]):
        got = t.state.model.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert t.eval_history == runs[1].eval_history
    _same_states(runs[0].state, runs[2].state)
    _same_states(lazy[0].state, lazy[1].state)
    assert lazy[0].eval_history == lazy[1].eval_history
    assert runs[0].epoch_stats[0]["steps"] > 5


@pytest.mark.parametrize("opt", ["adam", "lazyadam"])
def test_resident_fit_equals_streamed_fit(cuda, data, opt):
    sizes, loaders = data
    assert not torch.are_deterministic_algorithms_enabled()
    runs = {r: _fit(sizes, loaders, _cfg(optimizer=opt, resident_data=r,
                                         train_steps_per_call=4))
            for r in ("on", "off")}
    assert runs["on"].feeds is not None and runs["off"].feeds is None
    assert runs["on"].resident_step.capture_stats
    _same_states(runs["on"].state, runs["off"].state)
    assert runs["on"].eval_history == runs["off"].eval_history
    assert runs["on"].epoch_stats[0]["steps"] > 8


def test_bucketed_fit_launch_counts(cuda, data):
    sizes, loaders = data
    counters = {"K3a": fta.train_stats0, "K3b": fta.train_stats1,
                "K1": fa.fused_eval_attention, "K2": fs.fused_scan,
                "K2_bwd": fs.scan_backward, "K5": ru.scatter_rows}
    cfg = _cfg(optimizer="lazyadam", length_buckets="16,32",
               train_steps_per_call=4, bn_refresh_batches=6)
    for c in counters.values():
        c.launches = 0
    t = _fit(sizes, loaders, cfg)
    torch.cuda.synchronize()
    got = {n: c.launches for n, c in counters.items()}
    steps = t.epoch_stats[0]["steps"]
    lbs = [f.res.seq_len for f, _ in t.feeds]
    assert t.bucketed and len(lbs) >= 2
    assert sorted(t.resident_step.capture_stats) == lbs
    from clsr_tpu_torch.data.resident import resolve_bucket_paddings
    valid = loaders["valid"]
    anchors = np.arange(0, len(valid.view.labels), 5)
    pads = resolve_bucket_paddings(cfg, valid.view.lengths[anchors])
    n_valid = sum(1 for _ in valid.eval_batches(
        5, cfg.batch_size // 5, paddings=pads))
    assert np.isfinite(t.epoch_stats[0]["mean_loss"])
    assert got["K5"] == got["K2_bwd"] == steps > 5
    assert got["K3a"] == got["K3b"] == got["K1"] == 0
    assert got["K2"] == steps + cfg.bn_refresh_batches + n_valid


# every optimizer, and lazyadam with bf16 tables and compute
BF16 = dict(optimizer="lazyadam", embedding_dtype="bfloat16",
            compute_dtype="bfloat16")


@pytest.mark.parametrize("opt", ["adam", "lazyadam", "adadelta", "adagrad",
                                 "sgd", "pgd", "rmsprop", "ftrl", "padagrad",
                                 "lazyadam_bf16"])
def test_graphed_steps_equal_eager_steps(cuda, data, opt):
    sizes, loaders = data
    cfg = _cfg(**(BF16 if opt == "lazyadam_bf16" else dict(optimizer=opt)))
    K = 4
    host = list(loaders["train"].train_batches(cfg.batch_size,
                                               np.random.RandomState(0)))
    batches = [to_device(b, cuda) for b in host[:2 * K + 1]]
    runs, counts = {}, {}
    for run in ("eager", "graph"):
        torch.manual_seed(0)
        model = get_model_class("clsr")(cfg, *sizes)
        state = create_train_state(model, cfg)
        gen = torch.Generator(device=cuda).manual_seed(3)
        if run == "eager":
            step = make_train_step(model, cfg)
            (_, first), counts["eager"] = counted(
                lambda: step(state, batches[0], gen))
            parts = [first] + [step(state, b, gen)[1] for b in batches[1:]]
            rows = torch.stack([_row(p) for p in parts])
        else:
            multi = make_multi_train_step(model, cfg, K)
            out = []
            for c in range(2):
                (_, p), counts[f"call{c}"] = counted(lambda: multi(
                    state, stack_batches(batches[c * K:(c + 1) * K]), gen))
                out.append(_row(p))
            out.append(_row(multi.step(state, batches[2 * K], gen)[1])[None])
            rows = torch.cat(out)
            assert multi.capture_stats is not None
        runs[run] = (state, rows)
    (se, re_), (sg, rg) = runs["eager"], runs["graph"]
    assert rg.shape == (2 * K + 1, 5) and torch.equal(re_, rg)
    assert se.step == sg.step == 2 * K + 1
    _same_states(se, sg)
    per_step = {k: n for k, n in counts["eager"].items() if n}
    # under bf16 compute the recurrence is the plain one (no K2)
    assert per_step.get("clsr_scan_backward") == (
        None if opt == "lazyadam_bf16" else 1)
    assert per_step["train_stats0"] == 2
    for c in range(2):
        assert counts[f"call{c}"] == {k: K * per_step.get(k, 0)
                                      for k in counts[f"call{c}"]}


def test_table_grad_is_reproducible_on_41_rows(cuda):
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 41, 25_000)).to(cuda)
    g = torch.from_numpy(rng.randn(25_000, 8).astype(np.float32)).to(cuda)
    a, b = (table_grad(ids, g, 41) for _ in range(2))
    assert torch.equal(a, b)
    t = torch.zeros(41, 8, device=cuda, requires_grad=True)
    torch.nn.functional.embedding(ids, t).backward(g)
    assert (a - t.grad).abs().max().item() <= 1e-4


def test_load_drops_the_graph(cuda, data, tmp_path):
    sizes, loaders = data
    K = 4
    cfg = _cfg(model_dir=str(tmp_path), save_model=True,
               train_steps_per_call=K)
    first = Trainer(get_model_class("clsr")(cfg, *sizes), cfg,
                    log=lambda *_: None)
    first.fit(loaders["train"], loaders["valid"])
    host = list(loaders["train"].train_batches(cfg.batch_size,
                                               np.random.RandomState(1)))
    stacks = [stack_batches([to_device(b, cuda)
                             for b in host[c * K:(c + 1) * K]])
              for c in range(2)]
    gen = torch.Generator(device=cuda).manual_seed(5)
    first.multi_step(first.state, stacks[0], gen)       # captures
    assert first.multi_step.capture_stats is not None
    gen_fresh = torch.Generator(device=cuda)
    gen_fresh.set_state(gen.get_state())
    first.load_latest(str(tmp_path))
    fresh = Trainer(get_model_class("clsr")(cfg, *sizes), cfg,
                    log=lambda *_: None)
    fresh.load_latest(str(tmp_path))
    # the same generator: without the drop, the old graph would replay
    first.multi_step(first.state, stacks[1], gen)
    fresh.multi_step(fresh.state, stacks[1], gen_fresh)
    _same_states(first.state, fresh.state)


def test_lazy_fit_on_the_card_runs_every_kernel(cuda, data, tmp_path):
    sizes, loaders = data
    counters = {"K3a": fta.train_stats0, "K3b": fta.train_stats1,
                "K1": fa.fused_eval_attention, "K2": fs.fused_scan,
                "K2_bwd": fs.scan_backward, "K5": ru.scatter_rows}
    for c in counters.values():
        c.launches = 0
    cfg = _cfg(optimizer="lazyadam", model_dir=str(tmp_path))
    t = _fit(sizes, loaders, cfg)
    torch.cuda.synchronize()
    got = {n: c.launches for n, c in counters.items()}
    steps = t.epoch_stats[0]["steps"]
    assert np.isfinite(t.epoch_stats[0]["mean_loss"])
    assert got["K5"] == got["K2_bwd"] == steps > 5
    assert got["K3a"] == got["K3b"] == got["K1"] == 2 * steps
    assert got["K2"] > steps                     # + the valid eval's
    kept_on, kept_off = [], []
    res_on = run_weighted_eval(_recording(t.eval_step, kept_on),
                               t.state.model, loaders["test"], cfg, TEST_NGS)
    cfg_off = dataclasses.replace(cfg, use_pallas_eval_attention="off")
    model_off = get_model_class("clsr")(cfg_off, *sizes)
    model_off.load_state_dict(t.state.model.state_dict())
    res_off = run_weighted_eval(_recording(make_eval_step_fn(cfg_off),
                                           kept_off),
                                model_off, loaders["test"], cfg_off, TEST_NGS)
    assert res_on.keys() == res_off.keys()
    on, off = torch.cat(kept_on), torch.cat(kept_off)
    assert on.shape == off.shape and on.numel() > 1000
    assert (on - off).abs().max().item() <= 1e-4
    fresh = Trainer(get_model_class("clsr")(cfg.replace(seed=9), *sizes),
                    cfg)
    fresh.load_latest(str(tmp_path))
    assert run_weighted_eval(fresh.eval_step, fresh.state.model,
                             loaders["test"], cfg, TEST_NGS) == res_on


def test_kernel_steps_match_the_plain_ones_at_the_fit_shapes(cuda, data):
    sizes, loaders = data
    cfg = _cfg(optimizer="lazyadam")
    t = _fit(sizes, loaders, cfg)
    first = to_device(next(loaders["train"].train_batches(
        cfg.batch_size, np.random.RandomState(cfg.seed),
        min_seq_length=cfg.min_seq_length)), cuda)
    test = to_device(next(loaders["test"].eval_batches(
        group_size=TEST_NGS + 1, batch_groups=cfg.batch_size // (TEST_NGS + 1),
        min_seq_length=cfg.min_seq_length)), cuda)
    res = kernel_check.compare_steps(cfg, t.state.model.state_dict(), sizes,
                                     first, test)
    assert kernel_check.failures(res) == []
    assert res["k5_identical"] is True and res["k5_groups"] == 1
    assert res["table_grad_rel_err"] is not None
    lc = res["launches"]
    assert {k: lc["eval/kernel"][k] for k in ("eval_scorer", "clsr_scan")} \
        == {"eval_scorer": 1, "clsr_scan": 1}
    want = dict(train_stats0=2, train_stats1=2, eval_scorer=2, clsr_scan=1,
                clsr_scan_backward=1, row_scatter=1, row_sweep=0)
    assert lc["train/kernel"] == want
    assert not any(lc["eval/plain"].values())
    assert not any(lc["train/plain"].values())
