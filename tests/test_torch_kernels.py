"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: a CUDA kernel has no CPU mode, so without a card these skip
(the fixture decides, at run time).  This file imports no JAX, so it also
runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest -q

K1 at the serving shape (B=64, L=50, G=128, D=80, Dk=40, H0=80, H1=40)
to 1e-4 abs, and at the train widths (D = 40 and 80) with G in {1, 5};
K2 at B=64, L=50, U=H=40 to 1e-5 abs; K3a/K3b's batch means and
variances to 1e-4 relative or 1e-6 abs (summation order); the served
scores at clsr.yaml widths with the kernels on and off to 1e-4 abs; and
one train step at clsr.yaml widths on small tables, kernel path against
plain path: loss parts to 1e-4 relative, gradients to 1e-4 of each
gradient's max abs (1e-6 abs more for the biases whose gradient is zero
up to rounding), BN running statistics to 1e-5, and the launch counts
K3a 2, K3b 2, K1 2, K2 1.  TF32 is off on both sides.
"""

import numpy as np
import pytest
import torch

from clsr_tpu_torch.config import CONFIG_DIR, load_config
from clsr_tpu_torch.data.vocab import Vocab
from clsr_tpu_torch.ops import fused_attention as fa
from clsr_tpu_torch.ops import fused_scan as fs
from clsr_tpu_torch.ops import fused_train_attention as fta
from clsr_tpu_torch.ops.initializers import get_initializer
from clsr_tpu_torch.ops.mlp import FcnNet
from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.serving import ScoreRequest, ScoringService
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import make_train_step

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scorer_inputs(dev, B=64, L=50, G=128, D=80, Dk=40, H=(80, 40)):
    g = torch.Generator(device=dev).manual_seed(0)
    fcn = FcnNet(D, H, ("relu",), get_initializer("tnormal", 0.3), g, dev,
                 enable_bn=True, out_dim=1, split_first=True).eval()
    with torch.no_grad():
        for i in range(2):
            bn = getattr(fcn, f"bn{i}")
            bn.mean.normal_(0.0, 0.3, generator=g)
            bn.var.uniform_(0.5, 1.5, generator=g)
    lengths = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    lengths[0] = 0                                    # one all-masked row
    mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).float()
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    return (r(B, L, Dk), r(B, L, D), r(B, G, D), mask) + \
        fa.fold_scorer_params(fcn, D, True)


def test_eval_scorer_kernel_matches_plain(cuda):
    args = _scorer_inputs(cuda)
    before = fa.fused_eval_attention.launches
    got = fa.fused_eval_attention(*args)
    torch.cuda.synchronize()
    assert fa.fused_eval_attention.launches == before + 1
    want = fa.eval_scorer_reference(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_scan_kernel_matches_plain(cuda):
    B, L, U, H = 64, 50, 40, 40
    g = torch.Generator(device=cuda).manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda) * 0.7
    # glorot-scale recurrent weights: larger ones make the GRUs chaotic,
    # and then f32 rounding alone drifts by ~0.1 over 50 steps
    w = lambda *s: torch.randn(*s, generator=g, device=cuda) * 0.15
    lengths = torch.randint(1, L + 1, (B,), generator=g, device=cuda)
    mask = (torch.arange(L, device=cuda)[None] < lengths[:, None]).float()
    args = (r(B, L, 2 * U), r(B, L, U), r(B, L, 4 * H), r(B, L, H),
            r(B, L, H), r(B, L, H), r(B, L, 2 * H), r(B, L, H), mask,
            r(B, U), w(U, 2 * U), w(U, U), w(H, 4 * H), w(H, 2 * H),
            w(H, H))
    before = fs.fused_scan.launches
    got = fs.fused_scan(*args)
    torch.cuda.synchronize()
    assert fs.fused_scan.launches == before + 1
    for x, y in zip(got, fs.scan_reference(*args)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-5)


def test_service_kernels_match_plain_path(cuda):
    n_users, n_items, n_cates = 1000, 5000, 50
    vocabs = [Vocab({f"{p}{i}": i for i in range(n)}) for p, n in
              (("u", n_users), ("i", n_items), ("c", n_cates))]
    base = load_config(f"{CONFIG_DIR}/clsr.yaml", user_vocab="u",
                       item_vocab="i", cate_vocab="c", seed=0)
    rng = np.random.RandomState(0)
    reqs = []
    for _ in range(12):
        n, c = rng.randint(1, 60), rng.randint(1, 101)
        hist, cands = rng.randint(1, n_items, n), rng.randint(1, n_items, c)
        reqs.append(ScoreRequest(
            f"u{rng.randint(n_users)}", [f"i{i}" for i in hist],
            [f"c{i % n_cates}" for i in hist],
            sorted(1.5e9 - rng.randint(60, 10 ** 7, n)), 1.5e9,
            [f"i{i}" for i in cands], [f"c{i % n_cates}" for i in cands]))
    scores = {}
    for name, kw in (("off", dict(use_pallas_eval_attention="off")),
                     ("k1", {}), ("k1k2", dict(use_pallas_scan=True))):
        svc = ScoringService(base.replace(**kw), n_users, n_items, n_cates,
                             *vocabs)
        scores[name] = svc.score(reqs)
    for name in ("k1", "k1k2"):
        for a, b in zip(scores[name], scores["off"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("D, G", [(80, 5), (40, 1), (40, 5)])
def test_eval_scorer_kernel_at_train_widths(cuda, D, G):
    args = _scorer_inputs(cuda, G=G, D=D)
    got = fa.fused_eval_attention(*args)
    torch.cuda.synchronize()
    want = fa.eval_scorer_reference(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def stats_close(got, want, n_rows):
    """Batch mean and var from (sum, sum of squares): within 1e-4
    relative or 1e-6 absolute (the kernels sum in another order)."""
    (gs, gq), (ws, wq) = got, want
    for g, w in ((gs / n_rows, ws / n_rows),
                 (gq / n_rows - (gs / n_rows) ** 2,
                  wq / n_rows - (ws / n_rows) ** 2)):
        assert ((g - w).abs() <= torch.maximum(1e-4 * w.abs(),
                                               torch.tensor(1e-6,
                                                            device=w.device))
                ).all(), (g - w).abs().max()


@pytest.mark.parametrize("D, G", [(80, 5), (40, 1)])
def test_train_stats_kernels_match_plain(cuda, D, G):
    B, L, H0, H1 = 64, 50, 80, 40
    g = torch.Generator(device=cuda).manual_seed(2)
    r = lambda *s, std=1.0: torch.randn(*s, generator=g, device=cuda) * std
    q, kp = r(B, G, D), r(B, L, D)
    w = [r(D, H0, std=0.3) for _ in range(3)]
    n = B * L * G
    before = (fta.train_stats0.launches, fta.train_stats1.launches)
    s0 = fta.train_stats0(q, kp, *w)
    stats_close(s0, fta.train_stats_reference(q, kp, *w), n)
    mean = s0[0] / n
    a0 = torch.rsqrt(s0[1] / n - mean * mean + 1e-4)
    fold = (a0.contiguous(), (-a0 * mean).contiguous(), r(H0, H1, std=0.3))
    s1 = fta.train_stats1(q, kp, *w, *fold)
    stats_close(s1, fta.train_stats_reference(q, kp, *w, fold), n)
    torch.cuda.synchronize()
    assert (fta.train_stats0.launches, fta.train_stats1.launches) == (
        before[0] + 1, before[1] + 1)


def _train_batch(dev, rng, B, L, n_users, n_items, n_cates):
    lengths = rng.randint(1, L + 1, B)
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    i32 = lambda a: t(a.astype(np.int32))
    return Batch(
        users=i32(rng.randint(1, n_users, B)),
        items=i32(rng.randint(1, n_items, (B, 1))),
        cates=i32(rng.randint(1, n_cates, (B, 1))),
        labels=t(np.ones((B, 1), np.float32)),
        item_hist=i32(rng.randint(1, n_items, (B, L)) * mask),
        cate_hist=i32(rng.randint(1, n_cates, (B, L)) * mask),
        mask=t(mask),
        time_diff=t((rng.randn(B, L) * mask).astype(np.float32)),
        time_from_first=t((rng.rand(B, L) * 3 * mask).astype(np.float32)),
        time_to_now=t((rng.rand(B, L) * 3 * mask).astype(np.float32)),
        valid=t(np.ones(B, np.float32)))


def zero_by_construction(name):
    """Parameters whose gradient is zero up to rounding: a dense bias
    under train-mode BN, and an output bias under a softmax (the
    scorers' over L, the logit head's over the G candidates)."""
    return ((".w_nn_layer" in name and name.endswith(".bias"))
            or name.endswith("w_nn_output.bias"))


def test_train_step_kernel_path_matches_plain(cuda):
    n_users, n_items, n_cates = 1000, 5000, 50
    base = load_config(f"{CONFIG_DIR}/clsr.yaml", user_vocab="u",
                       item_vocab="i", cate_vocab="c", seed=0)
    runs = {}
    for name, cfg in (("kernel", base.replace(use_pallas_train_attention="on",
                                              use_pallas_scan=True)),
                      ("plain", base)):
        model = get_model_class("clsr")(cfg, n_users, n_items, n_cates)
        state = create_train_state(model, cfg)
        step = make_train_step(model, cfg)
        batch = _train_batch(cuda, np.random.RandomState(0), 64, 50,
                             n_users, n_items, n_cates)
        fta.train_stats0.launches = fta.train_stats1.launches = 0
        fa.fused_eval_attention.launches = fs.fused_scan.launches = 0
        _, parts = step(state, batch, torch.Generator(cuda).manual_seed(3))
        torch.cuda.synchronize()
        counts = (fta.train_stats0.launches, fta.train_stats1.launches,
                  fa.fused_eval_attention.launches, fs.fused_scan.launches)
        assert counts == ((2, 2, 2, 1) if name == "kernel" else (0,) * 4)
        runs[name] = (parts, {n: p.grad for n, p in model.named_parameters()},
                      dict(model.named_buffers()))
    (pk, gk, bk), (pp, gp, bp) = runs["kernel"], runs["plain"]
    for f in ("loss", "data_loss", "regular_loss", "contrastive_loss",
              "discrepancy_loss"):
        a, b = getattr(pk, f).item(), getattr(pp, f).item()
        assert abs(a - b) <= 1e-4 * abs(b) + 1e-7, (f, a, b)
    for n, g in gp.items():
        tol = 1e-4 * g.abs().max().item()
        if zero_by_construction(n):
            tol += 1e-6
        assert (gk[n] - g).abs().max().item() <= tol, n
    for n, b in bp.items():
        torch.testing.assert_close(bk[n], b, rtol=0, atol=1e-5)
