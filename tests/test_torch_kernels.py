"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: a CUDA kernel has no CPU mode, so without a card these skip
(the fixture decides, at run time).  This file imports no JAX, so it also
runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest -q

K1 at the serving shape (B=64, L=50, G=128, D=80, Dk=40, H0=80, H1=40)
to 1e-4 abs; K2 at B=64, L=50, U=H=40 to 1e-5 abs; the served scores at
clsr.yaml widths with the kernels on and off to 1e-4 abs.  TF32 is off
on both sides.
"""

import numpy as np
import pytest
import torch

from clsr_tpu_torch.config import CONFIG_DIR, load_config
from clsr_tpu_torch.data.vocab import Vocab
from clsr_tpu_torch.ops import fused_attention as fa
from clsr_tpu_torch.ops import fused_scan as fs
from clsr_tpu_torch.ops.initializers import get_initializer
from clsr_tpu_torch.ops.mlp import FcnNet
from clsr_tpu_torch.serving import ScoreRequest, ScoringService

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
