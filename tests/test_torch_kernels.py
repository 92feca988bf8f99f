"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: a CUDA kernel has no CPU mode, so without a card these skip
(the fixture decides, at run time).  This file imports no JAX, so it also
runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest -q

K1 at the serving shape (B=64, L=50, G=128, D=80, Dk=40, H0=80, H1=40)
to 1e-4 abs, and over its row tiling: D = 40 and 80 with G in {1, 5, 16,
128}, B = 7 (a ragged last tile), L = 1 and L = 130 (several chunks of
positions), an all-masked row and masks with holes, one launch each;
K2's forward over its tiling (B 0, 1, 8, 64, 133, 400; L 1, 50, 250;
(U, H) (40, 40), (10, 12), (16, 40); prefix masks with lengths L, 3, 1,
0 and masks with holes), with and without carries, to 1e-5 abs, one
launch a call, a second call bit-identical, widths past 64 refused;
K2's backward kernel (with its
five weight products) over its tiling (B 1, 3, 5, 6, 133, 400, 500;
L 1, 9, 50, 250; (U, H) (40, 40), (10, 12), (24, 40), (64, 64); prefix
masks with a row masked throughout, and masks with holes), each rows a
block forced: the forward's carries to 1e-5 abs, every gradient within
1e-4 of its max abs of the plain backward and of autograd of the plain
recurrence, one launch a call, five calls bit-identical (masks with
holes; two-step gaps at one row a block), widths past 64 refused
before a launch, one launch each way through autograd, a
float64 tensor refused; K3a/K3b's batch means and
variances to 1e-4 relative or 1e-6 abs (summation order) over their
row tiling (D 40 and 80; G 1, 5, 8, 13; L 1, 15, 16, 17, 50, 250; B 1, 3,
400; K3b with c0 > 0), bit-identical on a second call, one launch each;
the served
scores at clsr.yaml widths with the kernels on and off to 1e-4 abs; and
one train step at clsr.yaml widths on small tables, kernel path against
plain path: loss parts to 1e-4 relative, gradients to 1e-4 of each
gradient's max abs (1e-6 abs more for the biases whose gradient is zero
up to rounding), BN running statistics to 1e-5, and the launch counts
K3a 2, K3b 2, K1 2, K2 1 and K2's backward 1; K5 (row scatter, one entry and a group of
seven widths) and K4 (row sweep) bit-equal to their plain version (they
only copy) at a small shape, at a ragged one (W not a multiple of 4, a
block that does not divide N), with the legacy path's duplicate ids,
with negative ids, with ids past the last slab's end and with mostly
empty slabs (K4's in-kernel segment search), each with a dropped tail of
ids >= N; one lazy step launches K5 once, compact and legacy.  K5 on
bf16 rows (80-, 64- and 16-byte rows in 16-byte units, 14- and 24-byte
rows and a misaligned base in 2-byte units, duplicates, negative and
dropped ids) bit-equal to its plain version and to index_copy_, a
lazy step's mixed group (four bf16 tables and four f32 pmn arrays) in
one launch bit-equal to index_copy_, and the wrappers' refusals of
other types (K4 stays f32).  The zoo's scorers (DIN and SLI-Rec at
their yaml widths, D = Dk = 40): K1 in the eval step at the serving
buckets (64 x 128, 8 x 16), one launch, within 1e-4 abs of the plain
scorer; K3a + K3b + K1 in a lazyadam train step at B = 400, G = 5
through `kernel_check.compare_steps`, one launch each and K5 once.
TF32 is off on both sides.
"""

import os
import numpy as np
import pytest
import torch

from clsr_tpu_torch.config import CONFIG_DIR, load_config
from clsr_tpu_torch.data.vocab import Vocab
from clsr_tpu_torch.ops import fused_attention as fa
from clsr_tpu_torch.ops import fused_scan as fs
from clsr_tpu_torch.ops import fused_train_attention as fta
from clsr_tpu_torch.ops import row_update as ru
from clsr_tpu_torch.ops.initializers import get_initializer
from clsr_tpu_torch.ops.mlp import FcnNet
from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.serving import ScoreRequest, ScoringService
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import make_train_step

# Six xdist workers, each with torch's default intra-op pool (a thread a
# core), oversubscribe the cores several times over; under xdist a
# worker keeps one thread.  Run alone (or on the card) torch keeps its
# default.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


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


# K2's forward over its tiling: B from no launch (0) through one row, the
# serving buckets (8, 64) and one row group past the SM count (133) to the
# train batch (400), so both rows-a-block choices (1 and 4) run; L from one step to
# the Kuaishou length; (U, H) at clsr.yaml's widths, the CPU tests' and the
# zoo's user width 16; "prefix" masks hold lengths L, 3, 1 and 0 in the
# first rows, "holes" masks an all-masked row 0 and random holes after
SCAN_TILING = [
    *[(B, 50, UH, "prefix") for UH in ((40, 40), (10, 12), (16, 40))
      for B in (1, 8, 64, 133, 400)],
    *[(B, 50, (40, 40), "holes") for B in (8, 133, 400)],
    (64, 50, (10, 12), "holes"), (400, 50, (16, 40), "holes"),
    *[(B, 1, (40, 40), "prefix") for B in (1, 64, 400)],
    (133, 1, (10, 12), "holes"),
    (400, 250, (40, 40), "prefix"), (64, 250, (16, 40), "holes"),
    (133, 250, (10, 12), "prefix"),
    (0, 50, (40, 40), "prefix"),
]


@pytest.mark.parametrize("B, L, UH, mask", SCAN_TILING)
def test_scan_kernel_matches_plain(cuda, B, L, UH, mask):
    """One launch a call (none at B = 0), with and without the carries:
    outs, h1f and h2f within 1e-5 abs of `scan_reference`, the carries
    within 1e-5 abs of `scan_forward_reference`, and a second call
    bit-identical to the first."""
    U, H = UH
    args, _ = _scan_args(cuda, B, L, U, H, seed=1)
    if mask == "holes":
        g = torch.Generator(device=cuda).manual_seed(2)
        holes = (torch.rand(B, L, generator=g, device=cuda) > 0.4).float()
        holes[:1] = 0
        args = args[:8] + (holes,) + args[9:]
    want = fs.scan_forward_reference(*args)
    for keep in (False, True):
        before = fs.fused_scan.launches
        first = fs._forward(*args, keep_carries=keep)
        second = fs._forward(*args, keep_carries=keep)
        torch.cuda.synchronize()
        assert fs.fused_scan.launches == before + 2 * (B > 0)
        for x, y in zip(first, second):
            assert (x is None and y is None) or torch.equal(x, y)
        for x, y in zip(first[:3], want[:3]):
            torch.testing.assert_close(x, y, rtol=0, atol=1e-5)
        if keep:
            torch.testing.assert_close(first[3], want[3], rtol=0, atol=1e-5)
        else:
            assert first[3] is None


@pytest.mark.parametrize("U, H", [(65, 40), (40, 65)])
def test_scan_kernel_refuses_widths_past_its_limit(cuda, U, H):
    args, _ = _scan_args(cuda, 4, 3, U, H, seed=3)
    with pytest.raises(ValueError, match=str(fs.FORWARD_MAX_WIDTH)):
        fs.fused_scan(*args)


def _scan_args(dev, B, L, U, H, seed):
    """Recurrence inputs with lengths L, 3, 1, 0 in the first rows and
    1..L after; glorot-scale recurrent weights (see above)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.7
    w = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.15
    lengths = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    lengths[:4] = torch.tensor([L, min(3, L), 1, 0], device=dev)[:B]
    mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).float()
    args = (r(B, L, 2 * U), r(B, L, U), r(B, L, 4 * H), r(B, L, H),
            r(B, L, H), r(B, L, H), r(B, L, 2 * H), r(B, L, H), mask,
            r(B, U), w(U, 2 * U), w(U, U), w(H, 4 * H), w(H, 2 * H),
            w(H, H))
    cots = (r(B, U), r(B, L, H), r(B, H))
    return args, cots


def _close_to_max_abs(got, want, rel=1e-4):
    """Each gradient within `rel` of its own max abs (the kernel sums in
    another order than the plain version and autograd)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, i
            continue
        assert (a - b).abs().max().item() <= rel * b.abs().max().item(), i


def _with_holes(dev, args, seed=2):
    """args with a mask that is not a prefix: row 0 masked throughout and
    random holes in the others."""
    B, L = args[8].shape
    g = torch.Generator(device=dev).manual_seed(seed)
    holes = (torch.rand(B, L, generator=g, device=dev) > 0.4).float()
    holes[:1] = 0
    return args[:8] + (holes,) + args[9:]


# K2's backward over its tiling: B 1, 3 and 5 (one row a block), 133 (four
# rows a block, a ragged last group), 400 and 500 (the train batches, one
# wave of four rows a block); U != H at widths that are not a multiple of
# 8, and the widest 64; L from one step to the Kuaishou length; "prefix"
# masks hold lengths L, 3, 1 and 0 in the first rows (row 3 masked
# throughout), "holes" masks are not prefixes
SCAN_BACKWARD_TILING = [
    (6, 9, 10, 12, "prefix"), (400, 50, 40, 40, "prefix"),
    (1, 50, 40, 40, "prefix"), (3, 50, 40, 40, "holes"),
    (5, 50, 40, 40, "prefix"), (133, 50, 40, 40, "holes"),
    (500, 50, 40, 40, "prefix"), (400, 50, 40, 40, "holes"),
    (64, 50, 10, 12, "holes"), (133, 50, 24, 40, "prefix"),
    (8, 50, 64, 64, "prefix"), (133, 50, 64, 64, "holes"),
    (5, 1, 40, 40, "prefix"), (400, 250, 40, 40, "prefix"),
]


@pytest.mark.parametrize("B, L, U, H, mask", SCAN_BACKWARD_TILING)
def test_scan_backward_kernel_matches_plain(cuda, monkeypatch, B, L, U, H,
                                            mask):
    """The forward's carries equal the plain ones; the backward kernel
    (plus the five weight products), with the rows a block the wrapper
    picks and with each of ROWS forced, against the plain
    backward on the same carries and against autograd of
    `scan_reference`, one launch a call."""
    args, cots = _scan_args(cuda, B, L, U, H, seed=5)
    if mask == "holes":
        args = _with_holes(cuda, args)
    *_, carries = fs._forward(*args, keep_carries=True)
    *_, want_carries = fs.scan_forward_reference(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(carries, want_carries, rtol=0, atol=1e-5)
    plain = fs.scan_backward_reference(args, want_carries, *cots)
    t = [a.detach().requires_grad_(i != 8) for i, a in enumerate(args)]
    auto = torch.autograd.grad(fs.scan_reference(*t),
                               [x for i, x in enumerate(t) if i != 8], cots)
    for forced in (None, *fs.ROWS):
        if forced is not None:
            monkeypatch.setattr(fs, "rows_per_block",
                                lambda *_, r=forced: r)
        before = fs.scan_backward.launches
        got = fs.scan_backward(args, want_carries, *cots)
        torch.cuda.synchronize()
        assert fs.scan_backward.launches == before + 1
        _close_to_max_abs(got, plain)
        _close_to_max_abs([g for i, g in enumerate(got) if i != 8], auto)


def _with_gaps(dev, args):
    """args with every row's mask two valid steps, two masked, and so on
    (shifted by the row): a block of one row skips the step between its
    two masked ones, where its double-buffered shared memory still needs
    that step's barrier."""
    B, L = args[8].shape
    steps = torch.arange(L, device=dev)[None]
    rows = torch.arange(B, device=dev)[:, None]
    gaps = ((steps + rows) % 4 % 3 == 0).float()
    return args[:8] + (gaps,) + args[9:]


@pytest.mark.parametrize("mask, rows", [("holes", None), ("gaps", 1)])
def test_scan_backward_kernel_is_bit_reproducible(cuda, monkeypatch, mask,
                                                  rows):
    """Five calls on the same inputs give the same bits from the kernel
    (fixed summation order, no atomics, no race) and each is within 1e-4
    of max abs of the plain backward, at the train shape: with holes in
    the mask at the rows a block the wrapper picks, and with two-step
    gaps at one row a block."""
    args, cots = _scan_args(cuda, 400, 50, 40, 40, seed=7)
    args = (_with_holes(cuda, args) if mask == "holes"
            else _with_gaps(cuda, args))
    if rows is not None:
        monkeypatch.setattr(fs, "rows_per_block", lambda *_: rows)
    *_, carries = fs._forward(*args, keep_carries=True)
    plain = fs.scan_backward_reference(args, carries, *cots)
    first = None
    for _ in range(5):
        got = fs.scan_backward(args, carries, *cots)
        torch.cuda.synchronize()
        _close_to_max_abs(got, plain)
        first = first or got
        for i in (0, 1, 2, 3, 4, 5, 6, 7, 9):
            assert torch.equal(got[i], first[i]), i


@pytest.mark.parametrize("U, H", [(65, 40), (40, 65)])
def test_scan_backward_refuses_widths_past_its_limit(cuda, U, H):
    """A width past 64 raises ValueError naming the limit before any
    launch: the launch counter does not move."""
    args, cots = _scan_args(cuda, 4, 3, U, H, seed=3)
    carries = torch.zeros(4, 3, U + 3 * H, device=cuda)
    before = fs.scan_backward.launches
    with pytest.raises(ValueError, match=str(fs.FORWARD_MAX_WIDTH)):
        fs.scan_backward(args, carries, *cots)
    assert fs.scan_backward.launches == before


def test_fused_scan_function_runs_both_kernels(cuda):
    """Through autograd: one forward and one backward launch, gradients
    as autograd of the plain recurrence; only `h_outs` used, so the
    other cotangents arrive as zeros; a tensor the kernel cannot take
    raises."""
    args, cots = _scan_args(cuda, 16, 20, 40, 40, seed=6)
    t = [a.detach().requires_grad_(i not in (8, 10)) for i, a in
         enumerate(args)]
    before = (fs.fused_scan.launches, fs.scan_backward.launches)
    _, outs, _ = fs.fused_scan(*t)
    diff = [x for i, x in enumerate(t) if i not in (8, 10)]
    got = torch.autograd.grad((outs * cots[1]).sum(), diff)
    torch.cuda.synchronize()
    assert (fs.fused_scan.launches, fs.scan_backward.launches) == (
        before[0] + 1, before[1] + 1)
    want = torch.autograd.grad((fs.scan_reference(*t)[1] * cots[1]).sum(),
                               diff, allow_unused=True)
    _close_to_max_abs(got, [torch.zeros_like(x) if w is None else w
                            for x, w in zip(diff, want)])
    *_, carries = fs.scan_forward_reference(*args)
    with pytest.raises(TypeError, match="float32"):
        fs.scan_backward(args, carries.double(), *cots)


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


@pytest.mark.parametrize("D, G, B, L, mask", [
    *[(D, G, 64, 50, "prefix") for D in (80, 40) for G in (1, 5, 16, 128)],
    (80, 5, 7, 50, "prefix"),     # B·G not a multiple of the tile's queries
    (40, 1, 7, 50, "prefix"),
    (80, 5, 16, 1, "prefix"),     # one position
    (80, 16, 9, 130, "prefix"),   # more than one chunk of positions
    (40, 1, 9, 130, "holes"),
    (80, 5, 11, 50, "holes"),     # valid positions that are not a prefix
])
def test_eval_scorer_kernel_at_train_widths(cuda, D, G, B, L, mask):
    """K1's row tiling: every G the port uses at both widths, a ragged
    last tile, one and several position chunks, an all-masked row (row
    0) and masks with holes; one launch, 1e-4 abs of the plain version."""
    args = list(_scorer_inputs(cuda, B=B, L=L, G=G, D=D))
    if mask == "holes":
        g = torch.Generator(device=cuda).manual_seed(9)
        holes = (torch.rand(B, L, generator=g, device=cuda) > 0.4).float()
        holes[0] = 0
        args[3] = holes
    before = fa.fused_eval_attention.launches
    got = fa.fused_eval_attention(*args)
    torch.cuda.synchronize()
    assert fa.fused_eval_attention.launches == before + 1
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


# K3a/K3b over their row tiling: both compiled D, G from the train scorers'
# 1 and 5 up to 13, L from one position through ragged last m-tiles (15,
# 17) to the Kuaishou length 250, and B from fewer queries than resident
# warps (1, 3) to the train batch
STATS_TILING = [(D, G, L, B) for D in (40, 80) for G in (1, 5, 8, 13)
                for L in (1, 15, 16, 17, 50, 250) for B in (1, 3, 400)]


@pytest.mark.parametrize("D, G, L, B", STATS_TILING)
def test_train_stats_kernels_match_plain(cuda, D, G, L, B):
    """Batch mean and var within the gate, two calls bit-identical, one
    launch a call; K3b with c0 > 0, so a padding row counted would show."""
    H0, H1 = 80, 40
    g = torch.Generator(device=cuda).manual_seed(2)
    r = lambda *s, std=1.0: torch.randn(*s, generator=g, device=cuda) * std
    q, kp = r(B, G, D), r(B, L, D)
    w = [r(D, H0, std=0.3) for _ in range(3)]
    n = B * L * G
    before = fta.train_stats0.launches
    s0 = fta.train_stats0(q, kp, *w)
    again = fta.train_stats0(q, kp, *w)
    torch.cuda.synchronize()
    assert fta.train_stats0.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(s0, again))
    stats_close(s0, fta.train_stats_reference(q, kp, *w), n)
    mean = s0[0] / n
    a0 = torch.rsqrt(s0[1] / n - mean * mean + 1e-4)
    c0 = torch.rand(H0, generator=g, device=cuda) + 0.1
    fold = (a0.contiguous(), c0, r(H0, H1, std=0.3))
    before = fta.train_stats1.launches
    s1 = fta.train_stats1(q, kp, *w, *fold)
    again = fta.train_stats1(q, kp, *w, *fold)
    torch.cuda.synchronize()
    assert fta.train_stats1.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(s1, again))
    stats_close(s1, fta.train_stats_reference(q, kp, *w, fold), n)


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
        fs.scan_backward.launches = 0
        _, parts = step(state, batch, torch.Generator(cuda).manual_seed(3))
        torch.cuda.synchronize()
        counts = (fta.train_stats0.launches, fta.train_stats1.launches,
                  fa.fused_eval_attention.launches, fs.fused_scan.launches,
                  fs.scan_backward.launches)
        assert counts == ((2, 2, 2, 1, 1) if name == "kernel" else (0,) * 5)
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


def _row_case(dev, g, N, W, M, case):
    """(table, ids, rows) of a row-update case: M sorted int32 ids ending
    in dropped ids >= N (past the last slab's end too for
    "past_last_slab"), led by negative ones for "below_zero", with
    duplicates carrying equal rows for "dup"."""
    table = torch.randn(N, W, generator=g, device=dev)
    n_tail = 5
    if case == "dup":
        valid = torch.randint(0, N, (M - n_tail,), generator=g, device=dev)
    else:
        valid = torch.randperm(N, generator=g, device=dev)[:M - n_tail]
    step = 37 if case == "past_last_slab" else 1
    parts = [torch.sort(valid).values,
             N + step * torch.arange(n_tail, device=dev)]
    if case == "below_zero":
        parts.insert(0, torch.tensor([-9, -4, -1], device=dev))
    ids = torch.cat(parts).to(torch.int32)
    rows = torch.randn(ids.numel(), W, generator=g, device=dev)
    if case == "dup":
        rows[:M - n_tail] = table[ids[:M - n_tail].long()] * 0.5 + 1.0
    return table, ids, rows


@pytest.mark.parametrize("N, W, M, block, case", [
    (1000, 40, 300, 128, "unique"),   # 16-byte units, 8 slabs
    (1003, 7, 250, 100, "unique"),    # 4-byte units, last slab of 3 rows
    (1000, 96, 400, 256, "dup"),      # duplicate ids with equal rows
    (1000, 40, 300, 128, "below_zero"),
    (1003, 24, 250, 100, "past_last_slab"),   # block does not divide N
    (5000, 40, 40, 64, "empty_slabs"),        # 79 slabs, most empty
    (1000, 0, 300, 0, "group"),
])
def test_row_update_kernels_match_plain(cuda, N, W, M, block, case):
    """K5 and K4 bit-equal to the plain version; "group" holds seven
    entries of widths 40, 7, 96, 24, 120, 32 and 8 (one with duplicates)
    in one K5 launch."""
    g = torch.Generator(device=cuda).manual_seed(4)
    if case == "group":
        entries = [_row_case(cuda, g, N, w, M, "dup" if w == 24 else "unique")
                   for w in (40, 7, 96, 24, 120, 32, 8)]
        want = [t.clone() for t, _, _ in entries]
        ru.scatter_rows_group_reference(
            [(w, i, r) for w, (_, i, r) in zip(want, entries)])
        got = [t.clone() for t, _, _ in entries]
        before = ru.scatter_rows.launches
        ru.scatter_rows_group([(o, i, r) for o, (_, i, r) in
                               zip(got, entries)])
        torch.cuda.synchronize()
        assert ru.scatter_rows.launches == before + 1
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        return
    table, ids, rows = _row_case(cuda, g, N, W, M, case)
    want = ru.scatter_rows_reference(table.clone(), ids, rows)
    assert torch.equal(ru.sweep_rows_reference(table.clone(), ids, rows,
                                               block), want)
    for name, fn in (
            ("scatter", ru.scatter_rows),
            ("sweep", lambda t, i, r: ru.sweep_rows(t, i, r, block))):
        counter = ru.sweep_rows if name == "sweep" else ru.scatter_rows
        before = counter.launches
        got = fn(table.clone(), ids, rows)
        torch.cuda.synchronize()
        assert counter.launches == before + 1, name
        assert torch.equal(got, want), name


@pytest.mark.parametrize("W, case, layout", [
    (40, "unique", "aligned"),   # 80-byte rows: 16-byte units (user)
    (32, "unique", "aligned"),   # 64 bytes (item)
    (8, "dup", "aligned"),       # 16 bytes (cate), duplicate ids
    (40, "below_zero", "aligned"),
    (7, "unique", "aligned"),    # 14 bytes: 2-byte units
    (12, "unique", "aligned"),   # 24 bytes: 2-byte units
    (40, "unique", "offset"),    # a base 2 bytes past 16: 2-byte units
])
def test_row_scatter_bf16_matches_plain(cuda, W, case, layout):
    """K5 on bf16 rows bit-equal to its plain version and to
    index_copy_ on the valid ids, ids >= N (and < 0) dropped, one
    launch."""
    g = torch.Generator(device=cuda).manual_seed(5)
    N, M = 1000, 300
    table, ids, rows = (t.bfloat16() if t.is_floating_point() else t
                        for t in _row_case(cuda, g, N, W, M, case))
    if layout == "offset":
        buf = torch.empty(N * W + 1, dtype=torch.bfloat16, device=cuda)
        buf[1:].copy_(table.reshape(-1))
        table = buf[1:].view(N, W)
        assert table.data_ptr() % 16 != 0
    want = ru.scatter_rows_reference(table.clone(), ids, rows)
    keep = (ids >= 0) & (ids < N)
    lib = table.clone().index_copy_(0, ids[keep].long(), rows[keep])
    before = ru.scatter_rows.launches
    got = ru.scatter_rows(table.clone(), ids, rows)
    torch.cuda.synchronize()
    assert ru.scatter_rows.launches == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want) and (case == "dup" or torch.equal(got, lib))


def test_row_scatter_mixed_group_matches_plain(cuda):
    """A lazy step's group: four bf16 tables (user 40, 40, item 32, cate
    8) and their four f32 pmn row arrays (120, 120, 96, 24), in one K5
    launch, bit-equal to index_copy_ entry by entry."""
    g = torch.Generator(device=cuda).manual_seed(6)
    entries = []
    for W in (40, 40, 32, 8):
        table, ids, rows = _row_case(cuda, g, 2000, W, 400, "unique")
        pmn = torch.randn(2000, 3 * W, generator=g, device=cuda)
        pmn_rows = torch.randn(ids.numel(), 3 * W, generator=g, device=cuda)
        entries += [(table.bfloat16(), ids, rows.bfloat16()),
                    (pmn, ids, pmn_rows)]
    want = []
    for table, ids, rows in entries:
        keep = (ids >= 0) & (ids < table.shape[0])
        want.append(table.clone().index_copy_(0, ids[keep].long(),
                                              rows[keep]))
    got = [t.clone() for t, _, _ in entries]
    before = ru.scatter_rows.launches
    ru.scatter_rows_group([(o, i, r) for o, (_, i, r) in zip(got, entries)])
    torch.cuda.synchronize()
    assert ru.scatter_rows.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_row_update_wrappers_refuse_other_types(cuda):
    """K5 takes f32 or bf16 where the table and the rows agree; K4 takes
    f32 only."""
    table = torch.zeros(10, 8, dtype=torch.bfloat16, device=cuda)
    ids = torch.arange(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="one type"):
        ru.scatter_rows(table, ids, torch.zeros(4, 8, device=cuda))
    with pytest.raises(TypeError, match="one type"):
        ru.scatter_rows(table.half(), ids, torch.zeros(
            4, 8, dtype=torch.half, device=cuda))
    with pytest.raises(TypeError, match="one type"):
        ru.sweep_rows(table, ids, torch.zeros(4, 8, dtype=torch.bfloat16,
                                              device=cuda))


def test_lazy_train_step_compact_matches_legacy(cuda):
    """One lazyadam step at clsr.yaml widths on small tables with every
    kernel on: compact rows against the legacy path, K5 launched once
    per step on both, updated tables and moments within 1e-5 (index_add_
    and the dense embedding backward sum in other orders on the card),
    the compact tables equal to pmn[:, :D]."""
    n_users, n_items, n_cates = 1000, 5000, 50
    base = load_config(f"{CONFIG_DIR}/clsr.yaml", user_vocab="u",
                       item_vocab="i", cate_vocab="c", seed=0,
                       optimizer="lazyadam", use_pallas_train_attention="on",
                       use_pallas_scan=True)
    runs = {}
    for mode in ("auto", "off"):
        cfg = base.replace(compact_rows=mode)
        model = get_model_class("clsr")(cfg, n_users, n_items, n_cates)
        state = create_train_state(model, cfg)
        step = make_train_step(model, cfg)
        batch = _train_batch(cuda, np.random.RandomState(0), 64, 50,
                             n_users, n_items, n_cates)
        ru.scatter_rows.launches = 0
        _, parts = step(state, batch, torch.Generator(cuda).manual_seed(3))
        torch.cuda.synchronize()
        assert ru.scatter_rows.launches == 1
        runs[mode] = (parts, {n: p.detach() for n, p in
                              model.named_parameters()},
                      state.optimizer.moments)
    (pa, ta, ma), (pb, tb, mb) = runs["auto"], runs["off"]
    for f in ("loss", "data_loss", "regular_loss", "contrastive_loss",
              "discrepancy_loss"):
        a, b = getattr(pa, f).item(), getattr(pb, f).item()
        assert abs(a - b) <= 1e-4 * abs(b) + 1e-7, (f, a, b)
    for name in mb:
        D = tb[name].shape[1]
        torch.testing.assert_close(ta[name], tb[name], rtol=0, atol=1e-5)
        torch.testing.assert_close(ma[name][:, D:], mb[name], rtol=0,
                                   atol=1e-5)
        assert torch.equal(ma[name][:, :D], ta[name])


# ---------------------------------------------------- the zoo's shapes
# DIN's and SLI-Rec's attention_fcn: query = target (D = 40), keys the
# history (DIN) or the Time4LSTM outputs (SLI-Rec), Dk = 40, scorer
# [80, 40]; K1 at the serving buckets, K3a + K3b + K1 at G = 5


def _zoo_model(cuda, name, n_items, n_cates, **kw):
    cfg = load_config(f"{CONFIG_DIR}/{name}.yaml", user_vocab="u",
                      item_vocab="i", cate_vocab="c", seed=0, **kw)
    return cfg, get_model_class(name)(cfg, 10, n_items, n_cates)


@pytest.mark.parametrize("name", ["din", "sli_rec"])
@pytest.mark.parametrize("B, G", [(64, 128), (8, 16)])
def test_zoo_eval_scorer_matches_plain(cuda, name, B, G):
    """K1 at (D, Dk, H0, H1) = (40, 40, 80, 40) in the zoo's eval step:
    one launch, scores within 1e-4 abs of the plain scorer's."""
    from clsr_tpu_torch.training.steps import make_eval_step_fn
    n_items, n_cates = 5000, 50
    rng = np.random.RandomState(B)
    batch = _train_batch(cuda, rng, B, 50, 10, n_items, n_cates)
    batch.items = torch.from_numpy(rng.randint(1, n_items, (B, G)).astype(
        np.int32)).to(cuda)
    batch.cates = torch.from_numpy(rng.randint(1, n_cates, (B, G)).astype(
        np.int32)).to(cuda)
    preds = {}
    for gate in ("on", "off"):
        cfg, model = _zoo_model(cuda, name, n_items, n_cates,
                                use_pallas_eval_attention=gate)
        if gate == "on":
            state = model.state_dict()
            fa.fused_eval_attention.launches = 0
        else:
            model.load_state_dict(state)
        preds[gate], _ = make_eval_step_fn(cfg)(model, batch)
        torch.cuda.synchronize()
        if gate == "on":
            assert fa.fused_eval_attention.launches == 1
    torch.testing.assert_close(preds["on"], preds["off"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["din", "sli_rec"])
def test_zoo_train_scorer_matches_plain(cuda, name):
    """K3a + K3b + K1 at (G, D) = (5, 40) in the zoo's train step, B =
    400, L = 50, lazyadam compact: `kernel_check.compare_steps` within
    its gates, one launch of each kernel and K5 a step."""
    from clsr_tpu_torch.training import kernel_check
    n_items, n_cates = 5000, 50
    cfg, model = _zoo_model(cuda, name, n_items, n_cates,
                            use_pallas_train_attention="on",
                            optimizer="lazyadam")
    rng = np.random.RandomState(4)
    train = _train_batch(cuda, rng, 400, 50, 10, n_items, n_cates)
    test = _train_batch(cuda, rng, 16, 50, 10, n_items, n_cates)
    test.items = train.items[:16].repeat(1, 20)
    test.cates = train.cates[:16].repeat(1, 20)
    res = kernel_check.compare_steps(cfg, model.state_dict(),
                                     (10, n_items, n_cates), train, test)
    assert kernel_check.failures(res) == []
    assert res["k5_identical"] is True
    counts = res["launches"]["train/kernel"]
    assert {k: counts[k] for k in ("train_stats0", "train_stats1",
                                   "eval_scorer", "row_scatter",
                                   "clsr_scan")} == dict(
        train_stats0=1, train_stats1=1, eval_scorer=1, row_scatter=1,
        clsr_scan=0)


# ------------------------------------------------- the rest of the zoo
# Caser's and NextItNet's convs (ops/conv.py: GEMMs and fixed-order slice
# sums) and LGN's graph propagation (ops/graph_conv.py: fixed-order
# segment sums both ways) must give the same bits on every step, with
# deterministic algorithms off, as the graphed = eager gate needs


def _state_bits(state):
    """Every tensor of a train state: the model's, the lazy rows and
    count, and the dense optimizer's."""
    from clsr_tpu_torch.training.lazy_adam import LazyAdamState
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    opt = state.optimizer
    if isinstance(opt, LazyAdamState):
        out.update({f"moments/{k}": v for k, v in opt.moments.items()})
        out["count"] = opt.count
        opt = opt.dense_opt
    for i, st in enumerate(opt.state_dict()["state"].values()):
        out.update({f"opt/{i}/{k}": v for k, v in st.items()
                    if isinstance(v, torch.Tensor)})
    return out


def _steps_twice(cuda, build, batches, want_k5):
    """Two runs of len(batches) train steps from one built state and one
    generator seed: (state tensors, losses) of each."""
    assert not torch.are_deterministic_algorithms_enabled()
    runs = []
    for _ in range(2):
        cfg, model = build()
        state = create_train_state(model, cfg)
        step = make_train_step(model, cfg)
        gen = torch.Generator(cuda).manual_seed(3)
        ru.scatter_rows.launches = 0
        losses = torch.stack([step(state, b, gen)[1].loss for b in batches])
        torch.cuda.synchronize()
        assert ru.scatter_rows.launches == want_k5 * len(batches)
        runs.append((_state_bits(state), losses))
    (a, la), (b, lb) = runs
    assert a.keys() == b.keys()
    differ = sorted(k for k in a if not torch.equal(a[k], b[k]))
    assert differ == [] and torch.equal(la, lb), differ
    assert torch.isfinite(la).all()


@pytest.mark.parametrize("name", ["caser", "nextitnet"])
@pytest.mark.parametrize("opt", ["adam", "lazyadam"])
def test_zoo_rest_steps_are_bit_reproducible(cuda, name, opt):
    """Two Caser / NextItNet (per position, dropout 0.3 in the head) train
    steps at their yaml widths, B = 400, L = 50, G = 5, from one state,
    twice: every state tensor and loss bit-identical; K5 once a lazyadam
    step (Caser compact, NextItNet legacy)."""
    n_items, n_cates = 5000, 50
    rng = np.random.RandomState(5)
    batches = [_train_batch(cuda, rng, 400, 50, 10, n_items, n_cates)
               for _ in range(2)]
    _steps_twice(cuda, lambda: _zoo_model(cuda, name, n_items, n_cates,
                                          optimizer=opt),
                 batches, int(opt == "lazyadam"))


def _hub_graph(n_users, n_items, hub, hub_users, seed=6):
    """A graph of seeded histories (1..50 items and a target) in which
    item `hub` sits in the first `hub_users` users' histories."""
    from clsr_tpu_torch.data.graph import build_graph_from_arrays
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, 51, n_users) + 1
    offsets = np.concatenate([[0], np.cumsum(lens)])
    items = rng.randint(1, n_items, offsets[-1])
    items[offsets[:hub_users]] = hub
    return build_graph_from_arrays(np.arange(n_users), offsets, items,
                                   1 + items % 49, n_users, n_items)


def test_lgn_step_is_bit_reproducible(cuda):
    """One LGN train step (lgn.yaml, dense Adam, B = 400) twice from one
    state on a graph with a node of degree > 1,000: every state tensor
    bit-identical.  The propagation and its gradient within 1e-5 of
    their max abs of a float64 sum over the same edges."""
    from clsr_tpu_torch.ops.graph_conv import propagate
    n_users, n_items, n_cates = 2000, 3000, 50
    graph = _hub_graph(n_users, n_items, 7, 1500)
    degree = np.bincount(graph.src, minlength=graph.n_nodes)
    assert degree.max() > 1000
    cfg = load_config(f"{CONFIG_DIR}/lgn.yaml", user_vocab="u",
                      item_vocab="i", cate_vocab="c", seed=0)
    build = lambda: (cfg, get_model_class("lgn")(cfg, n_users, n_items,
                                                 n_cates, graph=graph))
    rng = np.random.RandomState(8)
    _steps_twice(cuda, build,
                 [_train_batch(cuda, rng, 400, 50, n_users, n_items,
                               n_cates)], 0)
    _, model = build()
    g = torch.Generator(cuda).manual_seed(1)
    ego = torch.randn(graph.n_nodes, 40, generator=g, device=cuda)
    cot = torch.randn(graph.n_nodes, 40, generator=g, device=cuda)
    x = ego.clone().requires_grad_()
    out = propagate(x, model.edges)
    out.backward(cot)
    src, dst = (torch.from_numpy(a.astype(np.int64)).to(cuda)
                for a in (graph.src, graph.dst))
    w = torch.from_numpy(graph.weight).to(cuda).double()[:, None]
    want = torch.zeros_like(ego, dtype=torch.float64).index_add_(
        0, src, w * ego.double()[dst])
    want_g = torch.zeros_like(want).index_add_(0, dst, w * cot.double()[src])
    for got, ref in ((out, want), (x.grad, want_g)):
        err = (got.double() - ref).abs().max() / ref.abs().max()
        assert err <= 1e-5, err
