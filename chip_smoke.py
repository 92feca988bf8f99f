"""Smoke run of the PyTorch port on one NVIDIA GPU (no CPU mode).

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card check: CUDA present, `nvidia-smi` name and power limit, TF32 off;
  2. build every CUDA kernel from csrc/ (nvcc, one per source, all at
     once) and print the build seconds and ptxas' register/spill lines;
  3. K1 (fused eval scorer) against its plain PyTorch version at the
     serving shape B=64, L=50, G=128, D=80, Dk=40, H0=80, H1=40, with
     history lengths 1..50, one all-masked row and BN folds from random
     running statistics: max abs error <= 1e-4, kernel and plain times;
  4. K2 (three-cell recurrence) against its plain version at B=64, L=50,
     U=H=40 with mixed lengths: outs, h1, h2 within 1e-5 abs, times;
  5. serving at the clsr.yaml widths with Taobao UserBehavior-sized
     tables (987,995 users, 4,162,025 items, 9,440 categories, plus the
     OOV row), seeded random weights plus N(0, 0.1) noise: 64 requests
     x 100 candidates (bucket 128), 8 x 10 (bucket 16), 16 submits
     through AsyncScoringService; run with the default config (K1) and
     with use_pallas_scan (K1 + K2), the kernel launch counts set to 0
     just before each run and read just after.  Scores
     must be finite, in [0, 1], one per candidate; the two runs agree to
     1e-5; the kernel path equals use_pallas_eval_attention='off' to 1e-4
     and the CPU port on the 8 x 10 requests to 1e-4.  Prints the median
     dispatch latency and candidates/s of the 64 x 100 batch and the peak
     device memory;
  6. K3a and K3b (train-mode BN statistics) against their plain version
     at the two train shapes of the clsr.yaml scorers, B=400, L=50 and
     (G, D) = (5, 80) short-term, (1, 40) long-term: batch mean and var
     within 1e-4 relative or 1e-6 abs (summation order); kernel, plain
     and bound times;
  7. the train-mode scorer `fused_train_attention` (K3a, K3b, K1 with the
     batch folds; recompute backward) against `train_scorer_math` at the
     same shapes: output within 1e-4 abs, the four statistics as in 6,
     the gradient of every differentiable input within 1e-4 of its max
     abs; K1's time at G=5 and G=1, the forward and backward-recompute
     times; then K2 at the train shape B=400 with its backward, which
     recomputes through the plain recurrence: forward and backward times;
  8. training at the clsr.yaml widths with the Taobao-sized tables:
     seeded numpy batches of B=400, L=50, lengths 1..50, in-batch
     negatives drawn on the card from a seeded torch.Generator (G=5).
     The first batch with the kernel configuration
     (use_pallas_train_attention='on', use_pallas_scan) and with both
     gates off, from the same weights and generator seed: loss parts
     within 1e-4 relative, every gradient within 1e-4 of its max abs
     (1e-6 abs more where the gradient is zero up to rounding: a dense
     bias under train-mode BN, an output bias under a softmax), BN
     running statistics within 1e-5.  Then 10 steps with the kernels in
     turns with 10 plain steps on the same batches, the counts read
     around each: K3a 2, K3b 2, K1 2, K2 1 per kernel step, none per
     plain step; finite losses; per path the median step ms (CUDA
     events), examples/s and peak device memory.  Last, torch.profiler
     over three steps of each path: host ms and device span per
     `train_step.<phase>` range, the device's busy share of the window,
     kernel launches per step and the kernels with the most device time.
Then one JSON line of the kernels, the card's name and power limit, and
the final status line.  A copy of all numbers goes to
chiprun_out/chip_smoke.json.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_FP32_FLOPS = 67e12        # FP32 outside the tensor cores (data sheet)
H100_HBM_BYTES = 3.35e12       # HBM3 bytes/s (data sheet)
K1_TOL, K2_TOL, SERVE_TOL = 1e-4, 1e-5, 1e-4


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device ms per call of fn, by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes, n_flops):
    t_bytes = n_bytes / H100_HBM_BYTES * 1e3
    t_ops = n_flops / H100_FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def card_check():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs only on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    return smi


def build_kernels():
    from clsr_tpu_torch.ops import _build
    secs = _build.build()
    log(f"build: {secs:.2f} s for {', '.join(_build.KERNELS)}")
    for name in _build.KERNELS:
        logf = _build.library_path(name).with_suffix(".log")
        for line in logf.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return secs


def check_k1(smi):
    from clsr_tpu_torch.ops import fused_attention as fa
    from clsr_tpu_torch.ops.initializers import get_initializer
    from clsr_tpu_torch.ops.mlp import FcnNet
    dev = torch.device("cuda")
    B, L, G, D, Dk, H0, H1 = 64, 50, 128, 80, 40, 80, 40
    g = torch.Generator(device=dev).manual_seed(0)
    fcn = FcnNet(D, (H0, H1), ("relu",), get_initializer("tnormal", 0.3), g,
                 dev, enable_bn=True, out_dim=1, split_first=True).eval()
    with torch.no_grad():
        for i in range(2):
            bn = getattr(fcn, f"bn{i}")
            bn.mean.normal_(0.0, 0.3, generator=g)
            bn.var.uniform_(0.5, 1.5, generator=g)
            bn.scale.uniform_(0.5, 1.5, generator=g)
            bn.bias.normal_(0.0, 0.3, generator=g)
    lengths = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    lengths[0] = 0                                   # all-masked row
    mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).float()
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    args = (r(B, L, Dk), r(B, L, D), r(B, G, D), mask) + \
        fa.fold_scorer_params(fcn, D, True)
    got = fa.fused_eval_attention(*args)
    torch.cuda.synchronize()
    want = fa.eval_scorer_reference(*args)
    err = (got - want).abs().max().item()
    rel = ((got - want).abs() / want.abs().clamp_min(1e-3)).max().item()
    ms = cuda_ms(lambda: fa.fused_eval_attention(*args))
    plain_ms = cuda_ms(lambda: fa.eval_scorer_reference(*args))
    n_valid = int(mask.sum().item())
    # masked positions skip the MLP, so count the valid ones
    k1_flops = lambda n: (2 * n * G * (D * H0 + H0 * H1)  # per (b, l, g)
                          + 2 * n * D * H0                # kp @ Wk_eff
                          + 2 * B * G * D * H0            # q @ Wq_eff
                          + 2 * B * L * G * Dk)           # sum of keys
    flops = k1_flops(n_valid)
    n_bytes = 4 * (sum(t.numel() for t in args) + B * G * Dk)
    bound_ms, bound_by = bound(n_bytes, flops)
    log(f"K1 eval_scorer: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
        f"(tol {K1_TOL} abs) | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"| {flops / 1e9:.3f} GFLOP over {n_valid}/{B * L} valid positions "
        f"({k1_flops(B * L) / 1e9:.3f} if all were valid), "
        f"{n_bytes / 1e6:.2f} MB, bound {bound_ms:.4f} ms ({bound_by}) | "
        f"{smi}")
    if not err <= K1_TOL:
        raise AssertionError(f"K1 disagrees with its plain version: {err}")
    return dict(name="eval_scorer", max_abs_err=err, max_rel_err=rel, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                flops=flops, bytes=n_bytes)


def check_k2(smi):
    from clsr_tpu_torch.ops import fused_scan as fs
    dev = torch.device("cuda")
    B, L, U, H = 64, 50, 40, 40
    g = torch.Generator(device=dev).manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.7
    # recurrent weights at about the model's glorot scale: with std 0.7
    # the GRUs turn chaotic and f32 itself drifts from f64 by ~0.1 over
    # 50 steps, which would test rounding, not the kernel
    w = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.15
    lengths = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).float()
    args = (r(B, L, 2 * U), r(B, L, U), r(B, L, 4 * H), r(B, L, H),
            r(B, L, H), r(B, L, H), r(B, L, 2 * H), r(B, L, H), mask,
            r(B, U), w(U, 2 * U), w(U, U), w(H, 4 * H), w(H, 2 * H),
            w(H, H))
    got = fs.fused_scan(*args)
    torch.cuda.synchronize()
    want = fs.scan_reference(*args)
    err = max((x - y).abs().max().item() for x, y in zip(got, want))
    ms = cuda_ms(lambda: fs.fused_scan(*args))
    plain_ms = cuda_ms(lambda: fs.scan_reference(*args), iters=5)
    n_valid = int(mask.sum().item())
    macs = U * 2 * U + U * U + H * 4 * H + H * 2 * H + H * H
    flops = 2 * n_valid * macs
    n_bytes = 4 * (sum(t.numel() for t in args) + B * L * H + B * U + B * H)
    bound_ms, bound_by = bound(n_bytes, flops)
    log(f"K2 clsr_scan: max_abs_err {err:.3e} (tol {K2_TOL} abs) | kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms | {n_bytes / 1e6:.2f} MB, "
        f"{flops / 1e6:.1f} MFLOP, bound {bound_ms:.5f} ms ({bound_by}); "
        f"the real floor is the {L} dependent steps | {smi}")
    if not err <= K2_TOL:
        raise AssertionError(f"K2 disagrees with its plain version: {err}")
    return dict(name="clsr_scan", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                bytes=n_bytes)


def make_requests(rng, n_req, n_cands, n_users, n_items, n_cates):
    from clsr_tpu_torch.serving import ScoreRequest
    reqs = []
    t0 = 1_512_000_000.0                  # Dec 2017, inside UserBehavior
    for _ in range(n_req):
        n = int(rng.randint(1, 81))       # some histories longer than L
        hist = rng.randint(1, n_items, n)
        cands = rng.randint(1, n_items, n_cands)
        reqs.append(ScoreRequest(
            user=f"u{rng.randint(1, n_users)}",
            hist_items=[f"i{i}" for i in hist],
            hist_cates=[f"c{1 + i % (n_cates - 1)}" for i in hist],
            hist_times=sorted(t0 - rng.randint(60, 8 * 86400, n)),
            current_time=t0,
            cand_items=[f"i{i}" for i in cands],
            cand_cates=[f"c{1 + i % (n_cates - 1)}" for i in cands]))
    return reqs


def vocab_for(reqs):
    from clsr_tpu_torch.data.vocab import Vocab
    ids = lambda toks: {t: int(t[1:]) for t in toks}
    users, items, cates = {}, {}, {}
    for r in reqs:
        users.update(ids([r.user]))
        items.update(ids(list(r.hist_items) + list(r.cand_items)))
        cates.update(ids(list(r.hist_cates) + list(r.cand_cates)))
    return [Vocab(dict(m, default=0)) for m in (users, items, cates)]


def serve(smi):
    from clsr_tpu_torch.config import CONFIG_DIR, load_config
    from clsr_tpu_torch.ops.fused_attention import fused_eval_attention
    from clsr_tpu_torch.ops.fused_scan import fused_scan
    from clsr_tpu_torch.serving import AsyncScoringService, ScoringService

    n_users, n_items, n_cates = 987_995 + 1, 4_162_025 + 1, 9_440 + 1
    cfg = load_config(os.path.join(CONFIG_DIR, "clsr.yaml"),
                      user_vocab="u", item_vocab="i", cate_vocab="c", seed=0)
    rng = np.random.RandomState(0)
    big = make_requests(rng, 64, 100, n_users, n_items, n_cates)
    small = make_requests(rng, 8, 10, n_users, n_items, n_cates)
    async_reqs = make_requests(rng, 16, 30, n_users, n_items, n_cates)
    vocabs = vocab_for(big + small + async_reqs)
    sizes = (n_users, n_items, n_cates)

    t0 = time.perf_counter()
    base = ScoringService(cfg, *sizes, *vocabs)
    g = torch.Generator(device="cuda").manual_seed(5)
    with torch.no_grad():      # spread the scores; BN stats away from 0/1
        for p in base.model.parameters():
            p.add_(torch.randn(p.shape, generator=g, device="cuda") * 0.1)
        for name, buf in base.model.named_buffers():
            if name.endswith(".mean"):
                buf.normal_(0.0, 0.05, generator=g)
            elif name.endswith(".var"):
                buf.uniform_(0.5, 1.5, generator=g)
    state = base.model.state_dict()
    torch.cuda.synchronize()
    table_mb = sum(p.numel() for n, p in state.items()
                   if n.endswith("_embedding")) * 4 / 1e6
    log(f"serve: model at clsr.yaml widths, tables {table_mb:.1f} MB, "
        f"built in {time.perf_counter() - t0:.2f} s")

    def service(**kw):
        svc = ScoringService(cfg.replace(**kw), *sizes, *vocabs)
        svc.model.load_state_dict(state)
        return svc

    def drive(svc):
        """The main path: 64x100, 8x10, 16 async submits."""
        out_big = svc.score(big)
        out_small = svc.score(small)
        asvc = AsyncScoringService(svc, max_wait_ms=5.0)
        try:
            out_async = [f.result(timeout=300)
                         for f in [asvc.submit(r) for r in async_reqs]]
        finally:
            asvc.close()
        return out_big + out_small + out_async, asvc.dispatches

    def check_scores(scores, reqs):
        for s, r in zip(scores, reqs):
            if s.shape != (len(r.cand_items),) or not np.isfinite(s).all() \
                    or s.min() < 0 or s.max() > 1:
                raise AssertionError("scores not finite in [0, 1], one per "
                                     "candidate")

    def latency(svc, reps=10):
        """Medians over `reps` 64x100 dispatches: the whole dispatch (host
        clock; it ends in a device-to-host copy), its host batch assembly
        alone, and its eval step alone (CUDA events)."""
        svc.score(big)
        total, host, step = [], [], []
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        for _ in range(reps):
            t = time.perf_counter()
            svc.score(big)
            total.append(time.perf_counter() - t)
            t = time.perf_counter()
            batch = svc._empty_batch(64, 128)
            for row, req in enumerate(big):
                svc._fill_row(batch, row, req, 128)
            host.append(time.perf_counter() - t)
            batch = batch.to("cuda")
            torch.cuda.synchronize()
            start.record()
            svc._eval_step(svc.model, batch)
            end.record()
            torch.cuda.synchronize()
            step.append(start.elapsed_time(end))
        med = statistics.median(total)
        return dict(latency_ms=med * 1e3, cands_per_s=64 * 100 / med,
                    host_ms=statistics.median(host) * 1e3,
                    step_ms=statistics.median(step))

    runs = {}
    all_reqs = big + small + async_reqs
    for run, kw in (("k1", {}), ("k1k2", dict(use_pallas_scan=True))):
        svc = base if run == "k1" else service(**kw)
        svc.score(big[:2])          # build and warm the kernels
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident_mb = torch.cuda.memory_allocated() / 1e6
        fused_eval_attention.launches = 0
        fused_scan.launches = 0
        scores, dispatches = drive(svc)
        torch.cuda.synchronize()
        counts = {"eval_scorer": fused_eval_attention.launches,
                  "clsr_scan": fused_scan.launches}
        peak_mb = torch.cuda.max_memory_allocated() / 1e6
        check_scores(scores, all_reqs)
        need = ["eval_scorer"] + (["clsr_scan"] if run == "k1k2" else [])
        for k in need:
            if counts[k] <= 0:
                raise AssertionError(f"{run}: kernel {k} never launched on "
                                     f"the serving path")
        lat = latency(svc)
        runs[run] = dict(scores=scores, launches=counts, peak_mb=peak_mb,
                         resident_mb=resident_mb,
                         async_dispatches=dispatches, **lat)
        log(f"serve[{run}]: launches {counts} | 64x100 dispatch median "
            f"{lat['latency_ms']:.3f} ms ({lat['host_ms']:.3f} ms host "
            f"assembly, {lat['step_ms']:.3f} ms eval step), "
            f"{lat['cands_per_s']:,.0f} candidates/s | peak "
            f"{peak_mb:.1f} MB of which {resident_mb:.1f} MB resident "
            f"before the run | async dispatches {dispatches} | {smi}")
        if run == "k1k2":
            del svc

    off = service(use_pallas_eval_attention="off")
    off_scores, _ = drive(off)
    plain = latency(off)
    log(f"serve[plain]: 64x100 dispatch median {plain['latency_ms']:.3f} ms "
        f"({plain['host_ms']:.3f} ms host assembly, {plain['step_ms']:.3f} "
        f"ms eval step), {plain['cands_per_s']:,.0f} candidates/s "
        f"(no kernels) | {smi}")
    del off
    d_runs = max(float(np.abs(a - b).max()) for a, b in
                 zip(runs["k1"]["scores"], runs["k1k2"]["scores"]))
    d_off = max(float(np.abs(a - b).max()) for a, b in
                zip(runs["k1"]["scores"], off_scores))

    cpu = ScoringService(cfg, *sizes, *vocabs, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in state.items()})
    cpu_small = cpu.score(small)
    del cpu
    d_cpu = max(float(np.abs(a - b).max()) for a, b in
                zip(runs["k1"]["scores"][64:72], cpu_small))
    log(f"serve: |k1 - k1k2| {d_runs:.3e} (tol {K2_TOL}), |k1 - plain| "
        f"{d_off:.3e} (tol {SERVE_TOL}), |cuda - cpu| on 8x10 "
        f"{d_cpu:.3e} (tol {SERVE_TOL})")
    if not (d_runs <= K2_TOL and d_off <= SERVE_TOL and d_cpu <= SERVE_TOL):
        raise AssertionError("served scores disagree across paths")
    return dict(table_mb=table_mb, plain=plain, d_runs=d_runs, d_off=d_off,
                d_cpu=d_cpu,
                runs={k: {kk: vv for kk, vv in v.items() if kk != "scores"}
                      for k, v in runs.items()})


TRAIN_SHAPES = (("short", 5, 80), ("long", 1, 40))   # (name, G, D)
TRAIN_B, TRAIN_L, H0, H1, DK = 400, 50, 80, 40, 40
STATS_REL, STATS_ABS, GRAD_REL = 1e-4, 1e-6, 1e-4


def stats_err(got, want):
    """Worst excess of |got - want| over max(1e-4 |want|, 1e-6), <= 0
    when within tolerance, and the max abs error."""
    d = (got - want).abs()
    lim = torch.clamp(STATS_REL * want.abs(), min=STATS_ABS)
    return (d - lim).max().item(), d.max().item()


def mean_var(s, q, n):
    mean = s / n
    return mean, q / n - mean * mean


def train_inputs(g, G, D, B=TRAIN_B, L=TRAIN_L):
    """Scorer inputs at a train shape: history lengths 1..L, weights at
    about the model's scale, BN scales and shifts away from 1 and 0."""
    dev = torch.device("cuda")
    r = lambda *s, std=1.0: torch.randn(*s, generator=g, device=dev) * std
    u = lambda *s: torch.rand(*s, generator=g, device=dev) + 0.5
    lengths = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).float()
    return [r(B, L, DK), r(B, L, D), r(B, G, D), mask,
            r(4 * D, H0, std=0.1), r(H0, std=0.1), u(H0), r(H0, std=0.3),
            r(H0, H1, std=0.1), r(H1, std=0.1), u(H1), r(H1, std=0.3),
            r(H1, std=0.3)]


def stats_cost(B, L, G, D, second):
    """(bytes, flops) of K3a (second False) or K3b: inputs read once,
    the per-channel sums written once."""
    rows = B * L * G
    flops = (2 * rows * D * H0 + 2 * B * L * D * H0 + 2 * B * G * D * H0
             + rows * D + 2 * rows * H0)
    n_in = B * G * D + B * L * D + 3 * D * H0
    if second:
        flops += 3 * rows * H0 + 2 * rows * H0 * H1 + 3 * rows * H1
        n_in += 2 * H0 + H0 * H1
        n_out = 2 * H1
    else:
        flops += 3 * rows * H0
        n_out = 2 * H0
    return 4 * (n_in + n_out), flops


def check_k3(smi):
    from clsr_tpu_torch.ops import fused_train_attention as fta
    out = {}
    for shape, G, D in TRAIN_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(10 + G)
        _, kp, q, _, k0 = train_inputs(g, G, D)[:5]
        wk, wq, wd, wm = k0.split(D)
        w = [(wk + wd).contiguous(), (wq - wd).contiguous(),
             wm.contiguous()]
        n = TRAIN_B * TRAIN_L * G
        s0 = fta.train_stats0(q, kp, *w)
        torch.cuda.synchronize()
        p0 = fta.train_stats_reference(q, kp, *w)
        mean0, var0 = mean_var(*p0, n)
        a0 = torch.rsqrt(var0 + 1e-4).contiguous()
        fold = (a0, (-a0 * mean0).contiguous(),
                (torch.randn(H0, H1, generator=g, device="cuda")
                 * 0.1).contiguous())
        s1 = fta.train_stats1(q, kp, *w, *fold)
        torch.cuda.synchronize()
        p1 = fta.train_stats_reference(q, kp, *w, fold)
        for name, got, want, second, call, plain in (
                ("train_stats0", s0, p0, False,
                 lambda: fta.train_stats0(q, kp, *w),
                 lambda: fta.train_stats_reference(q, kp, *w)),
                ("train_stats1", s1, p1, True,
                 lambda: fta.train_stats1(q, kp, *w, *fold),
                 lambda: fta.train_stats_reference(q, kp, *w, fold))):
            errs = [stats_err(a, b) for a, b in
                    zip(mean_var(*got, n), mean_var(*want, n))]
            excess = max(e[0] for e in errs)
            err = max(e[1] for e in errs)
            ms, plain_ms = cuda_ms(call), cuda_ms(plain)
            n_bytes, flops = stats_cost(TRAIN_B, TRAIN_L, G, D, second)
            bound_ms, bound_by = bound(n_bytes, flops)
            log(f"{'K3b' if second else 'K3a'} {name} [{shape}: B={TRAIN_B} "
                f"L={TRAIN_L} G={G} D={D}]: mean/var max_abs_err {err:.3e} "
                f"(tol {STATS_REL} rel or {STATS_ABS} abs) | kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms | {flops / 1e9:.3f} "
                f"GFLOP, {n_bytes / 1e6:.2f} MB, bound {bound_ms:.4f} ms "
                f"({bound_by}) | {smi}")
            if not excess <= 0:
                raise AssertionError(f"{name} [{shape}] disagrees with its "
                                     f"plain version: {err}")
            out[f"{name}/{shape}"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, flops=flops, bytes=n_bytes)
    return out


def check_train_scorer(smi):
    """fused_train_attention (kernels + recompute backward) against the
    plain train-mode scorer math, at both train shapes; then K2's
    recompute backward at the train shape."""
    from clsr_tpu_torch.ops import fused_attention as fa
    from clsr_tpu_torch.ops import fused_train_attention as fta
    out = {}
    for shape, G, D in TRAIN_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(20 + G)
        args = train_inputs(g, G, D)
        diff = [i for i in range(13) if i != 3]
        cot = torch.randn(TRAIN_B, G, DK, generator=g, device="cuda")

        def run(fn):
            t = [a.detach().requires_grad_(i in diff)
                 for i, a in enumerate(args)]
            outs = fn(*t)
            grads = torch.autograd.grad(outs[0], [t[i] for i in diff], cot)
            return [o.detach() for o in outs], grads

        (got, g_got), (want, g_want) = run(fta.fused_train_attention), \
            run(fta.train_scorer_math)
        torch.cuda.synchronize()
        att_err = (got[0] - want[0]).abs().max().item()
        st = [stats_err(a, b) for a, b in zip(got[1:], want[1:])]
        grad_rel = max(((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)).item() for a, b in zip(g_got, g_want))
        log(f"train scorer [{shape}: G={G} D={D}]: att max_abs_err "
            f"{att_err:.3e} (tol 1e-4), stats max_abs_err "
            f"{max(e[1] for e in st):.3e}, gradients max err / max abs "
            f"{grad_rel:.3e} (tol {GRAD_REL}) | {smi}")
        if not (att_err <= 1e-4 and max(e[0] for e in st) <= 0
                and grad_rel <= GRAD_REL):
            raise AssertionError(f"train scorer [{shape}] disagrees with "
                                 f"its plain math")
        # K1 alone at this shape, with the batch folds
        keys, kp, q, mask, k0, b0, s0, sh0, w1, b1, s1, sh1, w2 = args
        wk, wq, wd, wm = k0.split(D)
        m0, v0, m1, v1 = (t - b for t, b in
                          zip(want[1:], (b0, 0.0, b1, 0.0)))
        a0 = s0 * torch.rsqrt(v0 + 1e-4)
        a1 = s1 * torch.rsqrt(v1 + 1e-4)
        k1_args = [t.contiguous() for t in (
            keys, kp, q, mask, wk + wd, wq - wd, wm, a0, sh0 - a0 * m0, w1,
            a1, sh1 - a1 * m1, w2)]
        k1_ms = cuda_ms(lambda: fa.fused_eval_attention(*k1_args))
        k1_plain = cuda_ms(lambda: fa.eval_scorer_reference(*k1_args))
        k1_err = (fa.fused_eval_attention(*k1_args)
                  - fa.eval_scorer_reference(*k1_args)).abs().max().item()
        n_valid = int(mask.sum().item())
        k1_flops = (2 * n_valid * G * (D * H0 + H0 * H1)
                    + 2 * n_valid * D * H0 + 2 * TRAIN_B * G * D * H0
                    + 2 * TRAIN_B * TRAIN_L * G * DK)
        k1_bound = bound(4 * (sum(t.numel() for t in k1_args)
                              + TRAIN_B * G * DK), k1_flops)
        # forward and backward-recompute times of the Function
        t = [a.detach().requires_grad_(i in diff)
             for i, a in enumerate(args)]
        fwd_ms = cuda_ms(lambda: fta.fused_train_attention(*t), iters=10)
        plain_fwd_ms = cuda_ms(lambda: fta.train_scorer_math(*t), iters=10)
        att = fta.fused_train_attention(*t)[0]
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            att, [t[i] for i in diff], cot, retain_graph=True), iters=10)
        att_p = fta.train_scorer_math(*t)[0]
        plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            att_p, [t[i] for i in diff], cot, retain_graph=True), iters=10)
        del att, att_p
        log(f"train scorer [{shape}]: K1 at G={G} D={D} {k1_ms:.4f} ms "
            f"(plain {k1_plain:.4f} ms, bound {k1_bound[0]:.4f} ms "
            f"{k1_bound[1]}, max_abs_err {k1_err:.3e}) | Function forward "
            f"(K3a+K3b+K1) {fwd_ms:.4f} ms, plain math forward "
            f"{plain_fwd_ms:.4f} ms | backward (recompute + autograd) "
            f"{bwd_ms:.4f} ms, plain backward {plain_bwd_ms:.4f} ms | {smi}")
        if not k1_err <= K1_TOL:
            raise AssertionError(f"K1 at the {shape} train shape: {k1_err}")
        out[shape] = dict(att_err=att_err, grad_rel=grad_rel, k1_ms=k1_ms,
                          k1_plain_ms=k1_plain, k1_bound_ms=k1_bound[0],
                          k1_err=k1_err, fwd_ms=fwd_ms,
                          plain_fwd_ms=plain_fwd_ms, bwd_ms=bwd_ms,
                          plain_bwd_ms=plain_bwd_ms)
    out["clsr_scan"] = check_k2_backward(smi)
    return out


def check_k2_backward(smi):
    from clsr_tpu_torch.ops import fused_scan as fs
    dev = torch.device("cuda")
    B, L, U, H = TRAIN_B, TRAIN_L, 40, 40
    g = torch.Generator(device=dev).manual_seed(30)
    r = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.7
    w = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.15
    lengths = torch.randint(1, L + 1, (B,), generator=g, device=dev)
    mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).float()
    args = [r(B, L, 2 * U), r(B, L, U), r(B, L, 4 * H), r(B, L, H),
            r(B, L, H), r(B, L, H), r(B, L, 2 * H), r(B, L, H), mask,
            r(B, U), w(U, 2 * U), w(U, U), w(H, 4 * H), w(H, 2 * H),
            w(H, H)]
    t = [a.requires_grad_(i != 8) for i, a in enumerate(args)]
    diff = [x for i, x in enumerate(t) if i != 8]
    cots = [torch.randn(*shape, generator=g, device=dev)
            for shape in ((B, U), (B, L, H), (B, H))]
    outs = fs.fused_scan(*t)
    got = torch.autograd.grad(outs, diff, cots)
    want = torch.autograd.grad(fs.scan_reference(*t), diff, cots)
    torch.cuda.synchronize()
    err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
              for a, b in zip(got, want))
    fwd_ms = cuda_ms(lambda: fs.fused_scan(*t), iters=10)
    plain_fwd_ms = cuda_ms(lambda: fs.scan_reference(*t), iters=3)
    outs = fs.fused_scan(*t)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(outs, diff, cots,
                                                 retain_graph=True), iters=3)
    log(f"K2 clsr_scan [train: B={B} L={L} U=H={U}]: forward kernel "
        f"{fwd_ms:.4f} ms, plain forward {plain_fwd_ms:.4f} ms | backward "
        f"(recompute through the plain recurrence + autograd) {bwd_ms:.4f} "
        f"ms | gradients max err / max abs {err:.3e} (tol {GRAD_REL}) "
        f"| {smi}")
    if not err <= GRAD_REL:
        raise AssertionError(f"K2's backward disagrees with autograd of the "
                             f"plain recurrence: {err}")
    return dict(fwd_ms=fwd_ms, plain_fwd_ms=plain_fwd_ms, bwd_ms=bwd_ms,
                grad_rel=err)


def train_batches(n, seed, n_users, n_items, n_cates):
    """Seeded numpy positives-only batches (G = 1) on the card."""
    from clsr_tpu_torch.data.batch import Batch
    rng = np.random.RandomState(seed)
    B, L = TRAIN_B, TRAIN_L
    out = []
    for _ in range(n):
        lengths = rng.randint(1, L + 1, B)
        mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
        ages = np.sort(rng.randint(60, 8 * 86400, (B, L)), 1)[:, ::-1]
        f32 = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, np.float32))
        i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
        out.append(Batch(
            users=i32(rng.randint(1, n_users, B)),
            items=i32(rng.randint(1, n_items, (B, 1))),
            cates=i32(rng.randint(1, n_cates, (B, 1))),
            labels=f32(np.ones((B, 1))),
            item_hist=i32(rng.randint(1, n_items, (B, L)) * mask),
            cate_hist=i32(rng.randint(1, n_cates, (B, L)) * mask),
            mask=f32(mask),
            time_diff=f32(np.log1p(rng.rand(B, L) * 3600) * mask),
            time_from_first=f32(np.log1p(ages[:, ::-1] / 60.0) * mask),
            time_to_now=f32(np.log1p(ages / 60.0) * mask),
            valid=f32(np.ones(B))).to("cuda"))
    return out


def zero_by_construction(name):
    """Gradients that are zero up to rounding: a dense bias under
    train-mode BN, and an output bias under a softmax (the scorers' over
    L, the logit head's over the G candidates)."""
    return ((".w_nn_layer" in name and name.endswith(".bias"))
            or name.endswith("w_nn_output.bias"))


def train(smi):
    from clsr_tpu_torch.config import CONFIG_DIR, load_config
    from clsr_tpu_torch.models.registry import get_model_class
    from clsr_tpu_torch.ops import fused_attention as fa
    from clsr_tpu_torch.ops import fused_scan as fs
    from clsr_tpu_torch.ops import fused_train_attention as fta
    from clsr_tpu_torch.training.state import create_train_state
    from clsr_tpu_torch.training.steps import make_train_step

    sizes = (987_995 + 1, 4_162_025 + 1, 9_440 + 1)
    base = load_config(os.path.join(CONFIG_DIR, "clsr.yaml"),
                       user_vocab="u", item_vocab="i", cate_vocab="c", seed=0)
    cfgs = {"kernel": base.replace(use_pallas_train_attention="on",
                                   use_pallas_scan=True),
            "plain": base.replace(use_pallas_train_attention="off",
                                  use_pallas_scan=False)}
    counters = (fta.train_stats0, fta.train_stats1, fa.fused_eval_attention,
                fs.fused_scan)
    names = ("train_stats0", "train_stats1", "eval_scorer", "clsr_scan")
    per_step = (2, 2, 2, 1)

    def reset():
        for c in counters:
            c.launches = 0

    def counts():
        return tuple(c.launches for c in counters)

    t0 = time.perf_counter()
    models, states, steps = {}, {}, {}
    for run, cfg in cfgs.items():
        models[run] = get_model_class("clsr")(cfg, *sizes)
        if run == "kernel":
            g = torch.Generator(device="cuda").manual_seed(6)
            with torch.no_grad():      # weights and BN away from init
                for p in models[run].parameters():
                    p.add_(torch.randn(p.shape, generator=g,
                                       device="cuda") * 0.1)
        else:
            models[run].load_state_dict(models["kernel"].state_dict())
        states[run] = create_train_state(models[run], cfg)
        steps[run] = make_train_step(models[run], cfg)
    batches = train_batches(11, 7, *sizes)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in models["kernel"].parameters())
    log(f"train: two models at clsr.yaml widths, {n_params:,} parameters "
        f"each ({n_params * 4 / 1e6:.1f} MB f32), built in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- first batch: kernel path against the plain path ----------------
    first = {}
    for run in ("kernel", "plain"):
        reset()
        gen = torch.Generator(device="cuda").manual_seed(11)
        _, parts = steps[run](states[run], batches[0], gen)
        torch.cuda.synchronize()
        first[run] = (parts, {n: p.grad.clone() for n, p in
                              models[run].named_parameters()},
                      {n: b.clone() for n, b in models[run].named_buffers()},
                      counts())
    (pk, gk, bk, ck), (pp, gp, bp, cp) = first["kernel"], first["plain"]
    loss_err = max(abs(getattr(pk, f).item() - getattr(pp, f).item())
                   / max(abs(getattr(pp, f).item()), 1e-30)
                   for f in ("loss", "data_loss", "regular_loss",
                             "contrastive_loss", "discrepancy_loss"))
    grad_bad, grad_rel, zero_abs = [], 0.0, 0.0
    for n, g in gp.items():
        d = (gk[n] - g).abs().max().item()
        mx = g.abs().max().item()
        if zero_by_construction(n):
            zero_abs = max(zero_abs, d)
            ok = d <= GRAD_REL * mx + 1e-6
        else:
            grad_rel = max(grad_rel, d / max(mx, 1e-30))
            ok = d <= GRAD_REL * mx
        if not ok:
            grad_bad.append((n, d, mx))
    bn_err = max((bk[n] - b).abs().max().item() for n, b in bp.items())
    log(f"train first batch, kernel vs plain: loss parts max rel err "
        f"{loss_err:.3e} (tol 1e-4), gradients max err / max abs "
        f"{grad_rel:.3e} (tol {GRAD_REL}; zero-by-construction biases max "
        f"abs err {zero_abs:.3e}), BN running stats max abs err "
        f"{bn_err:.3e} (tol 1e-5) | launches kernel {dict(zip(names, ck))}, "
        f"plain {dict(zip(names, cp))} | loss {pk.loss.item():.6f} | {smi}")
    if not (loss_err <= 1e-4 and not grad_bad and bn_err <= 1e-5
            and ck == per_step and cp == (0, 0, 0, 0)):
        raise AssertionError(f"train kernel path disagrees with the plain "
                             f"path: {grad_bad[:5]}")

    # ---- the main train path: 10 kernel steps, in turns with plain ones --
    del first, gk, gp, bk, bp
    torch.cuda.synchronize()
    resident_mb = torch.cuda.memory_allocated() / 1e6
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    timing = {run: dict(ms=[], losses=[], peak_mb=0.0) for run in cfgs}

    def timed_step(run, i, b):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        torch.cuda.reset_peak_memory_stats()
        start.record()
        _, parts = steps[run](states[run], b, gen)
        end.record()
        torch.cuda.synchronize()
        t = timing[run]
        t["ms"].append(start.elapsed_time(end))
        t["losses"].append(parts.loss.item())
        t["peak_mb"] = max(t["peak_mb"],
                           torch.cuda.max_memory_allocated() / 1e6)

    reset()
    for i, b in enumerate(batches[1:]):
        # plain, kernel, kernel, plain, ...: both see the same drift
        for run in (("plain", "kernel") if i % 2 == 0 else
                    ("kernel", "plain")):
            before = counts()
            timed_step(run, i, b)
            step_counts = tuple(a - c for a, c in zip(counts(), before))
            want = per_step if run == "kernel" else (0, 0, 0, 0)
            if step_counts != want:
                raise AssertionError(
                    f"{run} step {i}: launches "
                    f"{dict(zip(names, step_counts))}, want "
                    f"{dict(zip(names, want))}")
    main_counts = dict(zip(names, counts()))
    for run, t in timing.items():
        if not np.isfinite(t["losses"]).all():
            raise AssertionError(f"{run}: non-finite losses {t['losses']}")
        t["median_ms"] = statistics.median(t["ms"])
        t["examples_per_s"] = TRAIN_B / t["median_ms"] * 1e3
        log(f"train[{run}]: {len(t['ms'])} steps"
            + (f", launches {main_counts}" if run == "kernel" else "")
            + f" | median step {t['median_ms']:.3f} ms (min "
            f"{min(t['ms']):.3f}, max {max(t['ms']):.3f}), "
            f"{t['examples_per_s']:,.0f} examples/s | peak device memory "
            f"{t['peak_mb']:.1f} MB, of which {resident_mb:.1f} MB resident "
            f"before the run (both models with their Adam states) | losses "
            f"{t['losses'][0]:.5f} .. {t['losses'][-1]:.5f} | {smi}")
    if min(main_counts.values()) <= 0:
        raise AssertionError("a kernel never launched on the train path")
    out = dict(launches=main_counts, resident_mb=resident_mb, timing=timing,
               loss_rel_err=loss_err, grad_rel_err=grad_rel,
               zero_grad_abs_err=zero_abs, bn_err=bn_err)
    out["profile"] = {run: profile_steps(steps[run], states[run],
                                         batches[1:4], run, smi)
                      for run in cfgs}
    return out


def profile_steps(step, state, batch_list, run, smi):
    """torch.profiler over a few train steps: per `train_step.<phase>`
    range its host ms and its span on the device, the device's busy
    share of the window (kernel time, annotations left out), the kernel
    launches per step, and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev_self = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    step(state, batch_list[0], torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, b in enumerate(batch_list):
            step(state, b, torch.Generator(device="cuda").manual_seed(i))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = len(batch_list)
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in on_device
               if not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("train_step.")]
    busy_ms = sum(dev_self(e) for e in kernels) / 1e3 / n
    launches = sum(e.count for e in kernels) / n
    phases = {}
    for e in events:
        if e.key.startswith("train_step."):
            ph = phases.setdefault(e.key[len("train_step."):], {})
            if e.device_type == DeviceType.CPU:
                ph["host_ms"] = e.cpu_time_total / 1e3 / n
            else:
                ph["device_span_ms"] = e.device_time_total / 1e3 / n
    top = [(e.key[:90], dev_self(e) / 1e3 / n, e.count / n) for e in
           sorted(kernels, key=dev_self, reverse=True)[:10]]
    log(f"profile[{run}]: {n} steps, {wall_ms / n:.3f} ms each under the "
        f"profiler; device busy {busy_ms:.3f} ms per step "
        f"({100 * busy_ms * n / wall_ms:.1f}% of the window, idle "
        f"{100 - 100 * busy_ms * n / wall_ms:.1f}%), {launches:,.0f} kernel "
        f"launches per step | {smi}")
    for name, ph in sorted(phases.items()):
        log(f"  profile[{run}] phase {name}: host "
            f"{ph.get('host_ms', 0.0):.3f} ms, device span "
            f"{ph.get('device_span_ms', 0.0):.3f} ms per step")
    for name, ms, calls in top:
        log(f"  profile[{run}] kernel {ms:8.3f} ms/step {calls:7.0f} "
            f"launches/step  {name}")
    return dict(wall_ms_per_step=wall_ms / n, busy_ms_per_step=busy_ms,
                launches_per_step=launches, phases=phases, top_kernels=top)


def main():
    smi = card_check()
    sys.path.insert(0, ROOT)
    build_s = build_kernels()
    k1 = check_k1(smi)
    k2 = check_k2(smi)
    served = serve(smi)
    k3 = check_k3(smi)
    scorer = check_train_scorer(smi)
    trained = train(smi)
    serve_counts = {"eval_scorer": served["runs"]["k1"]["launches"]
                    ["eval_scorer"],
                    "clsr_scan": served["runs"]["k1k2"]["launches"]
                    ["clsr_scan"]}
    meta = {
        "eval_scorer": ("clsr_tpu_torch/csrc/eval_scorer.cu",
                        "clsr_tpu/ops/pallas_attention.py:147"),
        "clsr_scan": ("clsr_tpu_torch/csrc/clsr_scan.cu",
                      "clsr_tpu/ops/pallas_scan.py:45"),
        "train_stats0": ("clsr_tpu_torch/csrc/train_stats.cu",
                         "clsr_tpu/ops/pallas_attention.py:429"),
        "train_stats1": ("clsr_tpu_torch/csrc/train_stats.cu",
                         "clsr_tpu/ops/pallas_attention.py:459"),
    }
    # K1 and K2 at the serving shapes of phases 3-4, K3a/K3b at the
    # short-term train shape; the other shapes are in chip_smoke.json
    timed = {"eval_scorer": k1, "clsr_scan": k2,
             "train_stats0": k3["train_stats0/short"],
             "train_stats1": k3["train_stats1/short"]}
    no_library = "no single PyTorch call computes this function"
    kernels = []
    for name, k in timed.items():
        source, replaces = meta[name]
        by_path = {"train": trained["launches"][name]}
        if name in serve_counts:
            by_path["serve"] = serve_counts[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            "library_note": no_library})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "build_s": build_s, "k1": k1, "k2": k2,
                   "serve": served, "k3": k3, "train_scorer": scorer,
                   "train": trained}, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
