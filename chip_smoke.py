"""Smoke run of the PyTorch port on one NVIDIA GPU (no CPU mode).

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card check: CUDA present, `nvidia-smi` name and power limit, TF32 off;
  2. build every CUDA kernel of the serving path from csrc/ (nvcc, all at
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
     device memory.
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


def check_k1():
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
        f"{n_bytes / 1e6:.2f} MB, bound {bound_ms:.4f} ms ({bound_by})")
    if not err <= K1_TOL:
        raise AssertionError(f"K1 disagrees with its plain version: {err}")
    return dict(name="eval_scorer", max_abs_err=err, max_rel_err=rel, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                flops=flops, bytes=n_bytes)


def check_k2():
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
        f"the real floor is the {L} dependent steps")
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


def main():
    smi = card_check()
    sys.path.insert(0, ROOT)
    build_s = build_kernels()
    k1 = check_k1()
    k2 = check_k2()
    served = serve(smi)
    launches = {"eval_scorer": served["runs"]["k1"]["launches"]["eval_scorer"],
                "clsr_scan": served["runs"]["k1k2"]["launches"]["clsr_scan"]}
    meta = {
        "eval_scorer": ("clsr_tpu_torch/csrc/eval_scorer.cu",
                        "clsr_tpu/ops/pallas_attention.py:147"),
        "clsr_scan": ("clsr_tpu_torch/csrc/clsr_scan.cu",
                      "clsr_tpu/ops/pallas_scan.py:45"),
    }
    kernels = []
    for k in (k1, k2):
        source, replaces = meta[k["name"]]
        kernels.append({
            "name": k["name"], "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[k["name"]],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "build_s": build_s, "k1": k1, "k2": k2,
                   "serve": served}, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
