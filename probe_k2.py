"""Probe of K2's forward kernel on one NVIDIA GPU (no CPU mode).

    python3 probe_k2.py

Three questions about `clsr_tpu_torch/csrc/clsr_scan.cu`'s forward.  The
first and third are answered by building variants of the source (text
edits of the forward's part of the file, one nvcc each, all at once) and
loading them in place of the built library:

1. Where a dependent step's time goes.  Device ms by CUDA graph replay at
   B = 8, 64 and 400 (L = 50, U = H = 40, lengths 1..50), in two rounds
   taken in turns, of the shipped kernel and of timing-only variants
   whose results are wrong by design: `fast_math` (sigmoid by __expf and
   __fdividef, tanh by tanh.approx), `cached_inputs` (every step loads
   step 0's inputs, so the prefetch always hits L1), `no_block_barrier`
   (__syncthreads as __syncwarp), `no_shuffle` (the lane sums left
   unreduced) and `all_four`; and `two_partials`, a correct variant that
   splits each product into two partial sums where R·G < 8.
2. Which rows a block to take at batch sizes between the serving and
   the train ones: chip_smoke.py's phase 4 case at B = 100, 133, 200,
   264, 300 and 528 (L = 50), with each of FORWARD_ROWS forced.
3. How close phase 8's first-batch gate of chip_smoke.py (every gradient
   of the kernel path within 1e-4 of its max abs of the plain path's) sits
   to a discontinuity of the train step at its batch: the gate's value
   with the shipped kernel and with `two_partials`; then with K2's forward
   replaced by the plain recurrence, exact and with its final h1 moved by
   one ulp up or down (or not) at random, for 12 seeds.  A relu or hinge
   that flips on such a move changes a gradient by far more than rounding
   does.

Prints one line per measurement and writes chiprun_out/probe_k2.json.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

TWO_PARTIALS = """template <int KQ, int R, int G>
__device__ __forceinline__ void partial_dots(const float* s, int q,
                                             const float (&w)[G][KQ],
                                             float (&acc)[R][G]) {
  constexpr int P = R * G >= 8 ? 1 : 2;
  float a[P][R][G];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g) a[p][r][g] = 0.f;
#pragma unroll
  for (int i = 0; i < KQ; ++i) {
    float v[R];
    load_rows<R>(s, i * kLanes + q, v);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g)
        a[i % P][r][g] = fmaf(v[r], w[g][i], a[i % P][r][g]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int g = 0; g < G; ++g)
      acc[r][g] = P == 1 ? a[0][r][g] : a[0][r][g] + a[P - 1][r][g];
}
"""
FAST = """__device__ __forceinline__ float fsig(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float ftanh(float x) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(x));
  return t;
}
"""
MARK = "// ---- the forward ----"


def two_partials(f):
    start = f.index("template <int KQ, int R, int G>\n__device__ "
                    "__forceinline__ void partial_dots")
    end = f.index("\n}\n", f.index("acc[r][g] = fmaf", start)) + 3
    return f[:start] + TWO_PARTIALS + f[end:]


def fast_math(f):
    f = f.replace("sigmoidf_(", "fsig(").replace("tanhf(", "ftanh(")
    return f.replace(MARK, MARK + "\n" + FAST, 1)


def cached_inputs(f):
    return f.replace("if (l + 1 < L) load_step(l + 1,",
                     "if (l + 1 < L) load_step(0,")


def no_block_barrier(f):
    return f.replace("__syncthreads();", "__syncwarp();")


def no_shuffle(f):
    return re.sub(r"__shfl_xor_sync\(kFull, ([^,]+), \d\)", r"(\1)", f)


VARIANTS = {
    "shipped": lambda f: f,
    "two_partials": two_partials,
    "fast_math": fast_math,
    "cached_inputs": cached_inputs,
    "no_block_barrier": no_block_barrier,
    "no_shuffle": no_shuffle,
    "all_four": lambda f: no_shuffle(no_block_barrier(
        cached_inputs(fast_math(f)))),
}


def build_variants(out_dir):
    """Every variant's library, bound as clsr_scan's."""
    from clsr_tpu_torch.ops import _build
    src = (_build.CSRC / "clsr_scan.cu").read_text()
    head, fwd = src[:src.index(MARK)], src[src.index(MARK):]
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, edit in VARIANTS.items():
        body = edit(fwd)
        if name != "shipped" and body == fwd:
            raise RuntimeError(f"variant {name} changed nothing")
        cu = os.path.join(out_dir, f"k2_{name}.cu")
        with open(cu, "w") as f:
            f.write(head + body)
        so = cu[:-3] + ".so"
        jobs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(so)
        for fn, (argtypes, restype) in _build._SIGNATURES["clsr_scan"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


class _Stop(Exception):
    pass


def first_batch_gate(smi):
    """Phase 8 of chip_smoke.py up to its first-batch comparison: the
    kernel path's largest gradient error over its max abs."""
    seen = {}
    log = cs.log

    def catch(*a):
        log(*a)
        line = str(a[0]) if a else ""
        if line.startswith("train first batch"):
            seen["rel"] = float(re.search(
                r"gradients max err / max abs ([0-9.e+-]+)", line).group(1))
            raise _Stop()

    cs.log = catch
    try:
        cs.train(smi)
    except _Stop:
        pass
    finally:
        cs.log = log
    return seen["rel"]


def main():
    from clsr_tpu_torch.ops import _build
    from clsr_tpu_torch.ops import fused_scan as fs
    smi = cs.card_check()
    libs = build_variants(os.path.join(ROOT, "clsr_tpu_torch", "_build",
                                       "probe"))
    out = {"card": smi, "device_ms": {}, "gate": {}}
    shapes = (("B8", 8, 2), ("B64", 64, 1), ("B400", 400, 30))
    inputs = {name: cs.k2_inputs(B, 50, seed) for name, B, seed in shapes}
    for rnd in range(2):
        order = list(libs) if rnd == 0 else list(libs)[::-1]
        for name in order:
            _build._loaded["clsr_scan"] = libs[name]
            times = [cs.graph_ms(lambda: fs._forward(*inputs[s]), 20)
                     for s, _, _ in shapes]
            out["device_ms"].setdefault(name, []).append(times)
            cs.log(f"K2 forward [{name}] round {rnd}: device ms "
                   + ", ".join(f"{s} {t:.4f} ({t * 1e3 / 50:.3f} us/step)"
                               for (s, _, _), t in zip(shapes, times))
                   + f" | {smi}")
    _build._loaded["clsr_scan"] = libs["shipped"]
    out["rows_device_ms"] = {
        B: cs.k2_forward_case(f"rows B={B}", cs.k2_inputs(B, 50, 5), False,
                              smi, plain_iters=1)["rows_device_ms"]
        for B in (100, 133, 200, 264, 300, 528)}
    for name in ("shipped", "two_partials"):
        _build._loaded["clsr_scan"] = libs[name]
        out["gate"][name] = first_batch_gate(smi)
    _build._loaded["clsr_scan"] = libs["shipped"]
    kernel_forward = fs._forward
    noise = {"seed": None}

    def plain_forward(*args, keep_carries=False):
        args = tuple(a.detach() for a in args)
        got = list(fs.scan_forward_reference(*args)) if keep_carries else \
            list(fs.scan_reference(*args)) + [None]
        if noise["seed"] is not None:
            g = torch.Generator(device="cuda").manual_seed(noise["seed"])
            h = got[0]
            step = torch.randint(-1, 2, h.shape, generator=g, device="cuda")
            up = torch.nextafter(h, torch.full_like(h, float("inf")))
            down = torch.nextafter(h, torch.full_like(h, -float("inf")))
            got[0] = torch.where(step > 0, up, torch.where(step < 0, down, h))
        return tuple(got)

    fs._forward = plain_forward
    try:
        out["gate"]["plain_forward"] = first_batch_gate(smi)
        out["gate"]["plain_forward_ulp_h1"] = []
        for seed in range(1, 13):
            noise["seed"] = seed
            out["gate"]["plain_forward_ulp_h1"].append(first_batch_gate(smi))
    finally:
        fs._forward = kernel_forward
    ulp = out["gate"]["plain_forward_ulp_h1"]
    cs.log(f"phase 8 first-batch gate (tol {cs.GRAD_REL}): shipped "
           f"{out['gate']['shipped']:.3e}, two_partials "
           f"{out['gate']['two_partials']:.3e}, plain forward "
           f"{out['gate']['plain_forward']:.3e}, plain forward with h1 moved "
           f"by +-1 ulp at random: {', '.join(f'{x:.3e}' for x in ulp)} "
           f"({sum(x > cs.GRAD_REL for x in ulp)} of {len(ulp)} over the "
           f"tolerance) | {smi}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "probe_k2.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
