"""The train-mode fused target-attention scorer: K3a + K3b, then K1.

Counterpart of clsr_tpu/ops/pallas_attention.py:533-734.  Train-mode BN
needs batch statistics over the whole [B, L, G] extent, which the eval
scorer's blockwise view (K1) cannot see, so the forward runs in two
passes:

  K3a  per-channel sums of the biasless first-layer activation x0 ->
       mean0, var0 = E[x0^2] - E[x0]^2 (no clamp, as JAX) -> the BN
       affine a0 = scale0 / sqrt(var0 + eps), c0 = shift0 - a0 * mean0;
  K3b  recompute x0, y0 = relu(a0 x0 + c0), per-channel sums of the
       biasless x1 = y0 W1 -> mean1, var1 -> (a1, c1);
  K1   the eval scorer with those folds (csrc/eval_scorer.cu).

The kernels see the biasless activations, so the returned means are
shifted by the dense biases (mean0 + b0, mean1 + b1) for the BN
running-average update; the variances are shift-invariant.  The scorer's
output bias b2 is not an input: it cancels in the softmax over L.

  * `train_stats_reference` — the plain version of K3a (no fold) and
    K3b (fold = (a0, c0, w1)): (sum, sum of squares) per channel.
  * `train_stats0` / `train_stats1` — the wrappers: plain version on CPU
    tensors; on CUDA tensors they launch csrc/train_stats.cu or raise.
    `.launches` counts kernel launches.
  * `train_scorer_math` — the port of `_xla_train_scorer`: the exact
    train-mode math of the plain FcnNet path, used by the backward.
  * `fused_train_attention` — a `torch.autograd.Function`: the forward
    above; the backward is autograd of `train_scorer_math` recomputed at
    the saved inputs (no [B, L, G, H] activation is saved), as the JAX
    custom VJP does (:721-731).  `enable_bn=False` gives the identity
    affine with the dense biases as shifts (:659-665) and no statistics.
"""

from __future__ import annotations

import torch

from clsr_tpu_torch.ops import _build
from clsr_tpu_torch.ops.fused_attention import (MASK_PADDING_VALUE,
                                                fused_eval_attention)
from clsr_tpu_torch.ops.fused_scan import recompute_grads
from clsr_tpu_torch.ops.mlp import BN_EPSILON

# widths the statistics kernels are compiled for (csrc/train_stats.cu):
# D of the clsr.yaml short- and long-term scorers, H0, H1
KERNEL_D, KERNEL_H0, KERNEL_H1 = (80, 40), 80, 40


def _x0(query, keys_proj, wk_eff, wq_eff, wm):
    """Biasless first-layer activation [B, L, G, H0]."""
    return (torch.einsum("bld,bgd,dh->blgh", keys_proj, query, wm)
            + (keys_proj @ wk_eff)[:, :, None, :]
            + (query @ wq_eff)[:, None, :, :])


def train_stats_reference(query, keys_proj, wk_eff, wq_eff, wm, fold=None):
    """Plain version of K3a (fold None) and K3b (fold = (a0, c0, w1)):
    per-channel (sum, sum of squares) of x0, or of x1 = relu(a0 x0 +
    c0) @ w1, over every (b, l, g) row."""
    x = _x0(query, keys_proj, wk_eff, wq_eff, wm)
    if fold is not None:
        a0, c0, w1 = fold
        x = torch.relu(x * a0 + c0) @ w1
    axes = (0, 1, 2)
    return x.sum(axes), (x * x).sum(axes)


def _stats(kernel_pass, query, keys_proj, wk_eff, wq_eff, wm, fold):
    args = (query, keys_proj, wk_eff, wq_eff, wm) + tuple(fold)
    if query.device.type == "cpu":
        return train_stats_reference(query, keys_proj, wk_eff, wq_eff, wm,
                                     fold if kernel_pass else None)
    if query.device.type != "cuda":
        raise ValueError(f"no kernel for device {query.device}")
    B, G, D = query.shape
    L = keys_proj.shape[1]
    H0 = wm.shape[1]
    H1 = fold[2].shape[1] if kernel_pass else KERNEL_H1
    shapes = [(B, G, D), (B, L, D), (D, H0), (D, H0), (D, H0),
              (H0,), (H0,), (H0, H1)][:len(args)]
    names = ("query", "keys_proj", "wk_eff", "wq_eff", "wm", "a0", "c0",
             "w1")
    _build.check_args(names, args, shapes, query.device)
    if D not in KERNEL_D or (H0, H1) != (KERNEL_H0, KERNEL_H1):
        raise ValueError(
            f"the train statistics kernels are compiled for D in "
            f"{KERNEL_D}, H0 = {KERNEL_H0}, H1 = {KERNEL_H1}, got D={D}, "
            f"H0={H0}" + (f", H1={H1}" if kernel_pass else "") + "; set "
            f"use_pallas_train_attention='off' for other widths")
    H = H1 if kernel_pass else H0
    if B == 0 or L == 0 or G == 0:
        zeros = torch.zeros(H, device=query.device, dtype=torch.float32)
        return zeros, zeros.clone()
    lib = _build.load("train_stats")
    if lib.clsr_train_stats_smem_bytes(D, G, kernel_pass) > _build.MAX_SMEM:
        raise ValueError(f"the train statistics kernels do not fit G={G} "
                         f"candidates in one block")
    n_chunks = -(-L // lib.clsr_train_stats_chunk_l())
    sums = torch.empty(B, n_chunks, H, device=query.device,
                       dtype=torch.float32)
    sqs = torch.empty_like(sums)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = lib.clsr_train_stats1 if kernel_pass else lib.clsr_train_stats0
        dims = (B, L, G, D, H0, H1) if kernel_pass else (B, L, G, D, H0)
        rc = fn(*(t.data_ptr() for t in args), sums.data_ptr(),
                sqs.data_ptr(), *dims, stream)
    _build.check(rc, f"train_stats{kernel_pass}")
    (train_stats1 if kernel_pass else train_stats0).launches += 1
    return sums.sum((0, 1)), sqs.sum((0, 1))


def train_stats0(query, keys_proj, wk_eff, wq_eff, wm):
    """K3a: per-channel (sum, sum of squares) of the biasless x0 [H0]."""
    return _stats(0, query, keys_proj, wk_eff, wq_eff, wm, ())


def train_stats1(query, keys_proj, wk_eff, wq_eff, wm, a0, c0, w1):
    """K3b: per-channel (sum, sum of squares) of the biasless
    x1 = relu(a0 x0 + c0) @ w1 [H1]."""
    return _stats(1, query, keys_proj, wk_eff, wq_eff, wm, (a0, c0, w1))


train_stats0.launches = 0
train_stats1.launches = 0


def train_scorer_math(keys, keys_proj, query, mask, k0, b0, scale0, shift0,
                      w1, b1, scale1, shift1, w2, enable_bn=True,
                      eps=BN_EPSILON):
    """`_xla_train_scorer` (pallas_attention.py:533-581): SplitFirstDense
    -> train BN -> relu, twice, -> logits -> masked softmax over L ->
    weighted sum of the keys.  Returns (att [B, G, Dk], mean0, var0,
    mean1, var1), the means of the biased activations."""
    D = keys_proj.shape[-1]
    wk, wq, wd, wm = k0.split(D, dim=0)
    x0 = _x0(query, keys_proj, wk + wd, wq - wd, wm) + b0
    if enable_bn:
        mean0 = x0.mean((0, 1, 2))
        var0 = (x0 * x0).mean((0, 1, 2)) - mean0 * mean0
        y0 = torch.relu(scale0 * (x0 - mean0) * torch.rsqrt(var0 + eps)
                        + shift0)
    else:
        mean0 = var0 = torch.zeros(x0.shape[-1], device=x0.device)
        y0 = torch.relu(x0)
    x1 = y0 @ w1 + b1
    if enable_bn:
        mean1 = x1.mean((0, 1, 2))
        var1 = (x1 * x1).mean((0, 1, 2)) - mean1 * mean1
        y1 = torch.relu(scale1 * (x1 - mean1) * torch.rsqrt(var1 + eps)
                        + shift1)
    else:
        mean1 = var1 = torch.zeros(x1.shape[-1], device=x1.device)
        y1 = torch.relu(x1)
    logits = y1 @ w2                                         # [B, L, G]
    masked = torch.where(mask[:, :, None] > 0, logits,
                         torch.full_like(logits, MASK_PADDING_VALUE))
    w = torch.softmax(masked, dim=1)
    att = torch.einsum("blg,bld->bgd", w, keys)
    return att, mean0, var0, mean1, var1


def _forward(keys, keys_proj, query, mask, k0, b0, scale0, shift0, w1, b1,
             scale1, shift1, w2, enable_bn, eps=BN_EPSILON):
    """K3a, fold, K3b, fold, K1 (pallas_attention.py:584-674)."""
    B, L, _ = keys.shape
    D = keys_proj.shape[-1]
    G = query.shape[1]
    H0, H1 = w1.shape
    wk, wq, wd, wm = k0.split(D, dim=0)
    wk_eff = (wk + wd).contiguous()
    wq_eff = (wq - wd).contiguous()
    wm = wm.contiguous()
    w1 = w1.contiguous()
    if enable_bn:
        n_rows = B * L * G
        s0, q0 = train_stats0(query, keys_proj, wk_eff, wq_eff, wm)
        mean0 = s0 / n_rows                       # biasless x0 mean
        var0 = q0 / n_rows - mean0 * mean0
        a0 = scale0 * torch.rsqrt(var0 + eps)
        c0 = shift0 - a0 * mean0
        s1, q1 = train_stats1(query, keys_proj, wk_eff, wq_eff, wm,
                              a0.contiguous(), c0.contiguous(), w1)
        mean1 = s1 / n_rows
        var1 = q1 / n_rows - mean1 * mean1
        a1 = scale1 * torch.rsqrt(var1 + eps)
        c1 = shift1 - a1 * mean1
        stats = (mean0 + b0, var0, mean1 + b1, var1)
    else:
        a0, c0 = torch.ones_like(b0), b0
        a1, c1 = torch.ones_like(b1), b1
        stats = (torch.zeros_like(b0), torch.zeros_like(b0),
                 torch.zeros_like(b1), torch.zeros_like(b1))
    att = fused_eval_attention(
        keys, keys_proj, query, mask, wk_eff, wq_eff, wm,
        *(t.contiguous() for t in (a0, c0, w1, a1, c1, w2)))
    return (att,) + stats


class _FusedTrainAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, keys, keys_proj, query, mask, k0, b0, scale0, shift0,
                w1, b1, scale1, shift1, w2, enable_bn):
        inputs = (keys, keys_proj, query, mask, k0, b0, scale0, shift0, w1,
                  b1, scale1, shift1, w2)
        ctx.save_for_backward(*inputs)
        ctx.enable_bn = enable_bn
        return _forward(*inputs, enable_bn)

    @staticmethod
    def backward(ctx, *out_grads):
        enable_bn = ctx.enable_bn

        def math(*inputs):
            return train_scorer_math(*inputs, enable_bn=enable_bn)

        grads = recompute_grads(math, ctx.saved_tensors,
                                ctx.needs_input_grad[:13], out_grads)
        return tuple(grads) + (None,)


def fused_train_attention(keys, keys_proj, query, mask, k0, b0, scale0,
                          shift0, w1, b1, scale1, shift1, w2,
                          enable_bn=True):
    """keys [B, L, Dk], keys_proj [B, L, D], query [B, G, D], mask [B, L]
    (contiguous f32), the att_fcn's first-layer kernel k0 [4D, H0] and
    bias b0, BN scale/shift per layer, w1 [H0, H1], b1, and the output
    kernel w2 [H1] -> (att [B, G, Dk], mean0 + b0, var0, mean1 + b1,
    var1), differentiable in every input but `mask`."""
    return _FusedTrainAttention.apply(keys, keys_proj, query, mask.detach(),
                                      k0, b0, scale0, shift0, w1, b1,
                                      scale1, shift1, w2, enable_bn)
