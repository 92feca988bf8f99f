"""K1: the fused eval-mode grouped target-attention scorer.

Counterpart of clsr_tpu/ops/pallas_attention.py (`fold_scorer_params`
:737-765 and the TPU kernel `_scorer_kernel` :147 behind
`fused_eval_attention` :217).  In eval mode the scorer MLP's BatchNorm
is a per-channel affine, so the chain

    x0 = kp@Wk_eff + q@Wq_eff + (kp*q)@Wm       (split first layer)
    y0 = relu(a0*x0 + c0)                       (bias + BN folded)
    y1 = relu(a1*(y0@W1) + c1)
    logit = y1 . w2                             (b2 cancels in softmax)
    att = softmax_L(mask ? logit : -2^32+1) @ keys

runs in one CUDA kernel (csrc/eval_scorer.cu) and the [B, L, G, H]
hidden activations never reach device memory.

`fused_eval_attention` is the wrapper: on CPU tensors it computes
`eval_scorer_reference`, the plain PyTorch version; on CUDA tensors it
launches the kernel or raises.  `fused_eval_attention.launches` counts
kernel launches.  The kernel is compiled for the clsr.yaml scorer widths
only (`KERNEL_WIDTHS`); other widths raise on CUDA.  The train-mode
scorer (ops/fused_train_attention.py) runs it too, with the batch-BN
folds.
"""

from __future__ import annotations

import torch

from clsr_tpu_torch.ops import _build

MASK_PADDING_VALUE = -(2.0 ** 32) + 1  # clsr.py:375

# (D, Dk, H0, H1) the kernel is compiled for (csrc/eval_scorer.cu): the
# clsr.yaml short-term scorer and, in train mode, its long-term scorer
KERNEL_WIDTHS = ((80, 40, 80, 40), (40, 40, 80, 40))


def fold_scorer_params(fcn, D: int, enable_bn: bool):
    """Fold an att_fcn `FcnNet` (eval-mode BN) into the kernel's
    (wk_eff, wq_eff, wm, a0, c0, w1, a1, c1, w2), all contiguous f32.

    wk_eff = W0[k] + W0[d], wq_eff = W0[q] - W0[d], wm = W0[m] (the
    split of the [4D, H0] first-layer kernel); a_i, c_i fold layer i's
    dense bias and BN (a=1, c=bias without BN); w2 = output kernel."""
    k0 = fcn.w_nn_layer0.kernel
    wk, wq, wd, wm = k0.split(D, dim=0)

    def affine(idx, bias):
        if not enable_bn:
            return torch.ones_like(bias), bias
        return getattr(fcn, f"bn{idx}").fold(bias)

    a0, c0 = affine(0, fcn.w_nn_layer0.bias)
    a1, c1 = affine(1, fcn.w_nn_layer1.bias)
    out = (wk + wd, wq - wd, wm, a0, c0, fcn.w_nn_layer1.weight.t(), a1, c1,
           fcn.w_nn_output.weight[0])
    return tuple(t.contiguous() for t in out)


def eval_scorer_reference(keys, keys_proj, query, mask, wk_eff, wq_eff,
                          wm, a0, c0, w1, a1, c1, w2) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [B, G, Dk] f32."""
    x0 = (torch.einsum("bld,bgd,dh->blgh", keys_proj, query, wm)
          + (keys_proj @ wk_eff)[:, :, None, :]
          + (query @ wq_eff)[:, None, :, :])
    y0 = torch.relu(x0 * a0 + c0)
    y1 = torch.relu((y0 @ w1) * a1 + c1)
    logits = y1 @ w2                                         # [B, L, G]
    masked = torch.where(mask[:, :, None] > 0, logits,
                         torch.full_like(logits, MASK_PADDING_VALUE))
    w = torch.softmax(masked, dim=1)
    return torch.einsum("blg,bld->bgd", w, keys)


_ARG_NAMES = ("keys", "keys_proj", "query", "mask", "wk_eff", "wq_eff",
              "wm", "a0", "c0", "w1", "a1", "c1", "w2")


def fused_eval_attention(keys, keys_proj, query, mask, wk_eff, wq_eff, wm,
                         a0, c0, w1, a1, c1, w2) -> torch.Tensor:
    """keys [B, L, Dk], keys_proj [B, L, D], query [B, G, D], mask [B, L]
    plus the folded weights (see fold_scorer_params) -> [B, G, Dk] f32."""
    args = (keys, keys_proj, query, mask, wk_eff, wq_eff, wm, a0, c0, w1,
            a1, c1, w2)
    if keys.device.type == "cpu":
        return eval_scorer_reference(*args)
    if keys.device.type != "cuda":
        raise ValueError(f"no kernel for device {keys.device}")
    B, L, Dk = keys.shape
    D = keys_proj.shape[-1]
    G = query.shape[1]
    H0, H1 = w1.shape
    _build.check_args(_ARG_NAMES, args,
                      [(B, L, Dk), (B, L, D), (B, G, D), (B, L), (D, H0),
                       (D, H0), (D, H0), (H0,), (H0,), (H0, H1), (H1,),
                       (H1,), (H1,)], keys.device)
    if (D, Dk, H0, H1) not in KERNEL_WIDTHS:
        raise ValueError(
            f"the eval scorer kernel is compiled for (D, Dk, H0, H1) in "
            f"{KERNEL_WIDTHS}, got {(D, Dk, H0, H1)}; set "
            f"use_pallas_eval_attention (or, in training, "
            f"use_pallas_train_attention) to 'off' for other widths")
    out = torch.empty(B, G, Dk, device=keys.device, dtype=torch.float32)
    if B == 0 or G == 0:
        return out
    lib = _build.load("eval_scorer")
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.clsr_eval_scorer(*(t.data_ptr() for t in args),
                                  out.data_ptr(), B, L, G, D, Dk, H0, H1,
                                  stream)
    _build.check(rc, "eval_scorer")
    fused_eval_attention.launches += 1
    return out


fused_eval_attention.launches = 0
