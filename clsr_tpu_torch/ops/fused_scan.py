"""K2: the three-cell CLSR recurrence, forward kernel and recompute backward.

Counterpart of clsr_tpu/ops/pallas_scan.py: `scan_reference` transcribes
`_scan_reference` (:185-222) and `fused_scan` is the custom-VJP
`fused_scan` (:225-248) whose TPU kernel is `_kernel` (:45).  All L
steps of the interest-evolve GRU (h1_0 = user_short), the Time4LSTM
(forget bias +1, time gates tn/tl, output term ot) and the causal2 GRU,
with masked carry-through x = mt*x_new + (1-mt)*x.  The candidate biases
come folded into xc1/xc2; the five recurrent matrices are the only
weights.  Returns (h1_final [B, U], outs [B, L, H] = mt*m_new, h2_final
[B, H]).

`fused_scan` is a `torch.autograd.Function`.  Its forward, on CPU
tensors, computes `scan_reference`; on CUDA tensors it launches
csrc/clsr_scan.cu or raises.  It saves its inputs, not activations; its
backward recomputes `scan_reference` under autograd from them and
returns the gradients of the inputs that need one (the JAX backward is
the VJP of `_scan_reference` too, :243-245; there is no backward
kernel).  `mask` gets no gradient.  `fused_scan.launches` counts kernel
launches.
"""

from __future__ import annotations

import torch

from clsr_tpu_torch.ops import _build


def scan_reference(xg1, xc1, xw, tn, tl, ot, xg2, xc2, mask, ushort,
                   whg1, whc1, wh4, whg2, whc2):
    """Plain PyTorch recurrence, one Python step per history position."""
    B, L, _ = xw.shape
    U = ushort.shape[-1]
    H = whc2.shape[-1]
    h1 = ushort
    c = torch.zeros(B, H, dtype=xw.dtype, device=xw.device)
    m = torch.zeros_like(c)
    h2 = torch.zeros_like(c)
    outs = []
    for t in range(L):
        mt = mask[:, t, None]
        gates1 = torch.sigmoid(xg1[:, t] + h1 @ whg1)
        r1, u1 = gates1[:, :U], gates1[:, U:]
        cand1 = torch.tanh(xc1[:, t] + (r1 * h1) @ whc1)
        h1 = mt * (u1 * h1 + (1 - u1) * cand1) + (1 - mt) * h1
        mat = xw[:, t] + m @ wh4
        i, j = mat[:, :H], mat[:, H:2 * H]
        f, o = mat[:, 2 * H:3 * H], mat[:, 3 * H:]
        o = o + ot[:, t]
        c_new = (torch.sigmoid(f + 1.0) * torch.sigmoid(tl[:, t]) * c
                 + torch.sigmoid(i) * torch.sigmoid(tn[:, t])
                 * torch.tanh(j))
        m_new = torch.sigmoid(o) * torch.tanh(c_new)
        c = mt * c_new + (1 - mt) * c
        m = mt * m_new + (1 - mt) * m
        gates2 = torch.sigmoid(xg2[:, t] + h2 @ whg2)
        r2, u2 = gates2[:, :H], gates2[:, H:]
        cand2 = torch.tanh(xc2[:, t] + (r2 * h2) @ whc2)
        h2 = mt * (u2 * h2 + (1 - u2) * cand2) + (1 - mt) * h2
        outs.append(mt * m_new)
    return h1, torch.stack(outs, dim=1), h2


_ARG_NAMES = ("xg1", "xc1", "xw", "tn", "tl", "ot", "xg2", "xc2", "mask",
              "ushort", "whg1", "whc1", "wh4", "whg2", "whc2")


def _forward(*args):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    xw = args[2]
    if xw.device.type == "cpu":
        return scan_reference(*args)
    if xw.device.type != "cuda":
        raise ValueError(f"no kernel for device {xw.device}")
    (xg1, xc1, xw, tn, tl, ot, xg2, xc2, mask, ushort,
     whg1, whc1, wh4, whg2, whc2) = args
    B, L, _ = xw.shape
    U = ushort.shape[-1]
    H = whc2.shape[-1]
    shapes = [(B, L, 2 * U), (B, L, U), (B, L, 4 * H), (B, L, H),
              (B, L, H), (B, L, H), (B, L, 2 * H), (B, L, H), (B, L),
              (B, U), (U, 2 * U), (U, U), (H, 4 * H), (H, 2 * H), (H, H)]
    _build.check_args(_ARG_NAMES, args, shapes, xw.device)
    lib = _build.load("clsr_scan")
    if (2 * U + 6 * H > 1024
            or lib.clsr_scan_smem_bytes(U, H) > _build.MAX_SMEM):
        raise ValueError(f"the recurrence kernel does not fit U={U}, H={H} "
                         f"in one block")
    outs = torch.empty(B, L, H, device=xw.device, dtype=torch.float32)
    h1f = torch.empty(B, U, device=xw.device, dtype=torch.float32)
    h2f = torch.empty(B, H, device=xw.device, dtype=torch.float32)
    if B == 0:
        return h1f, outs, h2f
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.clsr_scan_forward(*(t.data_ptr() for t in args),
                                   outs.data_ptr(), h1f.data_ptr(),
                                   h2f.data_ptr(), B, L, U, H, stream)
    _build.check(rc, "clsr_scan")
    fused_scan.launches += 1
    return h1f, outs, h2f


def recompute_grads(fn, inputs, needs, out_grads):
    """Gradients of `fn(*inputs)` for the inputs flagged in `needs`, by
    recomputing `fn` under autograd from detached copies; `out_grads`
    pair with fn's outputs (None = zero).  None for the other inputs."""
    with torch.enable_grad():
        det = [t.detach().requires_grad_(n) if isinstance(t, torch.Tensor)
               else t for t, n in zip(inputs, needs)]
        outs = fn(*det)
        pairs = [(o, g) for o, g in zip(outs, out_grads)
                 if g is not None and o.requires_grad]
        wanted = [t for t, n in zip(det, needs) if n]
        if not pairs or not wanted:
            return [None] * len(inputs)
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                       [g for _, g in pairs],
                                       allow_unused=True))
    return [next(got) if n else None for n in needs]


class _FusedScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _forward(*args)

    @staticmethod
    def backward(ctx, *out_grads):
        return tuple(recompute_grads(scan_reference, ctx.saved_tensors,
                                     ctx.needs_input_grad, out_grads))


def fused_scan(xg1, xc1, xw, tn, tl, ot, xg2, xc2, mask, ushort,
               whg1, whc1, wh4, whg2, whc2):
    """The fused recurrence -> (h1_final, outs, h2_final), differentiable
    in every input but `mask`."""
    return _FusedScan.apply(xg1, xc1, xw, tn, tl, ot, xg2, xc2,
                            mask.detach(), ushort, whg1, whc1, wh4, whg2,
                            whc2)


fused_scan.launches = 0
