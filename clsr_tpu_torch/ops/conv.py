"""1-D convolution over the time axis, as flax's `nn.Conv` computes it.

Counterpart of the flax `nn.Conv` layers of clsr_tpu/models/caser.py:25,
:31 and clsr_tpu/models/nextitnet.py:62-70: channels-last input
[B, L, in], a kernel [k, in, out] and a bias [out] under flax's names
and layout, so `weights.from_flax` / `to_flax` carry them with no rule of
their own.  Padding "VALID" (none), "SAME" (k = 1 only, which pads
nothing) or causal: (k - 1) * dilation zeros in front.

The conv is one `torch.matmul`: the k dilated shifts of the padded input
side by side ([B, L_out, k * in], position-major as the kernel's rows)
times the kernel as [k * in, out], then + bias.  A conv whose one window
spans the whole input (Caser's vertical conv) is a reshape and one
product.  The product's gradients are GEMMs and the shifts' is a sum of
k slices in a fixed order, so two backward passes give the same bits (a
cuDNN weight gradient may add with atomics), and TF32 follows
`torch.backends.cuda.matmul.allow_tf32` (off by default), not cuDNN's
flag (on by default).  The convs run in f32: the JAX models give them no
compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from clsr_tpu_torch.ops.initializers import (Initializer, lecun_normal,
                                             new_param, zeros_init)


class Conv1d(nn.Module):
    """flax `nn.Conv(out, kernel_size=(k,), kernel_dilation=(d,),
    padding=...)` over [B, L, in]."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int,
                 generator: torch.Generator, device: torch.device,
                 dilation: int = 1, padding: str = "VALID",
                 kernel_init: Optional[Initializer] = None):
        super().__init__()
        if padding not in ("VALID", "SAME", "CAUSAL"):
            raise ValueError(f"padding must be VALID, SAME or CAUSAL, got "
                             f"{padding}")
        if padding == "SAME" and kernel_size != 1:
            raise ValueError("SAME padding is kept for kernel size 1 only")
        self.dilation = dilation
        self.pad_front = ((kernel_size - 1) * dilation
                          if padding == "CAUSAL" else 0)
        self.kernel = new_param((kernel_size, in_dim, out_dim),
                                kernel_init or lecun_normal, generator,
                                device)
        self.bias = new_param((out_dim,), zeros_init, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, L, in] -> [B, L_out, out], L_out = L + pad - (k-1) d."""
        k, cin, cout = self.kernel.shape
        d = self.dilation
        if self.pad_front:
            x = torch.cat([x.new_zeros(x.shape[0], self.pad_front, cin), x],
                          dim=1)
        L = x.shape[1]
        span = (k - 1) * d + 1
        if span > L:
            raise ValueError(f"a conv window of {span} positions over a "
                             f"history of {L}")
        L_out = L - span + 1
        if k == 1:
            cols = x
        elif L_out == 1 and d == 1:
            cols = x.reshape(x.shape[0], 1, k * cin)
        else:
            cols = torch.cat([x[:, j * d:j * d + L_out] for j in range(k)],
                             dim=-1)
        return cols @ self.kernel.reshape(k * cin, cout) + self.bias
