"""MLP head, the split first scorer layer, flax-semantics BN and activations.

Counterpart of clsr_tpu/ops/mlp.py (reference `_fcn_net`,
base_model.py:627-708): Dense layers, each optionally followed by
BatchNorm (momentum 0.95, epsilon 1e-4, base_model.py:673-679), dropout
and an activation, then a final Dense(out_dim) named "w_nn_output".

BN keeps the flax names (params `scale`/`bias`, buffers `mean`/`var`)
and flax's semantics.  It is not `torch.nn.BatchNorm`, which differs in
its momentum convention and keeps the unbiased variance.  In train mode
it normalises with the batch statistics over every axis but the last,
mean and var = max(0, E[x^2] - E[x]^2), and then updates its running
statistics in place (no gradient): r = 0.95 r + 0.05 batch.  In eval
mode it applies the running statistics.  `FcnNet.update_bn_stats` is
the running update alone (`_BNStatsUpdate`, :146-170), for the fused
train scorer, which computed the normalisation itself.  Dense layers are
`nn.Linear`, so their `weight` is the transpose of the flax `kernel`
(weights.from_flax).  Dropout draws its mask from an explicit
`torch.Generator`; the masks differ from flax's by design.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from clsr_tpu_torch.ops.initializers import (Initializer, new_param,
                                             ones_init, zeros_init)

BN_EPSILON = 1e-4
BN_MOMENTUM = 0.95


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator
            ) -> torch.Tensor:
    """flax nn.Dropout in train mode: keep with probability 1 - rate and
    scale the kept values by 1 / (1 - rate); the mask from `generator`."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dense(in_dim: int, out_dim: int, init: Initializer,
          generator: torch.Generator, device: torch.device) -> nn.Linear:
    """nn.Linear whose [in, out] kernel is drawn like flax's Dense."""
    layer = nn.utils.skip_init(nn.Linear, in_dim, out_dim, device=device)
    kernel = torch.empty(in_dim, out_dim, device=device)
    with torch.no_grad():
        layer.weight.copy_(init(kernel, generator).t())
        layer.bias.zero_()
    return layer


class SplitFirstDense(nn.Module):
    """First scorer layer over the implicit concat [k, q, k-q, k*q].

    With kernel blocks [Wk; Wq; Wd; Wm] (the [4D, H] kernel of the Dense
    it replaces, clsr.py:355-368):

        out = k@(Wk+Wd) + q@(Wq-Wd) + (k*q)@Wm + bias

    so no [B, G, L, 4D] tensor is built.  The kernel keeps the flax
    layout because it is sliced by rows.
    """

    def __init__(self, in_dim: int, features: int, init: Initializer,
                 generator: torch.Generator, device: torch.device):
        super().__init__()
        self.kernel = new_param((4 * in_dim, features), init, generator,
                                device)
        self.bias = new_param((features,), zeros_init, generator, device)

    def forward(self, keys_proj: torch.Tensor, query: torch.Tensor
                ) -> torch.Tensor:
        """keys_proj [B, L, D], query [B, G, D] -> [B, L, G, features]."""
        B, L, D = keys_proj.shape
        G = query.shape[1]
        H = self.kernel.shape[1]
        wk, wq, wd, wm = self.kernel.split(D, dim=0)
        term_k = keys_proj @ (wk + wd)                        # [B, L, H]
        term_q = query @ (wq - wd)                            # [B, G, H]
        qw = torch.einsum("bgd,dh->bdgh", query, wm)          # [B, D, G, H]
        term_m = torch.bmm(keys_proj, qw.reshape(B, D, G * H))
        return (term_m.reshape(B, L, G, H) + term_k[:, :, None, :]
                + term_q[:, None, :, :] + self.bias)


class BatchNorm(nn.Module):
    """Flax-named BatchNorm: batch statistics in train mode, running
    statistics in eval mode."""

    def __init__(self, features: int, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.scale = new_param((features,), ones_init, generator, device)
        self.bias = new_param((features,), zeros_init, generator, device)
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(axes)
            var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
            self.update_running(mean, var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPSILON) * self.scale
        return (x - mean) * mul + self.bias

    @torch.no_grad()
    def update_running(self, batch_mean: torch.Tensor,
                       batch_var: torch.Tensor) -> None:
        """flax's running-average update, in place."""
        m = BN_MOMENTUM
        self.mean.copy_(m * self.mean + (1 - m) * batch_mean)
        self.var.copy_(m * self.var + (1 - m) * batch_var)

    def fold(self, bias: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(a, c) with bn(x + bias) == a*x + c."""
        a = self.scale * torch.rsqrt(self.var + BN_EPSILON)
        return a, (bias - self.mean) * a + self.bias


class FcnNet(nn.Module):
    """Dense stack with optional BN, per base_model.py:627-708.

    With `split_first`, layer 0 is a `SplitFirstDense` over
    (keys_proj, query), both `in_dim` wide.  `dropout_rates` (the
    config's `dropout` under `user_dropout`) apply in train mode, after
    BN and before the activation, with masks from the generator passed
    to `forward`.
    """

    def __init__(self, in_dim: int, layer_sizes: Sequence[int],
                 activations: Sequence[str], init: Initializer,
                 generator: torch.Generator, device: torch.device,
                 enable_bn: bool = False, out_dim: int = 1,
                 split_first: bool = False,
                 dropout_rates: Optional[Sequence[float]] = None):
        super().__init__()
        self.layer_sizes = tuple(layer_sizes)
        self.activations = tuple(activations)
        self.enable_bn = enable_bn
        self.split_first = split_first
        self.dropout_rates = (None if dropout_rates is None
                              else tuple(dropout_rates))
        width = in_dim
        for idx, size in enumerate(self.layer_sizes):
            if idx == 0 and split_first:
                layer = SplitFirstDense(in_dim, size, init, generator,
                                        device)
            else:
                layer = dense(width, size, init, generator, device)
            self.add_module(f"w_nn_layer{idx}", layer)
            if enable_bn:
                self.add_module(f"bn{idx}",
                                BatchNorm(size, generator, device))
            width = size
        self.w_nn_output = dense(width, out_dim, init, generator, device)

    def activation(self, idx: int) -> str:
        return self.activations[min(idx, len(self.activations) - 1)]

    def forward(self, x: Optional[torch.Tensor],
                split_parts: Optional[Tuple[torch.Tensor, torch.Tensor]]
                = None, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        for idx in range(len(self.layer_sizes)):
            layer = getattr(self, f"w_nn_layer{idx}")
            x = layer(*split_parts) if (idx == 0 and self.split_first) \
                else layer(x)
            if self.enable_bn:
                x = getattr(self, f"bn{idx}")(x)
            if self.dropout_rates is not None and self.training:
                rate = self.dropout_rates[min(idx,
                                              len(self.dropout_rates) - 1)]
                x = dropout(x, rate, generator)
            x = activate(x, self.activation(idx))
        return self.w_nn_output(x)

    def update_bn_stats(self, stats) -> None:
        """Running-average updates of bn0, bn1, ... from batch (mean,
        var) pairs computed elsewhere (the fused train scorer)."""
        for idx, (mean, var) in enumerate(stats):
            getattr(self, f"bn{idx}").update_running(mean, var)


def activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    """Activation dispatch, mirroring base_model.py:314-330."""
    if activation == "sigmoid":
        return torch.sigmoid(x)
    if activation == "softmax":
        return torch.softmax(x, dim=-1)
    if activation == "relu":
        return F.relu(x)
    if activation == "tanh":
        return torch.tanh(x)
    if activation == "elu":
        return F.elu(x)
    if activation == "identity":
        return x
    if activation == "dice":
        raise NotImplementedError(
            "dice waits for the model zoo slice (ROADMAP queue 1)")
    raise ValueError(f"this activations not defined {activation}")
