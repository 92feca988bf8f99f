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
mode it applies the running statistics.  `MaskedBatchNorm` (:92-145)
weights the train-mode statistics by a per-position weight (the history
mask): mean = sum(w x) / max(sum w, 1) and the two-pass variance
sum(w (x - mean)^2) / max(sum w, 1), so padded positions do not count;
`FcnNet` builds it for a scorer with `masked_bn` and passes the
`stats_weight` its forward gets.  `FcnNet.update_bn_stats` is
the running update alone (`_BNStatsUpdate`, :146-170), for the fused
train scorer, which computed the normalisation itself.  Dense layers are
`nn.Linear`, so their `weight` is the transpose of the flax `kernel`
(weights.from_flax).  Dropout draws its mask from an explicit
`torch.Generator`; the masks differ from flax's by design.

`Dice` (JAX :25-36, reference deeprec_utils.py:838-860) is the
data-adaptive activation: it normalises with the statistics of the
tensor it is given, over every axis but the last, in train and in eval
mode alike (the reference has only the train-mode branch and no running
average), std = sqrt(mean((x - mean)^2 + 1e-9)), normed =
(x - mean) / (std + 1e-9), out = alpha (1 - p) x + p x with p =
sigmoid(normed).  So a Dice layer's output for one row depends on the
other rows of the batch, padding included, in JAX as here.  `FcnNet`
holds one as `dice_{idx}` for each layer whose activation is "dice", as
JAX's `activate` creates it under the calling FcnNet (:241-260).

`FcnNet` and `SplitFirstDense` take a compute `dtype` (JAX :173-240):
with bfloat16 the dense layers cast their input, kernel and bias to it
and compute there (the parameters stay f32), BN takes its statistics
and normalises in f32 and hands back the layer's dtype, as flax's does,
and FcnNet's output is cast back to f32.

On a mesh (parallel/mesh.py `active_mesh`) every batch statistic is the
global batch's, as GSPMD makes JAX's: train-mode BN, MaskedBatchNorm
and Dice sum their per-channel sums over the batch shards with a
differentiable all_reduce (its backward all_reduces the cotangents, so
each shard's gradient sees every shard's rows), and the running
statistics come out bit-identical on every rank.  Dropout draws its mask
at the global batch's shape and keeps this rank's rows, so a W-rank
step draws the masks a one-rank step draws.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from clsr_tpu_torch.ops.initializers import (Initializer, new_param,
                                             ones_init, zeros_init)
from clsr_tpu_torch.parallel.mesh import (batch_sum, batch_total,
                                          global_rows, local_rows_of)

BN_EPSILON = 1e-4
BN_MOMENTUM = 0.95


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator
            ) -> torch.Tensor:
    """flax nn.Dropout in train mode: keep with probability 1 - rate and
    scale the kept values by 1 / (1 - rate); the mask from `generator`,
    drawn at the global batch's shape on a mesh (x batch-leading)."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    shape = (global_rows(x.shape[0]),) + tuple(x.shape[1:])
    keep = local_rows_of(torch.rand(
        shape, generator=generator, device=x.device,
        dtype=torch.promote_types(x.dtype, torch.float32))) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _global_mean(x: torch.Tensor, axes, keepdim: bool = False
                 ) -> torch.Tensor:
    """x.mean(axes) over the global batch: off a mesh x.mean itself; on a
    mesh the shards' sums all_reduced (differentiably) over equal
    shards."""
    n = global_rows(1)
    if n == 1:
        return x.mean(axes, keepdim=keepdim)
    for a in axes:
        n *= x.shape[a]
    return batch_sum(x.sum(axes, keepdim=keepdim)) / n


def batch_moments(x: torch.Tensor, axes) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """(E[x], E[x^2]) over `axes` of the global batch: on a mesh both
    sums in one differentiable all_reduce over equal shards."""
    if global_rows(1) == 1:
        return x.mean(axes), (x * x).mean(axes)
    n = global_rows(x.numel() // x.shape[-1])
    mean, sq = batch_sum(torch.stack([x.sum(axes), (x * x).sum(axes)])) / n
    return mean, sq


def dense(in_dim: int, out_dim: int, init: Initializer,
          generator: torch.Generator, device: torch.device,
          bias: bool = True) -> nn.Linear:
    """nn.Linear whose [in, out] kernel is drawn like flax's Dense (with a
    zero bias, or none: flax's use_bias=False)."""
    layer = nn.utils.skip_init(nn.Linear, in_dim, out_dim, bias=bias,
                               device=device)
    kernel = torch.empty(in_dim, out_dim, device=device)
    with torch.no_grad():
        layer.weight.copy_(init(kernel, generator).t())
        if bias:
            layer.bias.zero_()
    return layer


class Dice(nn.Module):
    """Dice with its parameter `alpha` [features] (zeros)."""

    EPS = 1e-9

    def __init__(self, features: int, device: torch.device):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(x.dim() - 1))
        mean = _global_mean(x, axes, keepdim=True)
        std = torch.sqrt(_global_mean(torch.square(x - mean) + self.EPS,
                                      axes, keepdim=True))
        p = torch.sigmoid((x - mean) / (std + self.EPS))
        return self.alpha * (1.0 - p) * x + p * x


class SplitFirstDense(nn.Module):
    """First scorer layer over the implicit concat [k, q, k-q, k*q].

    With kernel blocks [Wk; Wq; Wd; Wm] (the [4D, H] kernel of the Dense
    it replaces, clsr.py:355-368):

        out = k@(Wk+Wd) + q@(Wq-Wd) + (k*q)@Wm + bias

    so no [B, G, L, 4D] tensor is built.  The kernel keeps the flax
    layout because it is sliced by rows.
    """

    def __init__(self, in_dim: int, features: int, init: Initializer,
                 generator: torch.Generator, device: torch.device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = new_param((4 * in_dim, features), init, generator,
                                device)
        self.bias = new_param((features,), zeros_init, generator, device)

    def forward(self, keys_proj: torch.Tensor, query: torch.Tensor
                ) -> torch.Tensor:
        """keys_proj [B, L, D], query [B, G, D] -> [B, L, G, features],
        in the compute dtype (else keys_proj's)."""
        B, L, D = keys_proj.shape
        G = query.shape[1]
        H = self.kernel.shape[1]
        ct = self.dtype or keys_proj.dtype
        keys_proj, query = keys_proj.to(ct), query.to(ct)
        wk, wq, wd, wm = self.kernel.to(ct).split(D, dim=0)
        term_k = keys_proj @ (wk + wd)                        # [B, L, H]
        term_q = query @ (wq - wd)                            # [B, G, H]
        qw = torch.einsum("bgd,dh->bdgh", query, wm)          # [B, D, G, H]
        term_m = torch.bmm(keys_proj, qw.reshape(B, D, G * H))
        return (term_m.reshape(B, L, G, H) + term_k[:, :, None, :]
                + term_q[:, None, :, :] + self.bias.to(ct))


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
        """In f32 (flax's statistics and normalisation of a bf16 input),
        handed back in x's dtype."""
        xf = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean, sq = batch_moments(xf, axes)
            var = torch.clamp(sq - mean * mean, min=0.0)
            self.update_running(mean, var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPSILON) * self.scale
        return ((xf - mean) * mul + self.bias).to(x.dtype)

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


class MaskedBatchNorm(BatchNorm):
    """BatchNorm whose train-mode batch statistics cover the weighted
    (real) positions only (clsr_tpu/ops/mlp.py:92-145), in f32: the
    statistics no longer depend on how much of a batch is padding, which
    differs from one length bucket to the next.  The same parameter and
    buffer names as `BatchNorm`, so checkpoints and `weights.from_flax`
    serve both; eval mode applies the running statistics."""

    def forward(self, x: torch.Tensor, weight: torch.Tensor
                ) -> torch.Tensor:
        """x [..., C]; weight broadcastable to x.shape[:-1] + (1,)."""
        xf = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            wb = weight.float().expand(x.shape[:-1] + (1,))
            den = batch_total(wb.sum(axes)).clamp_min(1.0)
            mean = batch_sum((xf * wb).sum(axes)) / den
            var = batch_sum((wb * torch.square(xf - mean)).sum(axes)) / den
            self.update_running(mean, var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * torch.rsqrt(var + BN_EPSILON) * self.scale \
            + self.bias
        return y.to(x.dtype)


class FcnNet(nn.Module):
    """Dense stack with optional BN, per base_model.py:627-708.

    With `split_first`, layer 0 is a `SplitFirstDense` over
    (keys_proj, query), both `in_dim` wide.  `dropout_rates` (the
    config's `dropout` under `user_dropout`) apply in train mode, after
    BN and before the activation, with masks from the generator passed
    to `forward`.  With `masked_bn` its BN layers are `MaskedBatchNorm`,
    which read the `stats_weight` passed to `forward`.  A "dice"
    activation is the layer's `dice_{idx}` module.
    """

    def __init__(self, in_dim: int, layer_sizes: Sequence[int],
                 activations: Sequence[str], init: Initializer,
                 generator: torch.Generator, device: torch.device,
                 enable_bn: bool = False, out_dim: int = 1,
                 split_first: bool = False,
                 dropout_rates: Optional[Sequence[float]] = None,
                 masked_bn: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
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
                                        device, dtype)
            else:
                layer = dense(width, size, init, generator, device)
            self.add_module(f"w_nn_layer{idx}", layer)
            if enable_bn:
                bn = MaskedBatchNorm if masked_bn else BatchNorm
                self.add_module(f"bn{idx}", bn(size, generator, device))
            if self.activation(idx) == "dice":
                self.add_module(f"dice_{idx}", Dice(size, device))
            width = size
        self.w_nn_output = dense(width, out_dim, init, generator, device)

    def activation(self, idx: int) -> str:
        return self.activations[min(idx, len(self.activations) - 1)]

    def forward(self, x: Optional[torch.Tensor],
                split_parts: Optional[Tuple[torch.Tensor, torch.Tensor]]
                = None, generator: Optional[torch.Generator] = None,
                stats_weight: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if x is not None and self.dtype is not None:
            x = x.to(self.dtype)
        for idx in range(len(self.layer_sizes)):
            layer = getattr(self, f"w_nn_layer{idx}")
            x = layer(*split_parts) if (idx == 0 and self.split_first) \
                else self._dense(layer, x)
            if self.enable_bn:
                bn = getattr(self, f"bn{idx}")
                x = bn(x) if stats_weight is None else bn(x, stats_weight)
            if self.dropout_rates is not None and self.training:
                rate = self.dropout_rates[min(idx,
                                              len(self.dropout_rates) - 1)]
                x = dropout(x, rate, generator)
            x = (getattr(self, f"dice_{idx}")(x)
                 if self.activation(idx) == "dice"
                 else activate(x, self.activation(idx)))
        x = self._dense(self.w_nn_output, x)
        return x if self.dtype is None else x.float()

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """layer(x), or in the compute dtype: x @ kernel, then + bias, as
        flax's Dense rounds them."""
        if self.dtype is None:
            return layer(x)
        dt = self.dtype
        return x @ layer.weight.to(dt).t() + layer.bias.to(dt)

    def update_bn_stats(self, stats) -> None:
        """Running-average updates of bn0, bn1, ... from batch (mean,
        var) pairs computed elsewhere (the fused train scorer)."""
        for idx, (mean, var) in enumerate(stats):
            getattr(self, f"bn{idx}").update_running(mean, var)


def activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    """Activation dispatch, mirroring base_model.py:314-330; "dice" holds
    a parameter and is FcnNet's `dice_{idx}` module."""
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
    raise ValueError(f"this activations not defined {activation}")
