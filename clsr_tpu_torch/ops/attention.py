"""Target attention over a masked history.

Counterpart of clsr_tpu/ops/attention.py:32-189 (`TargetAttention`,
which reimplements the reference `_attention_fcn`, clsr.py:343-381):
keys are projected to the query's width, the interaction features
[k, q, k-q, k*q] feed an MLP scorer (first layer split, ops/mlp.py),
padded positions get -(2^32)+1 before the softmax over L, and the
weighted sum of the keys is returned.  The query may be [B, G, Dq]: one
history scored against G candidates, the key projection computed once.

Two fused scorers take over under the gates of attention.py:71-159, for
a two-layer relu scorer with no weights returned:

  * eval mode, G >= 8: K1 (ops/fused_attention.py), gated by
    `use_kernel` (cfg.use_pallas_eval_attention);
  * train mode, any G: K3a + K3b + K1 (ops/fused_train_attention.py),
    gated by `use_train_kernel` (cfg.use_pallas_train_attention) or the
    `train_kernel` argument of `forward`; the BN running statistics
    are then updated from the batch statistics the kernels return.
    Not under `bn_stats_mask` with BN (attention.py:117): the scorer's
    BN is then `MaskedBatchNorm` (ops/mlp.py), which the plain scorer
    runs with the history mask as its statistics' weight.

'on' switches a kernel on, 'auto' on for CUDA tensors, 'off' off.

With a compute `dtype` (bfloat16) the key projection and the plain
scorer run in it and the logits are upcast before the masked softmax
(attention.py:53-56, :174-187); the kernels compute in f32 on inputs
cast to f32 first, as JAX's do (:91-95, :137-141).
`SoftAttention` (clsr_tpu/ops/attention.py:192-207, reference
`_attention`, base_model.py:595-625; A2SVD and SLI-Rec's long term): a
learned global query over the projected sequence, a softmax over ALL
positions (no mask: the reference's quirk, kept), the weighted sequence
returned.  Its `attention_mat` is [D, D], so the query's
`attention_size` must equal D, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from clsr_tpu_torch.ops import fused_attention as fa
from clsr_tpu_torch.ops.fused_train_attention import fused_train_attention
from clsr_tpu_torch.ops.initializers import Initializer, new_param
from clsr_tpu_torch.ops.mlp import FcnNet

MASK_PADDING_VALUE = fa.MASK_PADDING_VALUE


class TargetAttention(nn.Module):
    """Query-conditioned attention over a masked history."""

    def __init__(self, query_dim: int, key_dim: int,
                 layer_sizes: Sequence[int], activations: Sequence[str],
                 init: Initializer, generator: torch.Generator,
                 device: torch.device, enable_bn: bool = False,
                 use_kernel: str = "auto", use_train_kernel: str = "off",
                 bn_stats_mask: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.enable_bn = enable_bn
        self.use_kernel = use_kernel
        self.use_train_kernel = use_train_kernel
        self.masked_stats = bn_stats_mask and enable_bn
        self.attention_mat = new_param((key_dim, query_dim), init,
                                       generator, device)
        self.att_fcn = FcnNet(query_dim, layer_sizes, activations, init,
                              generator, device, enable_bn=enable_bn,
                              out_dim=1, split_first=True,
                              masked_bn=self.masked_stats, dtype=dtype)

    def _scorer_fusable(self, return_weights: bool) -> bool:
        fcn = self.att_fcn
        return (not return_weights and len(fcn.layer_sizes) == 2
                and all(fcn.activation(i) == "relu" for i in range(2)))

    def kernel_applies(self, keys: torch.Tensor, G: int,
                       return_weights: bool) -> bool:
        """The gate of attention.py:71-75, with 'auto' = CUDA tensors."""
        return (_switched_on(self.use_kernel, keys) and not self.training
                and G >= 8 and self._scorer_fusable(return_weights))

    def train_kernel_applies(self, keys: torch.Tensor, return_weights: bool,
                             train_kernel: Optional[bool] = None) -> bool:
        """The gate of attention.py:115-121: train mode, any G, not under
        masked BN statistics; `train_kernel` overrides use_train_kernel
        when given."""
        on = (_switched_on(self.use_train_kernel, keys)
              if train_kernel is None else train_kernel)
        return (on and self.training and not self.masked_stats
                and self._scorer_fusable(return_weights))

    def forward(self, query: torch.Tensor, keys: torch.Tensor,
                mask: torch.Tensor, return_weights: bool = False,
                train_kernel: Optional[bool] = None):
        """query [B, Dq] or [B, G, Dq]; keys [B, L, Dk]; mask [B, L].

        Returns att_fea [B, Dk] or [B, G, Dk] (+ weights [B(, G), L])."""
        squeeze_group = query.dim() == 2
        if squeeze_group:
            query = query[:, None, :]
        G, Dq = query.shape[1:]
        ct = self.dtype or keys.dtype
        att_inputs = keys.to(ct) @ self.attention_mat.to(ct)    # [B, L, Dq]

        kernel = self.kernel_applies(keys, G, return_weights)
        if kernel or self.train_kernel_applies(keys, return_weights,
                                               train_kernel):
            f32 = lambda t: t.float().contiguous()
            args = tuple(map(f32, (keys, att_inputs, query, mask)))
            if kernel:
                folded = fa.fold_scorer_params(self.att_fcn, Dq,
                                               self.enable_bn)
                att_fea = fa.fused_eval_attention(*args, *folded)
            else:
                att_fea = self._fused_train(*args)
            return att_fea[:, 0] if squeeze_group else att_fea

        logits = self.att_fcn(
            None, split_parts=(att_inputs, query),
            stats_weight=(mask[:, :, None, None] if self.masked_stats
                          else None))[..., 0].float()
        masked = torch.where(mask[:, :, None] > 0, logits,
                             torch.full_like(logits, MASK_PADDING_VALUE))
        w = torch.softmax(masked, dim=1)                        # [B, L, G]
        att_fea = torch.einsum("blg,bld->bgd", w, keys)         # [B, G, Dk]
        if squeeze_group:
            att_fea = att_fea[:, 0]
        if not return_weights:
            return att_fea
        weights = w.transpose(1, 2)                             # [B, G, L]
        return att_fea, (weights[:, 0] if squeeze_group else weights)

    def _fused_train(self, keys, att_inputs, query, mask):
        """The fused train scorer (attention.py:122-159), then the BN
        running-average updates from its batch statistics."""
        fcn = self.att_fcn
        b0, b1 = fcn.w_nn_layer0.bias, fcn.w_nn_layer1.bias
        if self.enable_bn:
            s0, sh0 = fcn.bn0.scale, fcn.bn0.bias
            s1, sh1 = fcn.bn1.scale, fcn.bn1.bias
        else:   # unused without BN
            s0 = sh0 = torch.ones_like(b0)
            s1 = sh1 = torch.ones_like(b1)
        att_fea, m0, v0, m1, v1 = fused_train_attention(
            keys, att_inputs, query, mask, fcn.w_nn_layer0.kernel, b0, s0,
            sh0, fcn.w_nn_layer1.weight.t(), b1, s1, sh1,
            fcn.w_nn_output.weight[0], self.enable_bn)
        if self.enable_bn:
            fcn.update_bn_stats([(m0, v0), (m1, v1)])
        return att_fea


def _switched_on(flag: str, like: torch.Tensor) -> bool:
    """A kernel flag: 'on', or 'auto' with CUDA tensors."""
    return flag == "on" or (flag == "auto" and like.is_cuda)


class SoftAttention(nn.Module):
    """Global-query soft attention: inputs [B, L, D] -> the weighted
    sequence [B, L, D]."""

    def __init__(self, input_dim: int, attention_size: int,
                 init: Initializer, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.attention_mat = new_param((input_dim, input_dim), init,
                                       generator, device)
        self.query = new_param((attention_size,), init, generator, device)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        logits = (inputs @ self.attention_mat) @ self.query     # [B, L]
        weights = torch.softmax(logits, dim=-1)    # no mask: reference quirk
        return inputs * weights[..., None]
