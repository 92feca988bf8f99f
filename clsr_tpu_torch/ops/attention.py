"""Target attention over a masked history, eval mode.

Counterpart of clsr_tpu/ops/attention.py:32-189 (`TargetAttention`,
which reimplements the reference `_attention_fcn`, clsr.py:343-381):
keys are projected to the query's width, the interaction features
[k, q, k-q, k*q] feed an MLP scorer (first layer split, ops/mlp.py),
padded positions get -(2^32)+1 before the softmax over L, and the
weighted sum of the keys is returned.  The query may be [B, G, Dq]: one
history scored against G candidates, the key projection computed once.

The fused scorer kernel K1 (ops/fused_attention.py) takes over under
the same gate as in JAX (attention.py:71-104): eval mode, no weights
returned, G >= 8, a two-layer relu scorer, and the kernel switched on:
`use_kernel` 'on', or 'auto' with the tensors on CUDA.  `SoftAttention`
(A2SVD) waits for the model zoo slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from clsr_tpu_torch.ops import fused_attention as fa
from clsr_tpu_torch.ops.initializers import Initializer, new_param
from clsr_tpu_torch.ops.mlp import FcnNet

MASK_PADDING_VALUE = fa.MASK_PADDING_VALUE


class TargetAttention(nn.Module):
    """Query-conditioned attention over a masked history."""

    def __init__(self, query_dim: int, key_dim: int,
                 layer_sizes: Sequence[int], activations: Sequence[str],
                 init: Initializer, generator: torch.Generator,
                 device: torch.device, enable_bn: bool = False,
                 use_kernel: str = "auto"):
        super().__init__()
        self.enable_bn = enable_bn
        self.use_kernel = use_kernel
        self.attention_mat = new_param((key_dim, query_dim), init,
                                       generator, device)
        self.att_fcn = FcnNet(query_dim, layer_sizes, activations, init,
                              generator, device, enable_bn=enable_bn,
                              out_dim=1, split_first=True)

    def kernel_applies(self, keys: torch.Tensor, G: int,
                       return_weights: bool) -> bool:
        """The gate of attention.py:71-75, with 'auto' = CUDA tensors."""
        on = (self.use_kernel == "on"
              or (self.use_kernel == "auto" and keys.is_cuda))
        fcn = self.att_fcn
        return (on and not self.training and not return_weights and G >= 8
                and len(fcn.layer_sizes) == 2
                and all(fcn.activation(i) == "relu" for i in range(2)))

    def forward(self, query: torch.Tensor, keys: torch.Tensor,
                mask: torch.Tensor, return_weights: bool = False):
        """query [B, Dq] or [B, G, Dq]; keys [B, L, Dk]; mask [B, L].

        Returns att_fea [B, Dk] or [B, G, Dk] (+ weights [B(, G), L])."""
        squeeze_group = query.dim() == 2
        if squeeze_group:
            query = query[:, None, :]
        G, Dq = query.shape[1:]
        att_inputs = keys @ self.attention_mat                  # [B, L, Dq]

        if self.kernel_applies(keys, G, return_weights):
            folded = fa.fold_scorer_params(self.att_fcn, Dq, self.enable_bn)
            att_fea = fa.fused_eval_attention(
                keys.contiguous(), att_inputs.contiguous(),
                query.contiguous(), mask.contiguous(), *folded)
            return att_fea[:, 0] if squeeze_group else att_fea

        logits = self.att_fcn(None, split_parts=(att_inputs, query))[..., 0]
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
