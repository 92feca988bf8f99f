"""Long-context target attention: the scorer in key blocks, online softmax.

Counterpart of clsr_tpu/ops/long_context.py (`_scorer_apply` :37-68,
`_block_update` :71-85, `LongTargetAttention` :88-168).  CLSR's
attention has one query per (row, target) and no L x L matrix, so what
grows with L is the scorer's [B, L, G, H] hidden activations.
`LongTargetAttention` computes `TargetAttention(enable_bn=False)`'s
function (a relu scorer, no BN) over blocks of C = min(block_size, L)
keys: each block's logits update a running (max m, normalizer s,
weighted sum acc) in f32, so the live activations are one block's,
whatever L is.  In the backward each block is recomputed from the
carry it started from (`torch.utils.checkpoint`, non-reentrant, no RNG
state: the block draws nothing), as JAX's `jax.checkpoint(body)` does;
only the block boundaries and the inputs are kept.  Every op of a block
is a plain PyTorch op with a deterministic backward, so a train step
through it captures into the CUDA graphs of training/steps.py and
replays bit for bit.

What is copied exactly, since it decides the answer:

  * the padding: L is padded up to a multiple of C with zero keys and a
    zero mask (:142-146);
  * the carry's start (m = MASK_PADDING_VALUE, s = 0, acc = 0, :154-156)
    and the masked logits (MASK_PADDING_VALUE).  A row whose mask is all
    zero (serving's padded rows) then weighs every position of the
    padded length alike, the padded tail's zero keys included, so its
    output differs from `TargetAttention`'s, which weighs the L real
    positions: the port gives JAX's blocked answer;
  * the 2-D query ([B, Dq] -> G = 1, squeezed back);
  * the compute dtype: under bfloat16 the key projection and the scorer
    run in it, the logits are upcast, and the carry stays f32.

The parameters are owned directly under flax's names and layouts
(`attention_mat` [Dk, Dq], `w_nn_layer{i}_kernel` [in, out] and
`_bias`, `w_nn_output_kernel` / `_bias`), so weights.from_flax carries
the JAX module's subtree across as it is.

JAX runs this as a `lax.scan` of XLA ops, with no Pallas kernel, so the
port has no kernel here either.  On the (data, model) mesh the layer is
pure per row and runs on each rank's rows.

The sequence-parallel merge (`axis_name`, JAX :157-166): with a
torch.distributed process group as `axis_name`, the keys and mask are
this rank's shard of the L axis (the group's ranks in order hold
consecutive shards), the blocks run over the shard, and the shards'
(m, s, acc) are all_gathered in rank order and merged with lse algebra:
m_g = max_r m_r, s = sum_r s_r exp(m_r - m_g), acc likewise.  A shard
whose keys are all padding carries m = MASK_PADDING_VALUE, a finite
value, so its weight exp(m_r - m_g) is 0 or 1, never NaN.  The gather is
differentiable: its backward hands each rank its slice of the
cotangent summed over the group (parallel/collectives.py
`all_gather_grad`), so each rank's loss is its share of the whole and
the key gradients land on the rank that holds the keys.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from clsr_tpu_torch.ops.fused_attention import MASK_PADDING_VALUE
from clsr_tpu_torch.ops.initializers import (Initializer, new_param,
                                             zeros_init)
from clsr_tpu_torch.parallel.collectives import all_gather_grad


def scorer_apply(keys_blk: torch.Tensor, query: torch.Tensor,
                 attention_mat: torch.Tensor,
                 layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The split-first-layer relu scorer on one key block (JAX
    `_scorer_apply`): keys_blk [B, C, Dk], query [B, G, Dq] -> logits
    [B, C, G] in f32.  Layer 0 is k@(Wk+Wd) + q@(Wq-Wd) + (k*q)@Wm +
    bias, the last term as one batched product."""
    ct = dtype or keys_blk.dtype
    W = attention_mat.to(ct)
    D = W.shape[1]
    k = keys_blk.to(ct) @ W                                  # [B, C, Dq]
    q = query.to(ct)
    x = None
    for i, (kern, bias) in enumerate(layers):
        kern, bias = kern.to(ct), bias.to(ct)
        if i == 0:
            wk, wq, wd, wm = (kern[:D], kern[D:2 * D], kern[2 * D:3 * D],
                              kern[3 * D:])
            term_k = k @ (wk + wd)                           # [B, C, H]
            term_q = q @ (wq - wd)                           # [B, G, H]
            B, G = q.shape[:2]
            C = k.shape[1]
            H = kern.shape[1]
            qw = torch.einsum("bgd,dh->bdgh", q, wm).reshape(B, D, G * H)
            term_m = torch.bmm(k, qw).reshape(B, C, G, H)
            x = (term_m + term_k[:, :, None, :] + term_q[:, None, :, :]
                 + bias)
        else:
            x = x @ kern + bias
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x[..., 0].float()


def block_update(m: torch.Tensor, s: torch.Tensor, acc: torch.Tensor,
                 logits: torch.Tensor, keys_blk: torch.Tensor,
                 mask_blk: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One online-softmax step (JAX `_block_update`): the carry m, s
    [B, G], acc [B, G, Dk] and a block's logits [B, C, G] -> the new
    carry.  `amax` and `maximum` share a tie's gradient as JAX's max
    and maximum do."""
    logits = torch.where(mask_blk[:, :, None] > 0, logits,
                         torch.full_like(logits, MASK_PADDING_VALUE))
    m_new = torch.maximum(m, torch.amax(logits, dim=1))      # [B, G]
    scale = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[:, None, :])                # [B, C, G]
    s_new = s * scale + p.sum(dim=1)
    acc_new = (acc * scale[..., None]
               + torch.einsum("bcg,bcd->bgd", p, keys_blk))
    return m_new, s_new, acc_new


class LongTargetAttention(nn.Module):
    """Blockwise TargetAttention (BN-free relu scorer) for long
    histories; forward(query, keys, mask) as TargetAttention's."""

    def __init__(self, query_dim: int, key_dim: int,
                 layer_sizes: Sequence[int], init: Initializer,
                 generator: torch.Generator, device: torch.device,
                 block_size: int = 256,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = block_size
        self.dtype = dtype
        self.n_layers = len(layer_sizes)
        self.attention_mat = new_param((key_dim, query_dim), init,
                                       generator, device)
        in_dim = 4 * query_dim
        for i, size in enumerate(layer_sizes):
            setattr(self, f"w_nn_layer{i}_kernel",
                    new_param((in_dim, size), init, generator, device))
            setattr(self, f"w_nn_layer{i}_bias",
                    new_param((size,), zeros_init, generator, device))
            in_dim = size
        self.w_nn_output_kernel = new_param((in_dim, 1), init, generator,
                                            device)
        self.w_nn_output_bias = new_param((1,), zeros_init, generator,
                                          device)

    def layers(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """[(kernel [in, out], bias)] of the scorer, the output last."""
        out = [(getattr(self, f"w_nn_layer{i}_kernel"),
                getattr(self, f"w_nn_layer{i}_bias"))
               for i in range(self.n_layers)]
        return out + [(self.w_nn_output_kernel, self.w_nn_output_bias)]

    def _block(self, m, s, acc, keys_blk, mask_blk, query, attention_mat,
               *flat_layers):
        layers = list(zip(flat_layers[::2], flat_layers[1::2]))
        logits = scorer_apply(keys_blk, query, attention_mat, layers,
                              self.dtype)
        return block_update(m, s, acc, logits, keys_blk, mask_blk)

    def forward(self, query: torch.Tensor, keys: torch.Tensor,
                mask: torch.Tensor, train_kernel: Optional[bool] = None,
                axis_name=None) -> torch.Tensor:
        """query [B, Dq] or [B, G, Dq]; keys [B, L, Dk]; mask [B, L] ->
        att_fea [B, Dk] or [B, G, Dk].  `train_kernel` is accepted for
        the models' calls and ignored: no kernel runs here.  With a
        process group as `axis_name`, keys and mask are this rank's
        shard of the sequence (the module docstring)."""
        if isinstance(axis_name, str):
            raise TypeError(
                "axis_name must be a torch.distributed process group over "
                "which the keys' L axis is sharded (the sequence-parallel "
                "merge, ROADMAP queue 1 item 10b), not the JAX axis name "
                f"{axis_name!r}")
        squeeze = query.dim() == 2
        if squeeze:
            query = query[:, None, :]
        B, G, _ = query.shape
        L, Dk = keys.shape[1], keys.shape[2]
        C = min(self.block_size, L)
        pad = (-L) % C
        if pad:
            keys = nn.functional.pad(keys, (0, 0, 0, pad))
            mask = nn.functional.pad(mask, (0, pad))
        f32 = dict(dtype=torch.float32, device=keys.device)
        m = torch.full((B, G), MASK_PADDING_VALUE, **f32)
        s = torch.zeros((B, G), **f32)
        acc = torch.zeros((B, G, Dk), **f32)
        params = [self.attention_mat] + [t for kb in self.layers()
                                         for t in kb]
        recompute = torch.is_grad_enabled()
        for j in range(keys.shape[1] // C):
            args = (m, s, acc, keys[:, j * C:(j + 1) * C],
                    mask[:, j * C:(j + 1) * C], query, *params)
            if recompute:
                m, s, acc = checkpoint(self._block, *args,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
            else:
                m, s, acc = self._block(*args)
        if axis_name is not None:
            m_all = all_gather_grad(m, axis_name)           # [P, B, G]
            s_all = all_gather_grad(s, axis_name)
            acc_all = all_gather_grad(acc, axis_name)
            m_g = torch.amax(m_all, dim=0)
            scale = torch.exp(m_all - m_g[None])
            s = (s_all * scale).sum(0)
            acc = (acc_all * scale[..., None]).sum(0)
        att_fea = acc / s.clamp_min(1e-30)[..., None]
        return att_fea[:, 0] if squeeze else att_fea
