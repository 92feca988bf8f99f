"""Recurrent cells over a masked history, as plain PyTorch loops.

Counterpart of clsr_tpu/ops/rnn.py (the reference's TF1 cells and forked
dynamic_rnn, rnn_cell_implement.py:46-708, rnn_dien.py:439-753).  The
JAX package runs these as `jax.lax.scan`, not as Pallas kernels, so the
port runs them as a Python loop over L of small tensor ops; under a CUDA
graph (training/steps.py) the loop is captured like any other op.

  * Each weight is a raw `nn.Parameter` in the flax layout (`gate_kernel`
    [D+H, 2H], `cand_kernel` [D+H, H], `kernel` [D+H, 4H], ...), so
    `weights.from_flax` carries it across with no transpose.
  * The input projections are hoisted out of the loop (one [B, L, D] x
    [D, k] product); the loop carries only the h-dependent products.
    Time4LSTM's time terms are input-only and hoisted too.
  * Masking is the carry blend of `_masked_scan` (:55-76): carry =
    m * new + (1 - m) * old, output m * out, so outputs are zero past a
    row's length and the final state is the state at length - 1.
  * Cell math is TF1's:
      GRU       gates sigmoid([x, h] Wg + bg), bg initialised to ones;
                candidate tanh(x Wc_x + (r * h) Wc_h + bc), so not
                `torch.nn.GRU`; h' = u h + (1 - u) c.
      LSTM      i, j, f, o = split([x, m] W + b); c' = sig(f + 1) c +
                sig(i) tanh(j); m' = sig(o) tanh(c').
      Time4LSTM two learned time embeddings gate the forget and input
                paths and add into the output gate; `t_last` is
                time_from_first and `t_now` time_to_now.
      Time4ALSTM Time4LSTM under `t4l`, its outputs blended with the
                attention score as a * out + (1 - a) * out (the identity,
                kept literally as in the reference).
      VecAttGRU the GRU with u = (1 - att) u; scores [B, L] give one
                stream, [B, G, L] give G streams with a [B, G, H] carry
                over one shared input projection.
  * With a compute `dtype` (bfloat16; JAX `_cast` / `_f32`, :41-53) the
    input projections and each step's h @ W run in that dtype, each
    pre-activation sum is rounded to it and upcast, and the gates, the
    carries and the candidate biases stay f32.  A model passes a dtype
    only where its JAX counterpart does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from clsr_tpu_torch.ops.initializers import (new_param, ones_init,
                                             tf1_glorot_uniform, zeros_init)


def _caster(dt: Optional[torch.dtype]):
    """(cast, f32): JAX's `_cast` and `_f32`, identities when dt is None."""
    if dt is None:
        same = lambda t: t
        return same, same
    return (lambda t: t.to(dt)), (lambda t: t.float())


def _blend(m: torch.Tensor, new: torch.Tensor, old: torch.Tensor
           ) -> torch.Tensor:
    return m * new + (1.0 - m) * old


def _add_params(module: nn.Module, specs, generator: torch.Generator,
                device: torch.device) -> None:
    """(name, shape, init) parameters in the flax layout, in flax's
    creation order."""
    for name, shape, init in specs:
        setattr(module, name, new_param(shape, init, generator, device))


def _gru_specs(D: int, H: int):
    return (("gate_kernel", (D + H, 2 * H), tf1_glorot_uniform),
            ("gate_bias", (2 * H,), ones_init),
            ("cand_kernel", (D + H, H), tf1_glorot_uniform),
            ("cand_bias", (H,), zeros_init))


class GRU(nn.Module):
    """TF1-parity GRU over [B, L, D] with masking.

    forward(x, mask, init_state=None) -> (outputs [B, L, H], final [B, H])."""

    def __init__(self, input_dim: int, hidden_size: int,
                 generator: torch.Generator, device: torch.device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        D, H = input_dim, hidden_size
        self.dims, self.dtype = (D, H), dtype
        _add_params(self, _gru_specs(D, H), generator, device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        D, H = self.dims
        cast, f32 = _caster(self.dtype)
        xc_ = cast(x)
        xg = xc_ @ cast(self.gate_kernel[:D]) + cast(self.gate_bias)
        xc = xc_ @ cast(self.cand_kernel[:D])
        whg, whc = cast(self.gate_kernel[D:]), cast(self.cand_kernel[D:])
        h = (init_state if init_state is not None else
             torch.zeros(x.shape[0], H, dtype=torch.float32,
                         device=x.device))
        outs = []
        for t in range(x.shape[1]):
            m = mask[:, t, None]
            r, u = torch.sigmoid(f32(xg[:, t] + cast(h) @ whg)).split(H, -1)
            c = torch.tanh(f32(xc[:, t] + cast(r * h) @ whc)
                           + self.cand_bias)
            h_new = u * h + (1.0 - u) * c
            h = _blend(m, h_new, h)
            outs.append(m * h_new)
        return torch.stack(outs, dim=1), h


class LSTM(nn.Module):
    """TF1-parity basic LSTMCell (no peepholes), forget bias 1.0, from a
    zero state (JAX's `init_state`, which no model passes, is left out).

    forward(x, mask) -> (outputs [B, L, H], (c, m))."""

    def __init__(self, input_dim: int, hidden_size: int,
                 generator: torch.Generator, device: torch.device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        D, H = input_dim, hidden_size
        self.dims, self.dtype = (D, H), dtype
        _add_params(self, (("kernel", (D + H, 4 * H), tf1_glorot_uniform),
                           ("bias", (4 * H,), zeros_init)),
                    generator, device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        D, H = self.dims
        cast, f32 = _caster(self.dtype)
        xw = cast(x) @ cast(self.kernel[:D]) + cast(self.bias)
        wh = cast(self.kernel[D:])
        c = h = torch.zeros(x.shape[0], H, dtype=torch.float32,
                            device=x.device)
        outs = []
        for t in range(x.shape[1]):
            mt = mask[:, t, None]
            i, j, f, o = f32(xw[:, t] + cast(h) @ wh).split(H, -1)
            c_new = (torch.sigmoid(f + 1.0) * c
                     + torch.sigmoid(i) * torch.tanh(j))
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            c, h = _blend(mt, c_new, c), _blend(mt, h_new, h)
            outs.append(mt * h_new)
        return torch.stack(outs, dim=1), (c, h)


class Time4LSTM(nn.Module):
    """Time-aware LSTM (rnn_cell_implement.py:46-298); 14 parameters.

    forward(x, t_last, t_now, mask) -> (outputs [B, L, H], (c, m))."""

    def __init__(self, input_dim: int, hidden_size: int,
                 generator: torch.Generator, device: torch.device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        D, H = input_dim, hidden_size
        self.dims, self.dtype = (D, H), dtype
        _add_params(self, (
            ("time_input_w1", (H,), tf1_glorot_uniform),
            ("time_input_bias1", (H,), zeros_init),
            ("time_input_w2", (H,), tf1_glorot_uniform),
            ("time_input_bias2", (H,), zeros_init),
            ("time_kernel_w1", (D, H), tf1_glorot_uniform),
            ("time_kernel_t1", (H, H), tf1_glorot_uniform),
            ("time_bias1", (H,), zeros_init),
            ("time_kernel_w2", (D, H), tf1_glorot_uniform),
            ("time_kernel_t2", (H, H), tf1_glorot_uniform),
            ("time_bias2", (H,), zeros_init),
            ("o_kernel_t1", (H, H), tf1_glorot_uniform),
            ("o_kernel_t2", (H, H), tf1_glorot_uniform),
            ("kernel", (D + H, 4 * H), tf1_glorot_uniform),
            ("bias", (4 * H,), zeros_init)), generator, device)

    def forward(self, x: torch.Tensor, t_last: torch.Tensor,
                t_now: torch.Tensor, mask: torch.Tensor):
        D, H = self.dims
        cast, f32 = _caster(self.dtype)
        # input-only terms, hoisted out of the recurrence
        xc_ = cast(x)
        tn_in = cast(torch.tanh(t_now[..., None] * self.time_input_w1
                                + self.time_input_bias1))      # [B, L, H]
        tl_in = cast(torch.tanh(t_last[..., None] * self.time_input_w2
                                + self.time_input_bias2))
        tn_state = (xc_ @ cast(self.time_kernel_w1)
                    + tn_in @ cast(self.time_kernel_t1)
                    + cast(self.time_bias1))
        tl_state = (xc_ @ cast(self.time_kernel_w2)
                    + tl_in @ cast(self.time_kernel_t2)
                    + cast(self.time_bias2))
        o_time = (tn_in @ cast(self.o_kernel_t1)
                  + tl_in @ cast(self.o_kernel_t2))
        xw = xc_ @ cast(self.kernel[:D]) + cast(self.bias)
        wh = cast(self.kernel[D:])
        c = h = torch.zeros(x.shape[0], H, dtype=torch.float32,
                            device=x.device)
        outs = []
        for t in range(x.shape[1]):
            mt = mask[:, t, None]
            i, j, f, o = f32(xw[:, t] + cast(h) @ wh).split(H, -1)
            o = o + f32(o_time[:, t])
            c_new = (torch.sigmoid(f + 1.0) * torch.sigmoid(
                f32(tl_state[:, t])) * c
                + torch.sigmoid(i) * torch.sigmoid(f32(tn_state[:, t]))
                * torch.tanh(j))
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            c, h = _blend(mt, c_new, c), _blend(mt, h_new, h)
            outs.append(mt * h_new)
        return torch.stack(outs, dim=1), (c, h)


class Time4ALSTM(nn.Module):
    """Attention-blended Time4LSTM (rnn_cell_implement.py:301-555): the
    blend c = a c + (1 - a) c is the identity, kept literally; no model
    of the reference instantiates it.

    forward(x, t_last, t_now, att_scores [B, L], mask)."""

    def __init__(self, input_dim: int, hidden_size: int,
                 generator: torch.Generator, device: torch.device):
        super().__init__()
        self.t4l = Time4LSTM(input_dim, hidden_size, generator, device)

    def forward(self, x, t_last, t_now, att_scores, mask):
        outs, state = self.t4l(x, t_last, t_now, mask)
        a = att_scores[..., None]
        return a * outs + (1.0 - a) * outs, state


class VecAttGRU(nn.Module):
    """Attention-modulated GRU (DIEN; rnn_cell_implement.py:558-623).

    forward(x [B, L, D], att_scores [B, L] or [B, G, L], mask) ->
    (outputs [B, L, H], final [B, H]) or, with grouped scores,
    (outputs [B, G, L, H], final [B, G, H]); the initial state is zero
    (JAX's `init_state`, which no model passes, is left out)."""

    def __init__(self, input_dim: int, hidden_size: int,
                 generator: torch.Generator, device: torch.device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        D, H = input_dim, hidden_size
        self.dims, self.dtype = (D, H), dtype
        _add_params(self, _gru_specs(D, H), generator, device)

    def forward(self, x: torch.Tensor, att_scores: torch.Tensor,
                mask: torch.Tensor):
        D, H = self.dims
        cast, f32 = _caster(self.dtype)
        B = x.shape[0]
        grouped = att_scores.dim() == 3
        att = att_scores if grouped else att_scores[:, None, :]  # [B, G, L]
        G = att.shape[1]
        xc_ = cast(x)
        xg = xc_ @ cast(self.gate_kernel[:D]) + cast(self.gate_bias)
        xc = xc_ @ cast(self.cand_kernel[:D])
        whg, whc = cast(self.gate_kernel[D:]), cast(self.cand_kernel[D:])
        h = torch.zeros(B, G, H, dtype=torch.float32, device=x.device)
        outs = []
        for t in range(x.shape[1]):
            m = mask[:, t, None, None]
            r, u = torch.sigmoid(f32(xg[:, t, None, :] + cast(h) @ whg)
                                 ).split(H, -1)
            c = torch.tanh(f32(xc[:, t, None, :] + cast(r * h) @ whc)
                           + self.cand_bias)
            u = (1.0 - att[:, :, t, None]) * u
            h_new = u * h + (1.0 - u) * c
            h = _blend(m, h_new, h)
            outs.append(m * h_new)
        outs = torch.stack(outs, dim=2)                        # [B, G, L, H]
        if not grouped:
            return outs[:, 0], h[:, 0]
        return outs, h
