"""Fused CLSR recurrent encoder.

Counterpart of clsr_tpu/ops/fused_clsr.py:165-310 (`FusedCLSREncoder`):
the CLSR forward runs three recurrences over the same history
(clsr.py:161,194,230): the interest-evolution GRU (initial state = user
short embedding), the Time4LSTM and the "causal2" GRU.  All input-only
projections of the three cells are hoisted into one matmul over the
whole history (:257-286); the loop then carries only the h-dependent
products.

Parameters keep the flax names, shapes ([in, out]) and inits.  With
`use_pallas` (cfg.use_pallas_scan) and both optional cells on, the loop
is kernel K2 (ops/fused_scan.py), with the candidate biases folded into
xc1/xc2 as in :291-298; in training its forward also saves each step's
carry and its backward is the `clsr_scan_backward` kernel from those
carries plus five weight products (`fused_scan.scan_backward`).
Otherwise it is the plain recurrence of the same module under autograd:
JAX's block-diagonal scan differs from it only by exact +0.0 terms.  A
cell switched off keeps its initial carry, as the JAX per-cell step
does.

With a compute `dtype` (bfloat16; JAX :259-285 and the step at
:400-430, `_cast` / `_f32`) the input projections, the time terms and
each step's h @ W products run in bf16, each pre-activation sum
(projection + product) is rounded to bf16 and upcast, and the gates,
the carries and the candidate biases stay f32 (`_mixed_scan`).  JAX
runs K2 only when that dtype is None (:291), so under bf16 compute the
plain recurrence runs even with `use_pallas`: the reference's
semantics, not a fallback.  JAX has no bf16 K2, and neither has the
port.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from clsr_tpu_torch.ops.fused_scan import fused_scan, scan_reference
from clsr_tpu_torch.ops.initializers import (new_param, ones_init,
                                             tf1_glorot_uniform, zeros_init)


class FusedCLSREncoder(nn.Module):
    """(interest-evolve GRU + Time4LSTM + causal2 GRU) over one history.

    Returns (short_term_intention [B, U], rnn_outputs [B, L, H],
    causal2_state [B, H]).
    """

    def __init__(self, input_dim: int, user_dim: int, hidden_size: int,
                 generator: torch.Generator, device: torch.device,
                 interest_evolve: bool = True,
                 predict_long_short: bool = True,
                 use_pallas: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        D, U, H = input_dim, user_dim, hidden_size
        self.dtype = dtype
        self.dims = (D, U, H)
        self.interest_evolve = interest_evolve
        self.predict_long_short = predict_long_short
        self.use_pallas = use_pallas
        glorot, ones, zeros = tf1_glorot_uniform, ones_init, zeros_init
        shapes = {
            # interest-evolve GRU (hidden U)
            "stint_gate_kernel": ((D + U, 2 * U), glorot),
            "stint_gate_bias": ((2 * U,), ones),
            "stint_cand_kernel": ((D + U, U), glorot),
            "stint_cand_bias": ((U,), zeros),
            # Time4LSTM
            "t4l_time_input_w1": ((H,), glorot),
            "t4l_time_input_bias1": ((H,), zeros),
            "t4l_time_input_w2": ((H,), glorot),
            "t4l_time_input_bias2": ((H,), zeros),
            "t4l_time_kernel_w1": ((D, H), glorot),
            "t4l_time_kernel_t1": ((H, H), glorot),
            "t4l_time_bias1": ((H,), zeros),
            "t4l_time_kernel_w2": ((D, H), glorot),
            "t4l_time_kernel_t2": ((H, H), glorot),
            "t4l_time_bias2": ((H,), zeros),
            "t4l_o_kernel_t1": ((H, H), glorot),
            "t4l_o_kernel_t2": ((H, H), glorot),
            "t4l_kernel": ((D + H, 4 * H), glorot),
            "t4l_bias": ((4 * H,), zeros),
            # causal2 GRU (hidden H)
            "causal2_gate_kernel": ((D + H, 2 * H), glorot),
            "causal2_gate_bias": ((2 * H,), ones),
            "causal2_cand_kernel": ((D + H, H), glorot),
            "causal2_cand_bias": ((H,), zeros),
        }
        for name, (shape, init) in shapes.items():
            setattr(self, name, new_param(shape, init, generator, device))

    def forward(self, hist: torch.Tensor, t_last: torch.Tensor,
                t_now: torch.Tensor, mask: torch.Tensor,
                user_short: torch.Tensor):
        D, U, H = self.dims
        dt = self.dtype
        cast = (lambda t: t) if dt is None else (lambda t: t.to(dt))
        # --- one input projection over the whole history: [2U, U | 4H | 2H, H]
        x_kernel = torch.cat(
            [self.stint_gate_kernel[:D], self.stint_cand_kernel[:D],
             self.t4l_kernel[:D], self.causal2_gate_kernel[:D],
             self.causal2_cand_kernel[:D]], dim=1)
        hist = cast(hist)
        x_proj = hist @ cast(x_kernel)
        xg1, xc1, xw, xg2, xc2 = x_proj.split([2 * U, U, 4 * H, 2 * H, H],
                                              dim=-1)
        xg1 = xg1 + cast(self.stint_gate_bias)
        xw = xw + cast(self.t4l_bias)
        xg2 = xg2 + cast(self.causal2_gate_bias)

        # Time4LSTM's input-only time terms (ops/rnn.py Time4LSTM)
        tn_in = cast(torch.tanh(t_now[..., None] * self.t4l_time_input_w1
                                + self.t4l_time_input_bias1))
        tl_in = cast(torch.tanh(t_last[..., None] * self.t4l_time_input_w2
                                + self.t4l_time_input_bias2))
        tn_state = (hist @ cast(self.t4l_time_kernel_w1)
                    + tn_in @ cast(self.t4l_time_kernel_t1)
                    + cast(self.t4l_time_bias1))
        tl_state = (hist @ cast(self.t4l_time_kernel_w2)
                    + tl_in @ cast(self.t4l_time_kernel_t2)
                    + cast(self.t4l_time_bias2))
        o_time = (tn_in @ cast(self.t4l_o_kernel_t1)
                  + tl_in @ cast(self.t4l_o_kernel_t2))

        run_g1, run_g2 = self.interest_evolve, self.predict_long_short
        if dt is not None:
            h1_f, outs, h2_f = self._mixed_scan(
                dt, (xg1, xc1, xw, tn_state, tl_state, o_time, xg2, xc2),
                mask, user_short)
            return (h1_f if run_g1 else user_short, outs,
                    h2_f if run_g2 else torch.zeros_like(h2_f))
        scan = (fused_scan if self.use_pallas and run_g1 and run_g2
                else scan_reference)
        c = lambda t: t.contiguous()
        h1_f, outs, h2_f = scan(
            c(xg1), c(xc1 + self.stint_cand_bias), c(xw), tn_state,
            tl_state, o_time, c(xg2), c(xc2 + self.causal2_cand_bias),
            mask, c(user_short), c(self.stint_gate_kernel[D:]),
            c(self.stint_cand_kernel[D:]), c(self.t4l_kernel[D:]),
            c(self.causal2_gate_kernel[D:]),
            c(self.causal2_cand_kernel[D:]))
        if not run_g1:
            h1_f = user_short
        if not run_g2:
            h2_f = torch.zeros_like(h2_f)
        return h1_f, outs, h2_f

    def _mixed_scan(self, dt: torch.dtype, projs, mask: torch.Tensor,
                    user_short: torch.Tensor):
        """The recurrence under compute dtype `dt` (JAX's step at
        :400-430; the block-diagonal products there add exact zeros, so
        each cell's product is its own): (h1 [B, U], outs [B, L, H],
        h2 [B, H]), all f32."""
        D, U, H = self.dims
        xg1, xc1, xw, tn, tl, ot, xg2, xc2 = projs
        cast = lambda t: t.to(dt)
        whg1, whc1 = (cast(self.stint_gate_kernel[D:]),
                      cast(self.stint_cand_kernel[D:]))
        wh4 = cast(self.t4l_kernel[D:])
        whg2, whc2 = (cast(self.causal2_gate_kernel[D:]),
                      cast(self.causal2_cand_kernel[D:]))
        bc1, bc2 = self.stint_cand_bias, self.causal2_cand_bias
        h1 = user_short.float()
        c = m = h2 = torch.zeros(mask.shape[0], H, dtype=torch.float32,
                                 device=mask.device)
        outs = []
        for t in range(mask.shape[1]):
            mt = mask[:, t, None].float()
            if self.interest_evolve:
                r1, u1 = torch.sigmoid(
                    (xg1[:, t] + cast(h1) @ whg1).float()).split(U, dim=-1)
                cand1 = torch.tanh(
                    (xc1[:, t] + cast(r1 * h1) @ whc1).float() + bc1)
                h1 = mt * (u1 * h1 + (1 - u1) * cand1) + (1 - mt) * h1
            i, j, f, o = (xw[:, t] + cast(m) @ wh4).float().split(H, dim=-1)
            o = o + ot[:, t].float()
            c_new = (torch.sigmoid(f + 1.0) * torch.sigmoid(tl[:, t].float())
                     * c + torch.sigmoid(i)
                     * torch.sigmoid(tn[:, t].float()) * torch.tanh(j))
            m_new = torch.sigmoid(o) * torch.tanh(c_new)
            c = mt * c_new + (1 - mt) * c
            m = mt * m_new + (1 - mt) * m
            outs.append(mt * m_new)
            if self.predict_long_short:
                r2, u2 = torch.sigmoid(
                    (xg2[:, t] + cast(h2) @ whg2).float()).split(H, dim=-1)
                cand2 = torch.tanh(
                    (xc2[:, t] + cast(r2 * h2) @ whc2).float() + bc2)
                h2 = mt * (u2 * h2 + (1 - u2) * cand2) + (1 - mt) * h2
        return h1, torch.stack(outs, dim=1), h2
