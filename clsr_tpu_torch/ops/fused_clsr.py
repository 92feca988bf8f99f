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
xc1/xc2 as in :291-298; in training its backward recomputes through the
plain recurrence.  Otherwise it is the plain recurrence of the same
module under autograd: JAX's block-diagonal scan differs from it only
by exact +0.0 terms.  A cell switched off keeps its initial carry, as
the JAX per-cell step does.
"""

from __future__ import annotations

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
                 use_pallas: bool = False):
        super().__init__()
        D, U, H = input_dim, user_dim, hidden_size
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
        # --- one input projection over the whole history: [2U, U | 4H | 2H, H]
        x_kernel = torch.cat(
            [self.stint_gate_kernel[:D], self.stint_cand_kernel[:D],
             self.t4l_kernel[:D], self.causal2_gate_kernel[:D],
             self.causal2_cand_kernel[:D]], dim=1)
        x_proj = hist @ x_kernel
        xg1, xc1, xw, xg2, xc2 = x_proj.split([2 * U, U, 4 * H, 2 * H, H],
                                              dim=-1)
        xg1 = xg1 + self.stint_gate_bias
        xw = xw + self.t4l_bias
        xg2 = xg2 + self.causal2_gate_bias

        # Time4LSTM's input-only time terms (ops/rnn.py Time4LSTM)
        tn_in = torch.tanh(t_now[..., None] * self.t4l_time_input_w1
                           + self.t4l_time_input_bias1)
        tl_in = torch.tanh(t_last[..., None] * self.t4l_time_input_w2
                           + self.t4l_time_input_bias2)
        tn_state = (hist @ self.t4l_time_kernel_w1
                    + tn_in @ self.t4l_time_kernel_t1 + self.t4l_time_bias1)
        tl_state = (hist @ self.t4l_time_kernel_w2
                    + tl_in @ self.t4l_time_kernel_t2 + self.t4l_time_bias2)
        o_time = (tn_in @ self.t4l_o_kernel_t1
                  + tl_in @ self.t4l_o_kernel_t2)

        run_g1, run_g2 = self.interest_evolve, self.predict_long_short
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
