"""K2: the three-cell CLSR recurrence, forward and backward kernels.

Counterpart of clsr_tpu/ops/pallas_scan.py: `scan_reference` transcribes
`_scan_reference` (:185-222) and `fused_scan` is the custom-VJP
`fused_scan` (:225-248) whose TPU kernel is `_kernel` (:45).  All L
steps of the interest-evolve GRU (h1_0 = user_short), the Time4LSTM
(forget bias +1, time gates tn/tl, output term ot) and the causal2 GRU,
with masked carry-through x = mt*x_new + (1-mt)*x.  The candidate biases
come folded into xc1/xc2; the five recurrent matrices are the only
weights.  Returns (h1_final [B, U], outs [B, L, H] = mt*m_new, h2_final
[B, H]).

`fused_scan` is a `torch.autograd.Function` shaped like the JAX
package's hand-written backward `_bd_scan` (clsr_tpu/ops/fused_clsr.py:
79-162).  Its forward also keeps each step's input carry
(h1 | c | m | h2, [B, L, U+3H]) when a backward can follow; its
backward walks the steps in reverse from those carries
(`scan_backward`), and the five weight gradients are one product each
over the stacked steps (`scan_weight_grads`): xg/xc enter the
pre-activations additively, so their cotangents are the products'
output cotangents.  On CPU tensors both directions run their plain
versions (`scan_forward_reference`, `scan_backward_reference`); on CUDA
tensors they launch csrc/clsr_scan.cu or raise.  `mask` gets no
gradient.  `fused_scan.launches` and `scan_backward.launches` count
kernel launches.
"""

from __future__ import annotations

import torch

from clsr_tpu_torch.ops import _build


def _step(t, carry, args):
    """One step of the recurrence -> (new carry, output)."""
    (xg1, xc1, xw, tn, tl, ot, xg2, xc2, mask, _,
     whg1, whc1, wh4, whg2, whc2) = args
    h1, c, m, h2 = carry
    U, H = h1.shape[-1], c.shape[-1]
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
             + torch.sigmoid(i) * torch.sigmoid(tn[:, t]) * torch.tanh(j))
    m_new = torch.sigmoid(o) * torch.tanh(c_new)
    c = mt * c_new + (1 - mt) * c
    m = mt * m_new + (1 - mt) * m
    gates2 = torch.sigmoid(xg2[:, t] + h2 @ whg2)
    r2, u2 = gates2[:, :H], gates2[:, H:]
    cand2 = torch.tanh(xc2[:, t] + (r2 * h2) @ whc2)
    h2 = mt * (u2 * h2 + (1 - u2) * cand2) + (1 - mt) * h2
    return (h1, c, m, h2), mt * m_new


def _initial_carry(args):
    xw, ushort, whc2 = args[2], args[9], args[14]
    zero = torch.zeros(xw.shape[0], whc2.shape[-1], dtype=xw.dtype,
                       device=xw.device)
    return ushort, zero, zero, zero


def scan_reference(xg1, xc1, xw, tn, tl, ot, xg2, xc2, mask, ushort,
                   whg1, whc1, wh4, whg2, whc2):
    """Plain PyTorch recurrence, one Python step per history position."""
    args = (xg1, xc1, xw, tn, tl, ot, xg2, xc2, mask, ushort,
            whg1, whc1, wh4, whg2, whc2)
    carry = _initial_carry(args)
    outs = []
    for t in range(xw.shape[1]):
        carry, out = _step(t, carry, args)
        outs.append(out)
    return carry[0], torch.stack(outs, dim=1), carry[3]


def scan_forward_reference(*args):
    """`scan_reference`'s outputs plus `carries` [B, L, U+3H]: each
    step's input carry h1 | c | m | h2, as `_bd_scan_fwd` saves it
    (clsr_tpu/ops/fused_clsr.py:105-111)."""
    carry = _initial_carry(args)
    outs, carries = [], []
    for t in range(args[2].shape[1]):
        carries.append(torch.cat(carry, dim=-1))
        carry, out = _step(t, carry, args)
        outs.append(out)
    return carry[0], torch.stack(outs, dim=1), carry[3], \
        torch.stack(carries, dim=1)


def _cotangents(inputs, d_h1f, d_outs, d_h2f):
    """The output cotangents, contiguous, zeros for None."""
    tn, ushort = inputs[3], inputs[9]
    B = tn.shape[0]
    return tuple(torch.zeros(shape, dtype=tn.dtype, device=tn.device)
                 if d is None else d.contiguous()
                 for d, shape in ((d_h1f, ushort.shape), (d_outs, tn.shape),
                                  (d_h2f, (B, tn.shape[-1]))))


def scan_weight_grads(carries, zc, dxg1, dxc1, dxw, dxg2, dxc2):
    """(dWhg1, dWhc1, dWh4, dWhg2, dWhc2), one product each over the
    stacked steps (clsr_tpu/ops/fused_clsr.py:143-159): h1ᵀ·dxg1,
    (r1∘h1)ᵀ·dxc1, mᵀ·dxw, h2ᵀ·dxg2, (r2∘h2)ᵀ·dxc2, with `zc` [B, L, U+H]
    each step's r1∘h1 | r2∘h2."""
    U, H = dxc1.shape[-1], dxc2.shape[-1]
    h1, _, m, h2 = carries.split([U, H, H, H], dim=-1)
    z1, z2 = zc.split([U, H], dim=-1)
    flat = lambda t: t.reshape(-1, t.shape[-1])
    return tuple(flat(a).t() @ flat(d) for a, d in
                 ((h1, dxg1), (z1, dxc1), (m, dxw), (h2, dxg2), (z2, dxc2)))


def scan_backward_reference(inputs, carries, d_h1f, d_outs, d_h2f):
    """Plain backward of the recurrence, derived by hand, no autograd.

    Walks t = L-1 .. 0, recomputing each step's forward from
    `carries[:, t]`, and carries the adjoint (dh1, dc, dm, dh2) back.
    Returns the 15 gradients in argument order: those of xg1, xc1, xw,
    tn, tl, ot, xg2, xc2, None for mask, that of ushort, then the five
    weight gradients (`scan_weight_grads`).  A cotangent of None counts
    as zero."""
    (xg1, xc1, xw, tn, tl, ot, xg2, xc2, mask, _,
     whg1, whc1, wh4, whg2, whc2) = inputs
    d_h1f, d_outs, d_h2f = _cotangents(inputs, d_h1f, d_outs, d_h2f)
    U, H = xc1.shape[-1], xc2.shape[-1]
    dx = [torch.empty_like(t) for t in (xg1, xc1, xw, tn, tl, ot, xg2, xc2)]
    zc = torch.empty(*xw.shape[:2], U + H, dtype=xw.dtype, device=xw.device)
    dh1, dh2 = d_h1f, d_h2f
    dc = dm = torch.zeros_like(d_h2f)
    dsig = lambda s: s * (1 - s)
    for t in reversed(range(xw.shape[1])):
        h1, c, m, h2 = carries[:, t].split([U, H, H, H], dim=-1)
        mt = mask[:, t, None]
        # the step's forward
        r1, u1 = torch.sigmoid(xg1[:, t] + h1 @ whg1).split(U, dim=-1)
        n1 = torch.tanh(xc1[:, t] + (r1 * h1) @ whc1)
        i, j, f, o = (xw[:, t] + m @ wh4).split(H, dim=-1)
        sf, stl = torch.sigmoid(f + 1.0), torch.sigmoid(tl[:, t])
        si, stn = torch.sigmoid(i), torch.sigmoid(tn[:, t])
        tj, so = torch.tanh(j), torch.sigmoid(o + ot[:, t])
        tc = torch.tanh(sf * stl * c + si * stn * tj)
        r2, u2 = torch.sigmoid(xg2[:, t] + h2 @ whg2).split(H, dim=-1)
        n2 = torch.tanh(xc2[:, t] + (r2 * h2) @ whc2)
        zc[:, t] = torch.cat([r1 * h1, r2 * h2], dim=-1)
        # the two GRUs: candidate, then reset and update gates
        grus = []
        for dh, h, r, u, n, whg, whc in ((dh1, h1, r1, u1, n1, whg1, whc1),
                                         (dh2, h2, r2, u2, n2, whg2, whc2)):
            dhn = mt * dh
            dca = dhn * (1 - u) * (1 - n * n)
            dz = dca @ whc.t()
            dga = torch.cat([dz * h * dsig(r), dhn * (h - n) * dsig(u)], -1)
            grus.append((dga, dca, (1 - mt) * dh + u * dhn + dz * r
                         + dga @ whg.t()))
        (dga1, dca1, dh1), (dga2, dca2, dh2) = grus
        # the Time4LSTM
        dmn = mt * (dm + d_outs[:, t])
        dcn = mt * dc + dmn * so * (1 - tc * tc)
        dmat = torch.cat([dcn * stn * tj * dsig(si),
                          dcn * si * stn * (1 - tj * tj),
                          dcn * stl * c * dsig(sf),
                          dmn * tc * dsig(so)], dim=-1)
        dx[3][:, t] = dcn * si * tj * dsig(stn)
        dx[4][:, t] = dcn * sf * c * dsig(stl)
        dx[5][:, t] = dmat[:, 3 * H:]
        dc = (1 - mt) * dc + dcn * sf * stl
        dm = (1 - mt) * dm + dmat @ wh4.t()
        for k, d in ((0, dga1), (1, dca1), (2, dmat), (6, dga2), (7, dca2)):
            dx[k][:, t] = d
    return (*dx, None, dh1) + scan_weight_grads(carries, zc, dx[0], dx[1],
                                                 dx[2], dx[6], dx[7])


_ARG_NAMES = ("xg1", "xc1", "xw", "tn", "tl", "ot", "xg2", "xc2", "mask",
              "ushort", "whg1", "whc1", "wh4", "whg2", "whc2")


def _shapes(B, L, U, H):
    return [(B, L, 2 * U), (B, L, U), (B, L, 4 * H), (B, L, H), (B, L, H),
            (B, L, H), (B, L, 2 * H), (B, L, H), (B, L), (B, U), (U, 2 * U),
            (U, U), (H, 4 * H), (H, 2 * H), (H, H)]


# The kernels' limits (csrc/clsr_scan.cu: kMaxWidth, the rows a block
# may walk, kBlocksPerSM), the same in both directions: every U and H up
# to FORWARD_MAX_WIDTH; the launch bounds keep BLOCKS_PER_SM blocks
# resident on an SM.
FORWARD_MAX_WIDTH = 64
ROWS = (1, 4)
BLOCKS_PER_SM = 3


def check_forward_widths(U, H):
    """Raise ValueError unless the kernels (forward and backward) take
    widths U and H."""
    if not (1 <= U <= FORWARD_MAX_WIDTH and 1 <= H <= FORWARD_MAX_WIDTH):
        raise ValueError(f"the recurrence kernel takes U and H from 1 to "
                         f"{FORWARD_MAX_WIDTH}, got U={U}, H={H}")


def rows_per_block(B, n_sm):
    """Rows each block of either kernel walks: the fewest of ROWS that
    leave at most one row group per SM, so that the grid of
    3 x ceil(B / R) blocks (one per cell and group) is one wave; the most
    where none does."""
    for rows in ROWS:
        if -(-B // rows) <= n_sm:
            return rows
    return ROWS[-1]


_sm_counts = {}


def _sm_count(device):
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_counts[device]


def _dims(args):
    """(B, L, U, H), and the library once the kernels take the widths."""
    B, L, _ = args[2].shape
    U, H = args[9].shape[-1], args[14].shape[-1]
    _build.check_args(_ARG_NAMES, args, _shapes(B, L, U, H), args[2].device)
    check_forward_widths(U, H)
    return (B, L, U, H), _build.load("clsr_scan")


def _forward(*args, keep_carries=False):
    """(h1f, outs, h2f, carries or None): the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    xw = args[2]
    if xw.device.type == "cpu":
        if keep_carries:
            return scan_forward_reference(*args)
        return (*scan_reference(*args), None)
    if xw.device.type != "cuda":
        raise ValueError(f"no kernel for device {xw.device}")
    (B, L, U, H), lib = _dims(args)
    new = lambda *s: torch.empty(*s, device=xw.device, dtype=torch.float32)
    outs, h1f, h2f = new(B, L, H), new(B, U), new(B, H)
    carries = new(B, L, U + 3 * H) if keep_carries else None
    if B == 0:
        return h1f, outs, h2f, carries
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.clsr_scan_forward(
            *(t.data_ptr() for t in args), outs.data_ptr(), h1f.data_ptr(),
            h2f.data_ptr(), None if carries is None else carries.data_ptr(),
            B, L, U, H, rows_per_block(B, _sm_count(xw.device)),
            stream)
    _build.check(rc, "clsr_scan")
    fused_scan.launches += 1
    return h1f, outs, h2f, carries


def _backward_kernel(inputs, carries, d_h1f, d_outs, d_h2f):
    """The backward kernel alone -> the gradients of xg1 .. xc2 and of
    ushort, and zc [B, L, U+H] (each step's r1∘h1 | r2∘h2)."""
    (B, L, U, H), lib = _dims(inputs)
    dev = inputs[2].device
    _build.check_args(("carries", "d_h1f", "d_outs", "d_h2f"),
                      (carries, d_h1f, d_outs, d_h2f),
                      ((B, L, U + 3 * H), (B, U), (B, L, H), (B, H)), dev)
    grads = [torch.empty_like(t) for t in inputs[:8]] + [
        torch.empty_like(inputs[9]),
        torch.empty(B, L, U + H, device=dev, dtype=torch.float32)]
    if B == 0:
        return grads
    ins = inputs[:9] + inputs[10:] + (carries, d_h1f, d_outs, d_h2f)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.clsr_scan_backward(
            *(t.data_ptr() for t in ins + tuple(grads)), B, L, U, H,
            rows_per_block(B, _sm_count(dev)), stream)
    _build.check(rc, "clsr_scan_backward")
    scan_backward.launches += 1
    return grads


def scan_backward(inputs, carries, d_h1f, d_outs, d_h2f):
    """The recurrence's backward from the forward's saved carries: the
    plain version on CPU tensors; on CUDA tensors the backward kernel
    for the per-step adjoints, then the five weight products.  The 15
    gradients in argument order, None for mask."""
    inputs = tuple(inputs)
    xw = inputs[2]
    if xw.device.type == "cpu":
        return scan_backward_reference(inputs, carries, d_h1f, d_outs, d_h2f)
    if xw.device.type != "cuda":
        raise ValueError(f"no kernel for device {xw.device}")
    *dx, dus, zc = _backward_kernel(
        inputs, carries, *_cotangents(inputs, d_h1f, d_outs, d_h2f))
    return (*dx, None, dus) + scan_weight_grads(carries, zc, dx[0], dx[1],
                                                dx[2], dx[6], dx[7])


scan_backward.launches = 0


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
    def forward(ctx, keep_carries, *args):
        h1f, outs, h2f, carries = _forward(*args, keep_carries=keep_carries)
        ctx.save_for_backward(*args, carries)
        return h1f, outs, h2f

    @staticmethod
    def backward(ctx, d_h1f, d_outs, d_h2f):
        *inputs, carries = ctx.saved_tensors
        grads = scan_backward(inputs, carries, d_h1f, d_outs, d_h2f)
        return (None,) + tuple(g if need else None for g, need in
                               zip(grads, ctx.needs_input_grad[1:]))


def fused_scan(xg1, xc1, xw, tn, tl, ot, xg2, xc2, mask, ushort,
               whg1, whc1, wh4, whg2, whc2):
    """The fused recurrence -> (h1_final, outs, h2_final), differentiable
    in every input but `mask`.  The forward keeps the carries only where
    a backward can follow (serving under no_grad writes none)."""
    args = (xg1, xc1, xw, tn, tl, ot, xg2, xc2, mask.detach(), ushort,
            whg1, whc1, wh4, whg2, whc2)
    keep = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    return _FusedScan.apply(keep, *args)


fused_scan.launches = 0
