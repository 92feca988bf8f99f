"""The kernel-gated train and eval steps against the plain ones, at the
shapes a fit gives them.

`compare_steps` builds two models from the same weights: one with the
config's kernel gates, one with every gate off (`plain_config`).  It
runs the eval step of each on one test batch (K1 and K2's forward at
the eval shape), then the train step of each on one train batch with
the same generator (K1, K2's forward and backward, K3a and K3b, and
under lazyadam K5).  On the kernel side every K5 group is also held,
bit for bit, against `scatter_rows_group_reference` on copies of its
tables; the plain side writes its rows with that reference.  Under
compact lazyadam the tables hold no `.grad`, so their row gradients are
taken where the step hands them to `LazyAdam.compact_update`.

`failures` holds the result to the gates of `chip_smoke.py`'s first-
batch checks: scores 1e-4 abs, loss parts 1e-4 relative, each
gradient 1e-4 of its max abs, BN running statistics 1e-5 abs.  A
gradient that is zero by construction (a bias under train-mode BN or
under a softmax) is rounding noise on both sides: it gets phase 8's
1e-6 abs beside 1e-4 of the larger of its own max abs and its layer's
weight gradient's (`layer_scale`; the noise grows with the dL/dz that
both sum, and in the logit head it passes 1e-6 at B = 100).  A bf16
gradient (of a bf16 table) may sit one bf16 step away on the other
side, where the two f32 sums round to neighbours: that step (2^-7 of
the value at most) is allowed beside the gate.  On CPU
tensors both sides run the plain versions (the scorer through its
recompute Function on the kernel side) and no launch is counted.

With `same_kinks` the plain train step takes the kernel step's side of
every ReLU (`ReluSides`): a ReLU input that one float32 step of the
kernels' rounding moves across zero flips its unit's whole gradient
contribution, about 1/rows of a gradient's max abs, far past the 1e-4
gate, although both steps are right.  The gradients are then held at
1e-4 where both steps compute the same function, and each ReLU input
that changed sign may differ between the steps by KINK_ABS at most (the
eval scores' gate), so both sides lie that close to zero: a kernel that
moves a ReLU input further fails there.  Both steps must run their ReLUs in PyTorch (no K1 or K3 in the
train step), in the same order.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from clsr_tpu_torch.config import Config
from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.ops import row_update as ru
from clsr_tpu_torch.ops.launches import kernel_counters
from clsr_tpu_torch.training import lazy_adam
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import make_eval_step_fn, make_train_step

SCORE_TOL, LOSS_REL, GRAD_REL, ZERO_GRAD_ABS, BN_TOL = (
    1e-4, 1e-4, 1e-4, 1e-6, 1e-5)
BF16_GAP = 2.0 ** -7   # the largest gap between bf16 neighbours, relative
KINK_ABS = SCORE_TOL   # |x_kernel - x_plain| of a ReLU input that flipped
LOSS_FIELDS = ("loss", "data_loss", "regular_loss", "contrastive_loss",
               "discrepancy_loss")


def counted(fn: Callable):
    """(fn's result, each kernel's launches during fn): the counts set to
    0 just before and read just after."""
    ctrs = kernel_counters()
    for c in ctrs.values():
        c.launches = 0
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, {n: c.launches for n, c in ctrs.items()}


def plain_config(cfg: Config) -> Config:
    """cfg with every kernel gate off."""
    return cfg.replace(use_pallas_scan=False,
                       use_pallas_train_attention="off",
                       use_pallas_eval_attention="off")


def zero_by_construction(name: str) -> bool:
    """Gradients that are zero up to rounding: a dense bias under
    train-mode BN, and an output bias under a softmax."""
    return ((".w_nn_layer" in name and name.endswith(".bias"))
            or name.endswith("w_nn_output.bias"))


def layer_scale(name: str, grads: Mapping[str, torch.Tensor]) -> float:
    """The max abs of the gradient of the weight beside bias `name`: the
    scale of a zero-by-construction bias gradient's rounding noise (both
    sum the same dL/dz over the rows), 0 if there is none."""
    stem = name[:-len("bias")]
    for w in (stem + "weight", stem + "kernel"):
        if w in grads:
            return grads[w].abs().max().item()
    return 0.0


def _max_rel(got: Mapping[str, torch.Tensor],
             want: Mapping[str, torch.Tensor]) -> Tuple[float, float,
                                                         List[str]]:
    """(max err / max abs over the ordinary gradients, max abs err over
    the zero-by-construction ones, the names past their gate)."""
    rel, zero_abs, bad = 0.0, 0.0, []
    for n, w in want.items():
        if n not in got:
            bad.append(f"{n} (none)")
            continue
        err = (got[n].float() - w.float()).abs()
        if w.dtype == torch.bfloat16:
            # each side rounds its f32 gradient to bf16: neighbours
            # (2^-7 of the value apart) where the f32 sums differ
            err = (err - BF16_GAP * w.float().abs()).clamp_min(0.0)
        d = err.max().item()
        mx = w.float().abs().max().item()
        if zero_by_construction(n):
            zero_abs = max(zero_abs, d)
            allowed = (GRAD_REL * max(mx, layer_scale(n, want))
                       + ZERO_GRAD_ABS)
        else:
            rel = max(rel, d / max(mx, 1e-30))
            allowed = GRAD_REL * mx
        if not d <= allowed:
            bad.append(f"{n} ({d:.3e} > {allowed:.3e})")
    return rel, zero_abs, bad


class ReluSides(TorchFunctionMode):
    """Each ReLU called in PyTorch while the mode is on, in call order:
    keeps a copy of its input.  With `masks` (the inputs' signs of
    another run, x > 0), the i-th ReLU passes its input where the i-th
    mask is set and 0 elsewhere: the other run's side of every kink,
    with the gradient of that side."""
    RELUS = (torch.relu, F.relu, torch.Tensor.relu)

    def __init__(self, masks: Optional[List[torch.Tensor]] = None):
        super().__init__()
        self.masks, self.inputs = masks, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in self.RELUS:
            return func(*args, **kwargs)
        if kwargs.get("inplace") or len(args) > 1:
            raise ValueError("ReluSides takes no in-place ReLU")
        x = args[0]
        self.inputs.append(x.detach().clone())
        if self.masks is None:
            return func(*args, **kwargs)
        if len(self.inputs) > len(self.masks):
            raise AssertionError("more ReLUs than the recorded run's")
        return torch.where(self.masks[len(self.inputs) - 1], x, 0.0)


def kinks(got: List[torch.Tensor],
          want: List[torch.Tensor]) -> Tuple[int, float]:
    """(how many ReLU inputs changed sign between two runs' inputs, the
    largest |x_got - x_want| among them: both sides' distance from zero
    summed); the runs must have called the same ReLUs."""
    if [x.shape for x in got] != [x.shape for x in want]:
        raise AssertionError(
            f"the two steps ran other ReLUs: {[tuple(x.shape) for x in got]}"
            f" against {[tuple(x.shape) for x in want]}")
    n, far = 0, 0.0
    for a, b in zip(got, want):
        flip = (a > 0) != (b > 0)
        if flip.any():
            n += int(flip.sum().item())
            far = max(far, (a - b).abs()[flip].max().item())
    return n, far


@contextlib.contextmanager
def _patched(obj, name, value):
    before = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, before)


def compare_steps(cfg: Config, weights: Mapping[str, torch.Tensor],
                  sizes: Tuple[int, int, int], train_batch: Batch,
                  test_batch: Batch, seed: int = 11,
                  same_kinks: bool = False) -> dict:
    """The eval and train steps of cfg's kernel gates against the plain
    ones, from `weights` (a model state_dict) on the given batches, which
    lie on the device to run on.  Returns the errors, each side's
    launches and K5's bit-for-bit result (None without a K5 group); with
    `same_kinks`, the plain train step on the kernel step's side of each
    ReLU, and the ReLU inputs that changed sign (`kinks`, `kink_abs`)."""
    device = train_batch.items.device
    cfgs = {"kernel": cfg, "plain": plain_config(cfg)}
    models = {}
    for run, c in cfgs.items():
        models[run] = get_model_class(c.model_type)(c, *sizes,
                                                    device=device)
        models[run].load_state_dict(weights)

    scores, launches = {}, {}
    for run, c in cfgs.items():
        (scores[run], _), launches[f"eval/{run}"] = counted(
            lambda: make_eval_step_fn(c)(models[run], test_batch))

    k5_same: List[bool] = []
    table_grads: Dict[str, Dict[str, torch.Tensor]] = {}
    compact_update = lazy_adam.LazyAdam.compact_update

    def k5_checked(entries):
        want = [(t.clone(), ids, rows) for t, ids, rows in entries]
        ru.scatter_rows_group_reference(want)
        ru.scatter_rows_group(entries)
        k5_same.append(all(torch.equal(t, w) for (t, _, _), (w, _, _)
                           in zip(entries, want)))

    parts, grads, buffers, relus = {}, {}, {}, {}
    for run, c in cfgs.items():
        def taking_grads(self, model, state, gws, *rest):
            table_grads[run] = {k: g.clone() for k, g in gws.items()}
            return compact_update(self, model, state, gws, *rest)

        state = create_train_state(models[run], c)
        step = make_train_step(models[run], c)
        gen = torch.Generator(device=device).manual_seed(seed)
        group = (k5_checked if run == "kernel"
                 else ru.scatter_rows_group_reference)
        relus[run] = (contextlib.nullcontext() if not same_kinks
                      else ReluSides() if run == "kernel"
                      else ReluSides([x > 0 for x in relus["kernel"].inputs]))
        with _patched(lazy_adam, "scatter_rows_group", group), \
                _patched(lazy_adam.LazyAdam, "compact_update",
                         taking_grads), relus[run]:
            (_, parts[run]), launches[f"train/{run}"] = counted(
                lambda: step(state, train_batch, gen))
        grads[run] = {n: p.grad.clone() for n, p in
                      models[run].named_parameters() if p.grad is not None}
        buffers[run] = {n: b.clone() for n, b in
                        models[run].named_buffers()}

    pk, pp = parts["kernel"], parts["plain"]
    loss_rel = max(abs(getattr(pk, f).item() - getattr(pp, f).item())
                   / max(abs(getattr(pp, f).item()), 1e-30)
                   for f in LOSS_FIELDS)
    grad_rel, zero_abs, bad = _max_rel(grads["kernel"], grads["plain"])
    bad += [f"{n} (none on the plain side)"
            for n in grads["kernel"].keys() - grads["plain"].keys()]
    table_rel, _, table_bad = (_max_rel(table_grads["kernel"],
                                        table_grads["plain"])
                               if table_grads else (None, None, []))
    bn_err = max((buffers["kernel"][n] - b).abs().max().item()
                 for n, b in buffers["plain"].items())
    n_kinks, kink_abs = (kinks(relus["kernel"].inputs, relus["plain"].inputs)
                         if same_kinks else (None, None))
    return dict(
        score_err=(scores["kernel"] - scores["plain"]).abs().max().item(),
        loss_rel_err=loss_rel, grad_rel_err=grad_rel,
        zero_grad_abs_err=zero_abs, table_grad_rel_err=table_rel,
        bad_grads=bad + [f"table {n}" for n in table_bad], bn_err=bn_err,
        k5_identical=all(k5_same) if k5_same else None,
        k5_groups=len(k5_same), launches=launches,
        loss=pk.loss.item(), kinks=n_kinks, kink_abs=kink_abs,
        relus=len(relus["kernel"].inputs) if same_kinks else None)


def failures(res: dict) -> List[str]:
    """The gates `res` (from `compare_steps`) misses, in words."""
    out = []
    if not res["score_err"] <= SCORE_TOL:
        out.append(f"eval scores {res['score_err']:.3e} > {SCORE_TOL}")
    if not res["loss_rel_err"] <= LOSS_REL:
        out.append(f"loss parts {res['loss_rel_err']:.3e} > {LOSS_REL}")
    if res["bad_grads"]:
        out.append(f"gradients past 1e-4 of their max abs: "
                   f"{res['bad_grads'][:5]}")
    if not res["bn_err"] <= BN_TOL:
        out.append(f"BN running stats {res['bn_err']:.3e} > {BN_TOL}")
    if res["k5_identical"] is False:
        out.append("K5 differs from its plain version")
    if res.get("kink_abs") is not None and not res["kink_abs"] <= KINK_ABS:
        out.append(f"{res['kinks']} ReLU inputs changed sign, up to "
                   f"{res['kink_abs']:.3e} apart > {KINK_ABS}")
    return out

