"""Per-tensor gradient clipping and the optimizers.

Counterpart of clsr_tpu/training/optimizer.py:153-202 (reference
base_model.py:249-297): the reference clips EACH gradient tensor to
`max_grad_norm` with tf.clip_by_norm (per variable, not global: this is
not `clip_grad_norm_`) before the optimizer applies it.

`build_optimizer` maps the config's name to a rule, as JAX's does
(:174-202):

  * `adam` (and the dense part of `lazyadam`): optax's Adam (b1 0.9,
    b2 0.999, eps 1e-8 outside the square root, bias correction), which
    `torch.optim.Adam` computes too; on CUDA it is built with
    `capturable=True`, so its step counts live on the device;
  * `adadelta`, `adagrad`, `rmsprop`: optax 0.2's defaults and equations,
    which are not `torch.optim`'s (adagrad: accumulator from 0.1 and
    g * rsqrt(acc + 1e-7), eps inside the root; rmsprop: decay 0.9 and
    g * rsqrt(nu + 1e-8); adadelta: rho 0.9, eps 1e-6);
  * `sgd` / `gd`: w - lr * g;
  * `pgd`, `ftrl`, `padagrad`: the TF1 rules of JAX's `proximal_sgd`
    (:129), `ftrl` (:34; power -0.5, initial accumulator 0.1) and
    `proximal_adagrad` (:91), l1 = l2 = 0 as there;
  * any other name: sgd, as :193-194.

The rules other than Adam are `DenseRule`: a `torch.optim.Optimizer`
whose state tensors are made on the parameters' device at the first
step and whose `step` is `torch._foreach_*` arithmetic on them, reading
nothing from the host, so a CUDA graph captures it (training/steps.py).
Each rule computes optax's update u, then the parameter becomes p + u
(`optax.apply_updates`).  optax.flatten (:199) changes no element's
arithmetic.  None of these is a Pallas kernel in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from clsr_tpu_torch.config import Config

DENSE_RULES = ("adadelta", "adagrad", "sgd", "pgd", "rmsprop", "ftrl",
               "padagrad")
INITIAL_ACCUMULATOR = 0.1     # optax adagrad, TF1 ftrl and padagrad
ADAGRAD_EPS, RMSPROP_DECAY, RMSPROP_EPS = 1e-7, 0.9, 1e-8
ADADELTA_RHO, ADADELTA_EPS = 0.9, 1e-6
FTRL_POWER = 0.5              # -learning_rate_power


@torch.no_grad()
def clip_by_norm_each(grads: Iterable[torch.Tensor], max_norm: float,
                      sumsq: Optional[Callable[[torch.Tensor, int],
                                               torch.Tensor]] = None
                      ) -> None:
    """tf.clip_by_norm per tensor, in place: g * max_norm / ||g|| where
    ||g|| > max_norm, else g.  `sumsq(s, i)`, when given, maps the i-th
    tensor's local sum of squares to its whole tensor's (a row-sharded
    table's, summed over the mesh's model row; JAX :153 gets it from
    GSPMD)."""
    for i, g in enumerate(grads):
        if sumsq is None:
            norm = torch.linalg.vector_norm(g)
        else:
            norm = torch.sqrt(sumsq((g.float() * g.float()).sum(), i))
        g.mul_(torch.where(norm > max_norm, max_norm / norm,
                           torch.ones_like(norm)))


def rule_name(name: str) -> str:
    """The rule a config's optimizer name runs: adam for adam and
    lazyadam's dense part, a DENSE_RULES name as it is, sgd for gd and
    for every other name."""
    if name in ("adam", "lazyadam"):
        return "adam"
    return name if name in DENSE_RULES else "sgd"


class DenseRule(torch.optim.Optimizer):
    """One of optax's (or JAX's TF1) rules over every parameter given;
    `rule` is its name (`rule_name`)."""

    def __init__(self, params, rule: str, lr: float):
        if rule not in DENSE_RULES:
            raise ValueError(f"no dense rule {rule}")
        self.rule = rule
        super().__init__(params, dict(lr=lr))

    def _init_state(self, p: torch.Tensor) -> dict:
        """The rule's state tensors for parameter p, on its device (sgd
        and pgd keep none)."""
        zeros = lambda: torch.zeros_like(p,
                                         memory_format=torch.contiguous_format)
        acc = lambda: torch.full_like(p, INITIAL_ACCUMULATOR,
                                      memory_format=torch.contiguous_format)
        return {"adadelta": lambda: dict(e_g=zeros(), e_x=zeros()),
                "adagrad": lambda: dict(acc=acc()),
                "rmsprop": lambda: dict(nu=zeros()),
                "ftrl": lambda: dict(z=zeros(), n=acc()),
                "padagrad": lambda: dict(acc=acc())}.get(self.rule, dict)()

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("DenseRule.step takes no closure")
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            for p in ps:
                if not self.state[p]:
                    self.state[p] = self._init_state(p)
            gs = [p.grad for p in ps]
            st = lambda key: [self.state[p][key] for p in ps]
            torch._foreach_add_(ps, self._updates(ps, gs, st, group["lr"]))

    def _updates(self, ps, gs, st, lr):
        """optax's updates u (the parameters then become p + u)."""
        rule = self.rule
        if rule == "sgd":
            return torch._foreach_mul(gs, -lr)
        if rule == "adagrad":
            # optax scale_by_rss: acc += g^2; g * where(acc > 0,
            # rsqrt(acc + eps), 0)
            acc = st("acc")
            torch._foreach_add_(acc, torch._foreach_mul(gs, gs))
            scale = [torch.where(a > 0, torch.rsqrt(a + ADAGRAD_EPS),
                                 torch.zeros_like(a)) for a in acc]
            return torch._foreach_mul(torch._foreach_mul(scale, gs), -lr)
        if rule == "rmsprop":
            # optax scale_by_rms: nu = (1 - d) g^2 + d nu; g * rsqrt(nu + eps)
            nu = st("nu")
            _ema_(nu, torch._foreach_mul(gs, gs), RMSPROP_DECAY)
            scale = torch._foreach_rsqrt(torch._foreach_add(nu, RMSPROP_EPS))
            return torch._foreach_mul(torch._foreach_mul(scale, gs), -lr)
        if rule == "adadelta":
            # optax scale_by_adadelta: e_g = EMA g^2; u = sqrt(e_x + eps)
            # / sqrt(e_g + eps) * g; e_x = EMA u^2
            e_g, e_x = st("e_g"), st("e_x")
            _ema_(e_g, torch._foreach_mul(gs, gs), ADADELTA_RHO)
            u = torch._foreach_mul(torch._foreach_div(
                torch._foreach_sqrt(torch._foreach_add(e_x, ADADELTA_EPS)),
                torch._foreach_sqrt(torch._foreach_add(e_g, ADADELTA_EPS))),
                gs)
            _ema_(e_x, torch._foreach_mul(u, u), ADADELTA_RHO)
            return torch._foreach_mul(u, -lr)
        if rule == "pgd":
            # proximal_sgd, l1 = l2 = 0: w' = sign(prox) max(|prox|, 0)
            return torch._foreach_sub(_prox(torch._foreach_sub(
                ps, torch._foreach_mul(gs, lr))), ps)
        if rule == "padagrad":
            # proximal_adagrad: acc += g^2; lr_t = lr / sqrt(acc);
            # prox = w - lr_t g
            acc = st("acc")
            torch._foreach_add_(acc, torch._foreach_mul(gs, gs))
            lr_t = torch._foreach_div([torch.full_like(a, lr) for a in acc],
                                      torch._foreach_sqrt(acc))
            return torch._foreach_sub(_prox(torch._foreach_sub(
                ps, torch._foreach_mul(lr_t, gs))), ps)
        # ftrl, TF1 semantics with l1 = l2 = beta = 0 (JAX :34-88):
        # n' = n + g^2; sigma = (n'^p - n^p) / lr; z' = z + g - sigma w;
        # w' = where(|z'| > 0, -z' / (n'^p / lr), 0)
        z, n = st("z"), st("n")
        n_new = torch._foreach_add(n, torch._foreach_mul(gs, gs))
        pn_new = torch._foreach_pow(n_new, FTRL_POWER)
        sigma = torch._foreach_div(
            torch._foreach_sub(pn_new, torch._foreach_pow(n, FTRL_POWER)),
            lr)
        torch._foreach_add_(z, gs)
        torch._foreach_sub_(z, torch._foreach_mul(sigma, ps))
        torch._foreach_copy_(n, n_new)
        denom = torch._foreach_div(pn_new, lr)
        w_new = [torch.where(zi.abs() > 0.0, -zi / d, torch.zeros_like(zi))
                 for zi, d in zip(z, denom)]
        return torch._foreach_sub(w_new, ps)


def _ema_(moments, values, decay: float) -> None:
    """optax's update_moment, in place: (1 - decay) * v + decay * m."""
    new = torch._foreach_add(torch._foreach_mul(values, 1.0 - decay),
                             torch._foreach_mul(moments, decay))
    torch._foreach_copy_(moments, new)


def _prox(prox):
    """sign(prox) * max(|prox| - 0, 0) / (1 + 0), the TF1 proximal step
    with l1 = l2 = 0."""
    return torch._foreach_mul(
        torch._foreach_sign(prox),
        torch._foreach_maximum(torch._foreach_abs(prox), 0.0))


def build_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """The config's dense optimizer over the parameters given (for
    lazyadam, Adam over the non-table parameters): Adam with optax's
    defaults, capturable when they lie on CUDA, or a `DenseRule`."""
    params = list(params)
    rule = rule_name(cfg.optimizer)
    if rule != "adam":
        return DenseRule(params, rule, cfg.learning_rate)
    cuda = any(p.device.type == "cuda" for p in params)
    return torch.optim.Adam(params, lr=cfg.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8, foreach=True,
                            capturable=cuda)
