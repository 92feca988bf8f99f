"""Parameter initializers matching the reference's TF1 choices.

Counterpart of clsr_tpu/ops/initializers.py (reference `_get_initializer`,
base_model.py:161-189): `init_method` picks the initializer of the
embeddings, MLPs and attention matrices; recurrent kernels use TF1's
scope default, glorot uniform, which `tf.get_variable` also applies to
rank-1 shapes (fan_in = fan_out = shape[0]).

Every initializer fills a tensor in place from an explicit
`torch.Generator`, with the tensor in the flax layout ([in, out] for a
kernel).  Seeds give other numbers than JAX's: tests that compare the
two carry the weights over with `weights.from_flax`.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

# std of a unit normal truncated to [-2, 2]; JAX's variance scaling
# divides by it so the truncated draw has the requested variance
_TRUNC_STD = 0.87962566103423978

Initializer = Callable[[torch.Tensor, torch.Generator], torch.Tensor]


def _fans(shape) -> "tuple[int, int]":
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


@torch.no_grad()
def truncated_normal_(t: torch.Tensor, stddev: float,
                      generator: torch.Generator) -> torch.Tensor:
    """jax.nn.initializers.truncated_normal(stddev): N(0, stddev) cut at
    two stddev (the kept draws' std is 0.88 stddev)."""
    return torch.nn.init.trunc_normal_(t, 0.0, stddev, -2.0 * stddev,
                                       2.0 * stddev, generator=generator)


def _variance_scaling(scale: float, mode: str, distribution: str
                      ) -> Initializer:
    @torch.no_grad()
    def init(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        fan_in, fan_out = _fans(tuple(t.shape))
        denom = {"fan_in": fan_in, "fan_avg": (fan_in + fan_out) / 2}[mode]
        var = scale / denom
        if distribution == "uniform":
            lim = math.sqrt(3.0 * var)
            return torch.nn.init.uniform_(t, -lim, lim, generator=generator)
        return truncated_normal_(t, math.sqrt(var) / _TRUNC_STD, generator)
    return init


@torch.no_grad()
def tf1_glorot_uniform(t: torch.Tensor,
                       generator: torch.Generator) -> torch.Tensor:
    """Glorot uniform that also takes rank-1 shapes, like TF1's default."""
    fan_in, fan_out = _fans(tuple(t.shape))
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.nn.init.uniform_(t, -lim, lim, generator=generator)


# flax's nn.Conv / nn.Dense default kernel initializer
lecun_normal = _variance_scaling(1.0, "fan_in", "truncated_normal")


def truncated_normal(stddev: float) -> Initializer:
    """jax.nn.initializers.truncated_normal(stddev) as an Initializer."""
    return lambda t, g: truncated_normal_(t, stddev, g)


def normal(stddev: float) -> Initializer:
    """jax.nn.initializers.normal(stddev): N(0, stddev), not truncated."""
    return lambda t, g: torch.nn.init.normal_(t, 0.0, stddev, generator=g)


def get_initializer(init_method: str, init_value: float) -> Initializer:
    """Map config init_method to an in-place initializer."""
    if init_method == "uniform":
        return lambda t, g: torch.nn.init.uniform_(
            t, -init_value, init_value, generator=g)
    if init_method == "normal":
        return normal(init_value)
    if init_method == "xavier_normal":
        return _variance_scaling(1.0, "fan_avg", "truncated_normal")
    if init_method == "xavier_uniform":
        return tf1_glorot_uniform
    if init_method == "he_normal":
        return _variance_scaling(2.0, "fan_in", "truncated_normal")
    if init_method == "he_uniform":
        return _variance_scaling(2.0, "fan_in", "uniform")
    # 'tnormal' and anything unknown, as the reference falls back
    return truncated_normal(init_value)


def new_param(shape, init: Initializer, generator: torch.Generator,
              device: torch.device) -> torch.nn.Parameter:
    """A float32 parameter of `shape` on `device`, filled by `init`."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return torch.nn.Parameter(init(t, generator))


def zeros_init(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return t.zero_()


def ones_init(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return t.fill_(1.0)
