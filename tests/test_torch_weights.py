"""weights.from_flax: every flax name is consumed, none is missing.

The flax trees of the JAX CLSR model load into the port's modules one
name to one; a tree with a name too many or too few, or a wrong shape,
raises.  Dense kernels arrive transposed into nn.Linear weights.
"""

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from clsr_tpu_torch import weights
from clsr_tpu_torch.models.registry import get_model_class

from test_torch_common import (N_CATES, N_ITEMS, N_USERS, jax_clsr,
                               port_cfg, small_jax_cfg)


@pytest.fixture(scope="module")
def loaded():
    jcfg = small_jax_cfg()
    _, params, stats = jax_clsr(jcfg)
    model = get_model_class("clsr")(port_cfg(jcfg), N_USERS, N_ITEMS,
                                    N_CATES, device="cpu")
    weights.from_flax(model, params, stats)
    return model, params, stats


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def test_every_flax_name_maps_to_one_port_tensor(loaded):
    model, params, stats = loaded
    mapping = weights.flax_names(model)
    flax = {("params", k) for k in _flat(params)} | \
        {("batch_stats", k) for k in _flat(stats)}
    ported = {(c, f) for c, f, _ in mapping.values()}
    assert ported == flax
    assert len(mapping) == len(flax)


def test_values_land_where_they_belong(loaded):
    model, params, stats = loaded
    p, s = _flat(params), _flat(stats)
    state = model.state_dict()
    np.testing.assert_array_equal(state["item_embedding"].numpy(),
                                  p["item_embedding"])
    np.testing.assert_array_equal(       # nn.Linear: weight = kernel.T
        state["fcn_alpha.w_nn_layer1.weight"].numpy(),
        p["fcn_alpha/w_nn_layer1/kernel"].T)
    np.testing.assert_array_equal(       # split first layer keeps [4D, H]
        state["short_term_att.att_fcn.w_nn_layer0.kernel"].numpy(),
        p["short_term_att/att_fcn/w_nn_layer0/kernel"])
    np.testing.assert_array_equal(
        state["logit_fcn.bn0.var"].numpy(), s["logit_fcn/bn0/var"])


def test_left_over_missing_and_misshaped_names_raise(loaded):
    model, params, stats = loaded
    p, s = _flat(params), _flat(stats)
    extra = dict(p, **{"fused_encoders/unused": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="left over.*fused_encoders/unused"):
        weights.from_flax(model, extra, s)
    short = {k: v for k, v in p.items() if k != "cate_embedding"}
    with pytest.raises(ValueError, match="missing.*cate_embedding"):
        weights.from_flax(model, short, s)
    with pytest.raises(ValueError, match="missing.*batch_stats"):
        weights.from_flax(model, p, {})
    bad = dict(p, cate_embedding=np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="shape"):
        weights.from_flax(model, bad, s)


def test_flattened_and_nested_trees_load_alike(loaded):
    model, params, stats = loaded
    before = {k: v.clone() for k, v in model.state_dict().items()}
    weights.from_flax(model, _flat(params), _flat(stats))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_save_load_round_trip(loaded, tmp_path):
    model, _, _ = loaded
    path = str(tmp_path / "w.pt")
    weights.save(model, path)
    fresh = get_model_class("clsr")(model.cfg, N_USERS, N_ITEMS, N_CATES,
                                    device="cpu")
    weights.load(fresh, path)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, model.state_dict()[k], rtol=0, atol=0)
