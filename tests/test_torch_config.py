"""Settings the port cannot run must not load.

The JAX package switches the attention scorers' BN to statistics over
real history positions (`bn_stats_mask_active`, clsr_tpu/models/base.py:
40-48) for `bn_stats_mask: on` and for any `length_buckets` but `off`
under `bn_stats_mask: auto`.  The port has neither that BN nor length
buckets, so `load_config` raises NotImplementedError for each such value,
whether it comes from YAML or from keyword overrides, instead of dropping
the keys and training other math.  `auto` and `off` with buckets off
load, as JAX resolves them to unmasked statistics.
"""

import pytest

from clsr_tpu.models.base import bn_stats_mask_active
from clsr_tpu_torch.config import load_config

from test_torch_common import small_jax_cfg

BASE = dict(user_vocab="u", item_vocab="i", cate_vocab="c")

REFUSED = [  # (settings, JAX's bn_stats_mask_active for them)
    (dict(bn_stats_mask="on"), True),
    (dict(length_buckets="auto"), True),
    (dict(length_buckets="3"), True),
    (dict(bn_stats_mask="on", length_buckets="2,4"), True),
    # buckets without masked statistics: unmasked in JAX, but the port
    # has no length buckets either
    (dict(bn_stats_mask="off", length_buckets="3"), False),
]
LOADED = [dict(), dict(bn_stats_mask="auto"), dict(bn_stats_mask="off"),
          dict(bn_stats_mask="auto", length_buckets="off")]


def _yaml(tmp_path, settings):
    path = tmp_path / "cfg.yaml"
    lines = ["data:"] + [f"  {k}: {v}" for k, v in BASE.items()]
    lines += ["train:"] + [f'  {k}: "{v}"' for k, v in settings.items()]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("source", ["overrides", "yaml"])
@pytest.mark.parametrize("settings, jax_masked", REFUSED,
                         ids=lambda v: ",".join(f"{k}={x}" for k, x in
                                                v.items())
                         if isinstance(v, dict) else str(v))
def test_masked_bn_settings_raise(tmp_path, source, settings, jax_masked):
    assert bn_stats_mask_active(small_jax_cfg(**settings)) is jax_masked
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 5"):
        if source == "yaml":
            load_config(_yaml(tmp_path, settings))
        else:
            load_config(None, **BASE, **settings)


@pytest.mark.parametrize("settings", LOADED, ids=lambda v: ",".join(
    f"{k}={x}" for k, x in v.items()) or "defaults")
def test_unmasked_bn_settings_load(tmp_path, settings):
    assert not bn_stats_mask_active(small_jax_cfg(**settings))
    assert load_config(_yaml(tmp_path, settings)).enable_bn
    assert load_config(None, **BASE, **settings).enable_bn


def test_unquoted_yaml_on_and_off():
    """YAML reads on/off unquoted as booleans; they mean the same."""
    with pytest.raises(NotImplementedError, match="bn_stats_mask"):
        load_config(None, **BASE, bn_stats_mask=True)
    load_config(None, **BASE, bn_stats_mask=False, length_buckets=False)
    with pytest.raises(ValueError, match="auto/on/off"):
        load_config(None, **BASE, bn_stats_mask="maybe")
