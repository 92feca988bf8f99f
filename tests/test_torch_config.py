"""The masked-statistics and length-bucket settings load as in JAX.

The JAX package switches the attention scorers' BN to statistics over
real history positions (`bn_stats_mask_active`, clsr_tpu/models/base.py:
40-48) for `bn_stats_mask: on` and for any `length_buckets` but `off`
under `bn_stats_mask: auto`.  The port has that BN (`MaskedBatchNorm`)
and length buckets, so each such setting loads, from YAML and from
keyword overrides, with the values given, and the port's
`bn_stats_mask_active` resolves it as JAX's does.  (These cases were
refusals while the port had neither; the settings are the same.)
"""

import pytest

from clsr_tpu.models.base import bn_stats_mask_active
from clsr_tpu_torch.config import load_config
from clsr_tpu_torch.models.base import \
    bn_stats_mask_active as port_bn_stats_mask_active

from test_torch_common import small_jax_cfg

BASE = dict(user_vocab="u", item_vocab="i", cate_vocab="c")

REFUSED = [  # (settings, JAX's bn_stats_mask_active for them)
    (dict(bn_stats_mask="on"), True),
    (dict(length_buckets="auto"), True),
    (dict(length_buckets="3"), True),
    (dict(bn_stats_mask="on", length_buckets="2,4"), True),
    # buckets without masked statistics: unmasked in JAX and here
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
    """(The name is from when these settings raised.)  Each loads with
    its values, and the port resolves it as JAX does."""
    assert bn_stats_mask_active(small_jax_cfg(**settings)) is jax_masked
    if source == "yaml":
        cfg = load_config(_yaml(tmp_path, settings))
    else:
        cfg = load_config(None, **BASE, **settings)
    for k, v in settings.items():
        assert getattr(cfg, k) == v, k
    assert port_bn_stats_mask_active(cfg) is jax_masked


@pytest.mark.parametrize("settings", LOADED, ids=lambda v: ",".join(
    f"{k}={x}" for k, x in v.items()) or "defaults")
def test_unmasked_bn_settings_load(tmp_path, settings):
    assert not bn_stats_mask_active(small_jax_cfg(**settings))
    for cfg in (load_config(_yaml(tmp_path, settings)),
                load_config(None, **BASE, **settings)):
        assert cfg.enable_bn and not port_bn_stats_mask_active(cfg)


def test_unquoted_yaml_on_and_off():
    """YAML reads on/off unquoted as booleans; they mean the same."""
    cfg = load_config(None, **BASE, bn_stats_mask=True)
    assert cfg.bn_stats_mask == "on" and port_bn_stats_mask_active(cfg)
    cfg = load_config(None, **BASE, bn_stats_mask=False,
                      length_buckets=False)
    assert (cfg.bn_stats_mask, cfg.length_buckets) == ("off", "off")
    with pytest.raises(ValueError, match="auto/on/off"):
        load_config(None, **BASE, bn_stats_mask="maybe")


@pytest.mark.parametrize("kw, match", [
    (dict(length_buckets="8,4"), "strictly ascending"),
    (dict(length_buckets="7"), "strictly ascending"),
    (dict(length_buckets="x"), "comma-separated"),
    (dict(length_buckets="auto", autosave_every_calls=2, model_dir="m"),
     "not supported with length_buckets")])
def test_bucket_settings_validate_as_jax(kw, match):
    """Bad edges (max_seq_length 7 here) and buckets with autosave raise
    the ValueError JAX's validation raises."""
    with pytest.raises(ValueError, match=match):
        small_jax_cfg(**kw)
    with pytest.raises(ValueError, match=match):
        load_config(None, **BASE, max_seq_length=7, **kw)
