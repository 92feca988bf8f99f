"""Shared helpers of the PyTorch port's parity tests, and its import rules.

The helpers build one small CLSR configuration for both packages, the
JAX model's variables (perturbed away from their inits so that biases,
BN affines and running statistics all matter), and numpy batches that
both sides read.  The tests here hold the port to its import rule: no
JAX, flax, optax, orbax or clsr_tpu module, by a subprocess import and by
a scan of the sources.
"""

import ast
import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from clsr_tpu.config import Config as JaxConfig
from clsr_tpu.data.batch import Batch as JaxBatch
from clsr_tpu.models.registry import get_model_class as jax_model_class
from clsr_tpu_torch.config import load_config as port_load_config
from clsr_tpu_torch.data.batch import Batch as PortBatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
N_USERS, N_ITEMS, N_CATES = 9, 23, 5


def small_jax_cfg(**overrides) -> JaxConfig:
    """A CLSR config at test widths (hidden 12 = item 8 + cate 4)."""
    kw = dict(model_type="clsr", user_vocab="u", item_vocab="i",
              cate_vocab="c", max_seq_length=7, hidden_size=12,
              item_embedding_dim=8, cate_embedding_dim=4,
              user_embedding_dim=12, layer_sizes=(10, 6),
              activation=("relu",), att_fcn_layer_sizes=(8, 4), seed=3)
    kw.update(overrides)
    return JaxConfig(**kw).validate()


def port_cfg(jcfg: JaxConfig, **overrides):
    """The port's Config with the same values as a JAX Config."""
    kw = dataclasses.asdict(jcfg)
    kw.update(overrides)
    return port_load_config(None, **kw)


def perturb(tree, rng, scale=0.3):
    """Add N(0, scale) noise to every leaf; keep variances positive."""
    def leaf(path, x):
        x = np.asarray(x, np.float32)
        noise = rng.normal(0.0, scale, x.shape).astype(np.float32)
        if path and path[-1].key == "var":
            return jnp.asarray(np.abs(x + noise) + 0.1)
        return jnp.asarray(x + noise)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def numpy_batch(rng, B, G, L, lengths=None, n_users=N_USERS,
                n_items=N_ITEMS, n_cates=N_CATES):
    """The 11 Batch fields as numpy arrays; lengths default 1..L."""
    if lengths is None:
        lengths = rng.randint(1, L + 1, B)
    mask = (np.arange(L)[None] < np.asarray(lengths)[:, None])
    f32 = np.float32
    return dict(
        users=rng.randint(0, n_users, B).astype(np.int32),
        items=rng.randint(0, n_items, (B, G)).astype(np.int32),
        cates=rng.randint(0, n_cates, (B, G)).astype(np.int32),
        labels=np.zeros((B, G), f32),
        item_hist=(rng.randint(1, n_items, (B, L)) * mask).astype(np.int32),
        cate_hist=(rng.randint(1, n_cates, (B, L)) * mask).astype(np.int32),
        mask=mask.astype(f32),
        time_diff=(rng.randn(B, L) * mask).astype(f32),
        time_from_first=(rng.rand(B, L) * 3 * mask).astype(f32),
        time_to_now=(rng.rand(B, L) * 3 * mask).astype(f32),
        valid=np.ones(B, f32),
    )


def jax_batch(arrays) -> JaxBatch:
    return JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})


def port_batch(arrays) -> PortBatch:
    return PortBatch(**{k: torch.from_numpy(v.copy())
                        for k, v in arrays.items()})


def jax_clsr(jcfg, seed=0, B=2, G=8):
    """(model, perturbed variables) of the JAX CLSR model."""
    model = jax_model_class("clsr")(cfg=jcfg, n_users=N_USERS,
                                    n_items=N_ITEMS, n_cates=N_CATES)
    sample = jax_batch(numpy_batch(np.random.RandomState(seed), B, G,
                                   jcfg.max_seq_length))
    variables = model.init({"params": jax.random.PRNGKey(seed),
                            "dropout": jax.random.PRNGKey(seed + 1)},
                           sample, train=True)
    rng = np.random.RandomState(seed + 7)
    params = perturb(variables["params"], rng)
    stats = perturb(variables.get("batch_stats", {}), rng)
    return model, params, stats


def jax_state(model, params, stats):
    """The bits of a TrainState the JAX eval step reads."""
    return types.SimpleNamespace(apply_fn=model.apply, params=params,
                                 batch_stats=stats)


def to_np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ----------------------------------------------------------- import rules
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "clsr_tpu")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in _FORBIDDEN


def test_port_imports_no_jax_in_a_fresh_process():
    code = ("import sys\n"
            "import clsr_tpu_torch.serving, clsr_tpu_torch.weights\n"
            "import clsr_tpu_torch.training.steps\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{_FORBIDDEN!r})\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port pulled in: {out.stdout}"


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "clsr_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    bad = {p: m for p in paths for m in _imports(p) if _forbidden(m)}
    assert len(paths) > 15
    assert not bad, bad
