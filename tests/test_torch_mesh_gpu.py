"""Graphed mesh steps over NCCL on four cards (marked `gpu`; skips below
four CUDA devices).

    python -m pytest tests/test_torch_mesh_gpu.py -m gpu --noconftest -q

A 4-rank NCCL world at (2, 2), a card a rank (parallel/distributed.py
`run_local_world`; the rank side is tests/torch_mesh_worker.py
`graphed_world`), runs clsr.yaml's widths at small tables, B = 64, L =
20, with every kernel gate on, from one seeded state: 8 steps eagerly (K
= 1) and as calls of K = 4 (training/steps.py `MultiTrainStep`: a warm-up
step, then the captured step replayed), for lazyadam with the broadcast
merge (flat batch), dense Adam with a replicated batch (the static
`reduce_grads`), and the owner merge under `fallback` at a capacity where
the tables' branch patterns differ (head graph, one read, a tail graph a
pattern).  Every loss part and state tensor bit for bit; the graphed run
launches K1, K2, K2's backward, K3a, K3b and (lazyadam) K5; the
collectives the graphed calls count equal the eager steps' call for
call; the branch patterns read equal.  Then a step with a host sync
inside: its capture raises, and nothing falls back to eager steps.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from clsr_tpu_torch.config import CONFIG_DIR, load_config
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.parallel.distributed import run_local_world

import torch_mesh_worker

pytestmark = pytest.mark.gpu

SIZES = (512, 4_000, 200)           # every table divides m = 2
B, L, K, STEPS = 64, 20, 4, 8
MESH = dict(data_parallel=2, model_parallel=2)
CASES = {
    "broadcast": dict(optimizer="lazyadam"),
    "dense_replicated": dict(optimizer="adam", mesh_flat_batch="off"),
    # a rank's 16 users go to 2 owners of C = 10 slots each: some steps
    # overflow on the user tables, none on the item table (C = 250)
    "owner_mixed": dict(optimizer="lazyadam", mesh_update_routing="owner",
                        mesh_owner_capacity=1.25),
}
KERNELS = ("eval_scorer", "clsr_scan", "clsr_scan_backward",
           "train_stats0", "train_stats1")


def _cfg():
    return dict(dataclasses.asdict(load_config(
        os.path.join(CONFIG_DIR, "clsr.yaml"), user_vocab="u",
        item_vocab="i", cate_vocab="c", seed=5, batch_size=B,
        max_seq_length=L, use_pallas_scan=True,
        use_pallas_train_attention="on", **MESH)))


def _batches():
    rng = np.random.RandomState(22)
    out = []
    for _ in range(STEPS):
        mask = (np.arange(L)[None] < rng.randint(1, L + 1, B)[:, None])
        mask = mask.astype(np.float32)
        hist = lambda n: (rng.randint(1, n, (B, L)) * mask).astype(np.int32)
        out.append(dict(
            users=rng.randint(0, SIZES[0], B).astype(np.int32),
            items=rng.randint(1, SIZES[1], (B, 1)).astype(np.int32),
            cates=rng.randint(1, SIZES[2], (B, 1)).astype(np.int32),
            labels=np.ones((B, 1), np.float32), item_hist=hist(SIZES[1]),
            cate_hist=hist(SIZES[2]), mask=mask,
            time_diff=(rng.rand(B, L) * mask).astype(np.float32),
            time_from_first=(rng.rand(B, L) * mask).astype(np.float32),
            time_to_now=(rng.rand(B, L) * mask).astype(np.float32),
            valid=np.ones(B, np.float32)))
    return out


@pytest.fixture(scope="module")
def ranks():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices: NCCL takes a card a rank")
    from clsr_tpu_torch.ops import _build
    _build.build(_build.KERNELS)            # once, before the ranks
    cfg = _cfg()
    model = get_model_class("clsr")(load_config(None, **cfg), *SIZES,
                                    device="cpu")
    spec = dict(cfg=cfg, cases=CASES, sizes=SIZES, K=K, batches=_batches(),
                state_dict={k: v.numpy().copy()
                            for k, v in model.state_dict().items()})
    return run_local_world(torch_mesh_worker.graphed_world, 4, "nccl",
                           "cuda", (spec,), 600.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_nccl_steps_equal_eager_steps(ranks, case):
    for r in ranks:
        eager, graphed = r[case]
        assert graphed["stats"] is not None     # captured and replayed
        assert graphed["rows"] == eager["rows"]
        assert eager["state"].keys() == graphed["state"].keys()
        for k, v in eager["state"].items():
            np.testing.assert_array_equal(graphed["state"][k], v, err_msg=k)
        assert graphed["calls"] == eager["calls"]
        assert graphed["patterns"] == eager["patterns"]
        want = KERNELS + (("row_scatter",) if case != "dense_replicated"
                          else ())
        assert all(graphed["launches"].get(k) for k in want), \
            graphed["launches"]
        assert graphed["launches"] == eager["launches"]
    if case == "owner_mixed":
        patterns = ranks[0][case][0]["patterns"]
        assert len(patterns) == STEPS
        assert any(set(p) == {False, True} for p in patterns), patterns


def test_failed_nccl_capture_raises(ranks):
    for r in ranks:
        assert r["failed_capture"] is not None
        assert "capturing the train step in a CUDA graph failed" in \
            r["failed_capture"]
