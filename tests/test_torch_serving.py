"""The port's ScoringService against the JAX ScoringService.

Both services are built on the same small config and vocabs; the JAX one
with `checkpoint=None` (its seeded random init), whose params and
batch_stats are perturbed and then carried into the port.  Served scores
must agree to 1e-5 across candidate buckets.  Also: bucket routing, the
oversized-request error, AsyncScoringService coalescing, save/load of the
port's weights, and the device rule.
"""

import threading

import numpy as np
import pytest
import torch

from clsr_tpu.data.vocab import Vocab as JaxVocab
from clsr_tpu.serving import ScoreRequest as JaxRequest
from clsr_tpu.serving import ScoringService as JaxService
from clsr_tpu_torch import weights
from clsr_tpu_torch.data.vocab import Vocab
from clsr_tpu_torch.serving import (AsyncScoringService, ScoreRequest,
                                    ScoringService)

from test_torch_common import TOL, perturb, port_cfg, small_jax_cfg

N_ITEMS, N_CATES, N_USERS = 30, 6, 10
_MAPS = ({f"u{i}": i for i in range(N_USERS)},
         {f"i{i}": i for i in range(N_ITEMS)},
         {f"c{i}": i for i in range(N_CATES)})


def _req(cls, rng, n_hist, n_cands, user=None, t0=1_500_600_000):
    hist = rng.randint(1, N_ITEMS + 5, n_hist)       # some OOV items
    cands = rng.randint(1, N_ITEMS, n_cands)
    return cls(
        user=user or f"u{rng.randint(0, N_USERS)}",
        hist_items=[f"i{i}" for i in hist],
        hist_cates=[f"c{i % N_CATES}" for i in hist],
        hist_times=sorted(t0 - rng.randint(60, 10 ** 6, n_hist)),
        current_time=t0,
        cand_items=[f"i{c}" for c in cands],
        cand_cates=[f"c{c % N_CATES}" for c in cands])


@pytest.fixture(scope="module")
def services():
    jcfg = small_jax_cfg(seed=11)
    kw = dict(batch_buckets=(2, 4), cand_buckets=(8, 16))
    jsvc = JaxService(jcfg, N_USERS, N_ITEMS, N_CATES,
                      *(JaxVocab(m) for m in _MAPS), **kw)
    rng = np.random.RandomState(0)
    params = perturb(jsvc.state.params, rng)
    stats = perturb(jsvc.state.batch_stats, rng)
    jsvc.state = jsvc.state.replace(params=params, batch_stats=stats)
    psvc = ScoringService(port_cfg(jcfg), N_USERS, N_ITEMS, N_CATES,
                          *(Vocab(m) for m in _MAPS), device="cpu", **kw)
    weights.from_flax(psvc.model, params, stats)
    return jsvc, psvc


def _requests(seed, spec):
    return ([_req(JaxRequest, np.random.RandomState(seed + i), h, c)
             for i, (h, c) in enumerate(spec)],
            [_req(ScoreRequest, np.random.RandomState(seed + i), h, c)
             for i, (h, c) in enumerate(spec)])


def test_scores_match_jax_service(services):
    jsvc, psvc = services
    # (history length, candidates): both buckets, histories longer than
    # L, full batches and a chunk that spills into a second dispatch
    spec = [(3, 5), (12, 9), (1, 16), (7, 8), (2, 1), (9, 12), (4, 3)]
    jreqs, preqs = _requests(5, spec)
    want = jsvc.score(jreqs)
    got = psvc.score(preqs)
    assert [len(s) for s in got] == [c for _, c in spec]
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and (g >= 0).all() and (g <= 1).all()
        np.testing.assert_allclose(g, w, **TOL)


def test_bucket_routing_and_oversized_request(services):
    _, psvc = services
    assert [psvc._bucket(psvc.cand_buckets, n) for n in (1, 8, 9, 16)] \
        == [8, 8, 16, 16]
    assert [psvc._bucket(psvc.batch_buckets, n) for n in (1, 3, 4, 9)] \
        == [2, 4, 4, 4]
    _, (big,) = _requests(1, [(3, 17)])
    with pytest.raises(ValueError, match="exceeds the largest bucket 16"):
        psvc.score([big])


def test_async_service_coalesces_and_matches(services):
    _, psvc = services
    _, preqs = _requests(9, [(4, 6)] * 6)
    want = psvc.score(preqs)
    asvc = AsyncScoringService(psvc, max_wait_ms=200.0)
    try:
        futs = []
        threads = [threading.Thread(
            target=lambda r=r: futs.append(asvc.submit(r)))
            for r in preqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        got = [f.result(timeout=60) for f in futs]
        assert asvc.dispatches < len(preqs)      # requests shared dispatches
        assert sorted(map(tuple, got)) == sorted(map(tuple, want))
        with pytest.raises(ValueError):
            asvc.score([_requests(1, [(3, 17)])[1][0]])
    finally:
        asvc.close()
    assert not asvc._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        asvc.submit(preqs[0])


def test_save_load_round_trip(services, tmp_path):
    _, psvc = services
    path = str(tmp_path / "svc.pt")
    psvc.save(path)
    other = ScoringService(psvc.cfg, N_USERS, N_ITEMS, N_CATES,
                           *psvc.vocabs, checkpoint=path, device="cpu",
                           batch_buckets=(2, 4), cand_buckets=(8, 16))
    _, preqs = _requests(3, [(5, 7), (2, 11)])
    for a, b in zip(other.score(preqs), psvc.score(preqs)):
        np.testing.assert_array_equal(a, b)


def test_device_rule_and_unported_options(services):
    _, psvc = services
    args = (psvc.cfg, N_USERS, N_ITEMS, N_CATES) + psvc.vocabs
    # int8 tables are ported: the tables and their scales are quantized
    q = ScoringService(*args, int8_tables=True, device="cpu")
    assert q.model.item_embedding.dtype == torch.int8
    assert q.model.item_embedding_scales.shape == (N_ITEMS, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ScoringService(*args)
