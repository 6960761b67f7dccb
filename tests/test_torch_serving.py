"""The port's serving front ends on the CPU: the bucket ladder against the
JAX package's, ``ServingEngine`` answers against ``recommend_topk`` (the
port's, exactly, and the JAX package's, chunk by chunk), the
``serve_compiles_total == len(buckets)`` invariant, hot refresh, and the
``RecommendService`` / ``FitResult.to_service`` / ``FitResult.to_engine``
bridges.

Every engine is built in a ``with`` block so its worker thread joins, and
every ``future.result`` has a timeout.  Tolerances are as in
``test_torch_quant.py``: fused int8 scores bitwise, float paths rtol=1e-5,
items on rows with no ties among their top k+1 scores.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import quant as jq  # noqa: E402
from repro.serve import recommend as jrec  # noqa: E402
from repro.serving import BucketLadder as JLadder  # noqa: E402
from repro_torch import mc as tmc  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.config import GossipMCConfig  # noqa: E402
from repro_torch.convert import index_from_numpy  # noqa: E402
from repro_torch.data import lowrank_problem  # noqa: E402
from repro_torch.serve import quant as tq  # noqa: E402
from repro_torch.serve import recommend as trec  # noqa: E402
from repro_torch.serving import (DEFAULT_BUCKETS, BucketLadder,  # noqa: E402
                                 ServingEngine)
from repro_torch.serving.engine import _pad_seen  # noqa: E402

torch.set_num_threads(2)

BUCKETS = (8, 32)
TIMEOUT = 60


def _arrays(m, n, r, seed, seen_per_user=4):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(m, r)).astype(np.float32)
    w = rng.normal(size=(n, r)).astype(np.float32)
    seen = np.full((m, 16), n, np.int32)
    seen[:, :seen_per_user] = rng.integers(0, n, size=(m, seen_per_user))
    return u, w, seen


def _index(m, n, r, seed, seen_per_user=4):
    return index_from_numpy(*_arrays(m, n, r, seed, seen_per_user), "cpu")


def _by_chunks(ladder, users, k, query):
    """What the engine must answer: ``query`` on each padded chunk."""

    items = np.empty((len(users), k), np.int32)
    scores = np.empty((len(users), k), np.float32)
    for start, length, bucket in ladder.plan(len(users)):
        chunk = np.pad(users[start:start + length], (0, bucket - length))
        a, b = query(chunk)
        items[start:start + length] = np.asarray(a)[:length]
        scores[start:start + length] = np.asarray(b)[:length]
    return items, scores


def test_ladder_equals_jax_ladder():
    for sizes in (DEFAULT_BUCKETS, BUCKETS, (5,)):
        t, j = BucketLadder(sizes), JLadder(sizes)
        assert t.sizes == j.sizes and t.max_size == j.max_size
        for n in range(1, 3 * t.max_size + 2):
            assert t.plan(n) == j.plan(n)
            if n <= t.max_size:
                assert t.bucket_for(n) == j.bucket_for(n)
    for bad in ((), (0, 4), (8, 8), (16, 8)):
        with pytest.raises(ValueError):
            BucketLadder(bad)
    with pytest.raises(ValueError, match="exceeds the top bucket"):
        BucketLadder(BUCKETS).bucket_for(33)


@pytest.mark.parametrize("quant,method", [(None, None), ("int8", "fused"),
                                          ("int8", "dequant")])
def test_engine_equals_recommend_topk_every_size(quant, method):
    idx = _index(200, 500, 12, seed=6)
    obs.reset()
    k = 10
    with ServingEngine(idx, buckets=BUCKETS, k=k, quant=quant,
                       quant_method=method) as eng:
        assert eng.quant == quant and eng.quant_method == method
        assert obs.counter("serve_compiles_total").value == len(BUCKETS)
        bufs = eng._bufs
        assert bufs.seen.shape[1] == 16 + 64          # seen_headroom
        rng = np.random.default_rng(0)
        sizes = range(1, 2 * BUCKETS[-1] + 2)
        requests = [rng.integers(0, 200, n).astype(np.int32) for n in sizes]
        futures = [eng.submit(u) for u in requests]
        for users, fut in zip(requests, futures):
            items, scores = fut.result(timeout=TIMEOUT)
            want = _by_chunks(eng.ladder, users, k, lambda c: trec.
                              recommend_topk(bufs, c, k=k, method=method))
            np.testing.assert_array_equal(items, want[0])
            np.testing.assert_array_equal(scores, want[1])
        assert obs.counter("serve_compiles_total").value == len(BUCKETS)
        assert obs.counter("serve_bucket_compiles_total",
                           bucket="32").value == 1
        m = eng.metrics()
        assert m["requests"] == len(requests) and m["compiles"] == 2
        assert m["buckets"][32]["count"] > 0 and m["queue_depth"] == 0


def test_int8_engine_matches_jax_recommend_topk():
    u, w, seen = _arrays(150, 300, 15, seed=7)
    jqi = jq.quantize_index(jrec.RecommendIndex(
        jnp.asarray(u), jnp.asarray(w), jnp.asarray(seen)))
    k = 12
    with ServingEngine(index_from_numpy(u, w, seen, "cpu"), buckets=BUCKETS,
                       k=k, quant="int8", quant_method="fused") as eng:
        for n in (1, 8, 9, 32, 33, 70):
            users = np.random.default_rng(n).integers(0, 150, n
                                                      ).astype(np.int32)
            items, scores = eng.recommend(users)
            ji, js = _by_chunks(eng.ladder, users, k + 1, lambda c: jrec.
                                recommend_topk(jqi, jnp.asarray(c), k=k + 1,
                                               method="fused"))
            np.testing.assert_array_equal(scores, js[:, :k])
            tie_free = (np.diff(js, axis=1) != 0).all(axis=1)
            assert tie_free.sum() > n // 2
            np.testing.assert_array_equal(items[tie_free], ji[tie_free, :k])


def test_engine_refresh_requantizes_and_guards_layouts():
    idx_a, idx_b = _index(80, 200, 16, seed=7), _index(80, 200, 16, seed=8)
    obs.reset()
    users = np.arange(16, dtype=np.int32)
    with ServingEngine(idx_a, buckets=(16,), k=10, quant="int8") as eng:
        items_a, _ = eng.recommend(users)
        eng.refresh(idx_b)                              # f32 in -> int8
        assert isinstance(eng._bufs, tq.QuantizedRecommendIndex)
        items_b, scores_b = eng.recommend(users)
        qb = tq.quantize_index(idx_b)._replace(seen=eng._bufs.seen)
        ri, rs = trec.recommend_topk(qb, users, k=10,
                                     method=eng.quant_method)
        np.testing.assert_array_equal(items_b, ri.numpy())
        np.testing.assert_array_equal(scores_b, rs.numpy())
        assert not np.array_equal(items_a, items_b)
        assert obs.counter("serve_compiles_total").value == 1
        assert obs.counter("engine_refreshes_total").value == 1
        g = obs.snapshot()["gauges"]
        assert g["serve_index_bytes{dtype=int8}"] == tq.index_nbytes(qb)
        bad = idx_a._replace(w=torch.ones((201, 16)))
        with pytest.raises(ValueError) as ei:
            eng.refresh(bad)
        assert "expected u(80, 16) x w(200, 16) (int8 layout)" in str(ei.value)
        assert "got u(80, 16) x w(201, 16)" in str(ei.value)
        wide = idx_a._replace(seen=torch.full((80, 16 + 65), 200,
                                              dtype=torch.int32))
        with pytest.raises(ValueError, match="seen_headroom"):
            eng.refresh(wide)
    with ServingEngine(idx_a, buckets=(8,), k=5) as f32_eng:
        with pytest.raises(ValueError, match="mix factor layouts"):
            f32_eng.refresh(tq.quantize_index(idx_a))


def test_engine_refresh_under_load_never_mixes_versions():
    idx_a = _index(120, 90, 6, seed=3)
    idx_b = _index(120, 90, 6, seed=4)
    with ServingEngine(idx_a, buckets=BUCKETS, k=5, quant="int8",
                       quant_method="fused") as eng:
        # 40-user requests span two chunks on this ladder; a torn swap
        # would stitch version A's first chunk to B's second
        users = [np.random.default_rng(i).integers(0, 120, size=40)
                 .astype(np.int32) for i in range(20)]
        oracles = {}
        for key, idx in (("a", idx_a), ("b", idx_b)):
            q = tq.quantize_index(idx)        # its own seen table
            oracles[key] = [_by_chunks(eng.ladder, u, 5, lambda c: trec.
                                       recommend_topk(q, c, k=5,
                                                      method="fused"))
                            for u in users]
        stop = threading.Event()

        def refresher():
            flip = True
            while not stop.is_set():
                eng.refresh(idx_b if flip else idx_a)
                flip = not flip

        t = threading.Thread(target=refresher)
        t.start()
        try:
            futures = [eng.submit(u) for u in users]
            results = [f.result(timeout=TIMEOUT) for f in futures]
        finally:
            stop.set()
            t.join(timeout=TIMEOUT)
        assert not t.is_alive()
        for i, (items, scores) in enumerate(results):
            assert any(np.array_equal(items, o[i][0])
                       and np.array_equal(scores, o[i][1])
                       for o in oracles.values()), f"request {i} mixed"


def test_engine_lifecycle_and_validation():
    idx = _index(40, 60, 4, seed=9)
    with pytest.raises(ValueError, match="unknown quant mode"):
        ServingEngine(idx, buckets=(8,), quant="int4")
    with pytest.raises(ValueError, match="seen_headroom"):
        ServingEngine(idx, buckets=(8,), seen_headroom=-1)
    with pytest.raises(TypeError):
        ServingEngine(idx, buckets=(8,), plan=object())
    eng = ServingEngine(tq.quantize_index(idx), buckets=(8,), k=3)
    assert eng.quant == "int8" and eng.quant_method == "dequant"
    with pytest.raises(ValueError, match="empty request"):
        eng.submit([])
    out = eng.recommend_many([np.arange(3), np.arange(20)])
    assert [o[0].shape for o in out] == [(3, 3), (20, 3)]
    futures = [eng.submit(np.arange(8)) for _ in range(5)]
    eng.drain()
    assert all(f.done() for f in futures)
    eng.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit(np.arange(4))
    eng.shutdown()                                      # idempotent
    assert not eng._worker._thread.is_alive()
    padded = _pad_seen(idx.seen, 20, 60)
    assert padded.shape == (40, 20) and (padded[:, 16:] == 60).all()


def test_recommend_service_int8_chunks_and_metrics():
    idx = _index(100, 300, 16, seed=14)
    obs.reset()
    svc = trec.RecommendService(idx, batch=32, k=10, quant="int8",
                                quant_method="fused")
    assert isinstance(svc.index, tq.QuantizedRecommendIndex)
    users = np.arange(50)
    items, scores = svc.recommend(users)
    assert items.shape == scores.shape == (50, 10)
    want = _by_chunks(BucketLadder((32,)), users, 10, lambda c: trec.
                      recommend_topk(svc.index, c, k=10, method="fused"))
    np.testing.assert_array_equal(items, want[0])
    np.testing.assert_array_equal(scores, want[1])
    svc.recommend(users)
    m = svc.metrics()
    assert m["requests"] == 2 and m["users"] == 100
    assert m["warmup"]["batches"] == 1 and m["latency"]["count"] == 3
    svc.reset_metrics()
    assert svc.metrics()["requests"] == 0
    svc.refresh(type("Fit", (), {"to_recommend_index":
                                 lambda self: _index(100, 300, 16, 15)})())
    assert isinstance(svc.index, tq.QuantizedRecommendIndex)
    with pytest.raises(ValueError, match="unknown quant mode"):
        trec.RecommendService(idx, quant="fp8")


def test_fit_result_to_service_and_to_engine():
    ds = lowrank_problem(60, 48, 3, density=0.3, seed=0)
    problem = tmc.CompletionProblem.from_dataset(ds, 3, 2, 3, layout="sparse",
                                                 device="cpu")
    cfg = GossipMCConfig(m=60, n=48, p=3, q=2, rank=3, rho=1e3, lam=1e-6,
                         a=5e-4, b=5e-7)
    res = tmc.Trainer(cfg).fit(problem, tmc.FullGD(num_rounds=5), seed=0)
    index = res.to_recommend_index()
    users = np.arange(40)

    svc = res.to_service(batch=16, k=5, quant="int8")
    items, _ = svc.recommend(users)
    assert items.shape == (40, 5)
    q = tq.quantize_index(index)
    np.testing.assert_array_equal(svc.index.w_q.numpy(), q.w_q.numpy())

    obs.reset()
    with res.to_engine(buckets=BUCKETS, k=5, quant="int8") as eng:
        assert eng.device == torch.device("cpu")
        assert obs.counter("serve_compiles_total").value == len(BUCKETS)
        items, scores = eng.recommend(users)
        qe = q._replace(seen=eng._bufs.seen)
        want = _by_chunks(eng.ladder, users, 5, lambda c: trec.
                          recommend_topk(qe, c, k=5,
                                         method=eng.quant_method))
        np.testing.assert_array_equal(items, want[0])
        np.testing.assert_array_equal(scores, want[1])
        seen = set(zip(*(a.tolist() for a in problem.seen_coo)))
        assert not any((int(u), int(i)) in seen
                       for u, row in zip(users, items) for i in row)
        eng.refresh(res)                                # FitResult swap-in
    with res.to_engine(buckets=(8,), k=5) as f32:
        assert f32.quant is None
        items, _ = f32.recommend(users[:8])
        ri, _ = trec.recommend_topk(f32._bufs, users[:8], k=5)
        np.testing.assert_array_equal(items, ri.numpy())
    with pytest.raises(TypeError):
        res.to_engine(plan=object())
