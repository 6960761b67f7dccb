"""The port's item-sharded serving against the JAX package's, on the CPU.

* ``topk_ordered`` / ``recommend_topk``: ``jax.lax.top_k``'s order (score
  descending, ties to the lower id) on tied scores: identical item rows,
  a user whose seen items (at −inf) k reaches past, a zero user row.
* ``shard_index`` / ``recommend_topk_sharded`` with n = 203 (n % 4 ≠ 0)
  and k = 7 against JAX's ``recommend_topk_sharded`` on four forced host
  devices and against the unsharded port: items exactly, f32 scores to
  1e-5, int8 scores bitwise; the per-shard k and the refresh guards'
  messages as JAX words them; a one-rank plan bitwise the unsharded path.
* One 2×2 ``gloo`` grid: the two-stage query on every rank, the
  ``RecommendService(plan=)``, the ``ServingEngine(plan=)`` with a hot
  refresh queued between requests (and a refused one), and serving
  straight from a grid fit (``FitResult.to_engine()`` on every rank,
  ``launch/serve_recommend.serve_fit_rank``), whose index equals JAX's
  ``to_recommend_index`` after the same ``Gossip`` fit on a 2×2 mesh; a
  ``Gossip`` refit and ``total_cost_device`` on the grid while its engine
  serves, then a refresh to that refit on every rank.

One JAX subprocess and one rank grid for the file, each with a timeout.
"""

import os
import subprocess
import sys
import textwrap
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import GossipMCConfig  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.launch import gossip as tlaunch  # noqa: E402
from repro_torch.launch import serve_recommend as tserve  # noqa: E402
from repro_torch.mc import Gossip, Trainer  # noqa: E402
from repro_torch.mesh import MeshPlan  # noqa: E402
from repro_torch.serve import quant as tq  # noqa: E402
from repro_torch.serve import recommend as trec  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPROCESS_TIMEOUT = 300
GRID_TIMEOUT = 180
RTOL = 1e-5
NU, NI, RK, K = 120, 203, 5, 7        # users, items (n % 4 != 0), rank, k
GRID = (2, 2)
WORLD = MeshPlan.for_world(4)
BUCKETS = (8, 32)
# the grid fit whose index is held against JAX's
FM, FN, FR = 48, 40, 3
HP = dict(rho=1e3, lam=1e-6, a=5e-4, b=5e-7)
FIT_ROUNDS = 30
REFIT_ROUNDS = 10
FIT_RECIPE = tlaunch.ProblemRecipe(
    "lowrank_problem", dict(m=FM, n=FN, r=FR, density=0.3, seed=0),
    p=4, q=4, rank=FR, layout="sparse")
SERVING_BEFORE = tuple(np.random.default_rng(5).integers(0, FM, s).astype(
    np.int32) for s in (3, 30, 12, 40, 8))
SERVING_AFTER = (np.arange(FM, dtype=np.int32),)


def _index_arrays(seed=0):
    """u, w, seen with ties: items 40, 41 and 150 share one row (shards 0
    and 2), user 7 has seen all but 3 items, user 9's row is zero."""

    rng = np.random.default_rng(seed)
    u = rng.normal(size=(NU, RK)).astype(np.float32)
    w = rng.normal(size=(NI, RK)).astype(np.float32)
    w[41] = w[150] = w[40]
    u[9] = 0.0
    mask = (rng.random((NU, NI)) < 0.1).astype(np.float32)
    mask[7] = 1.0
    mask[7, [5, 100, 190]] = 0.0
    seen = trec.build_seen_table(mask, NI)
    return u, w, seen


def _index(seed=0):
    return trec.RecommendIndex(*(torch.from_numpy(a)
                                 for a in _index_arrays(seed)))


USERS = np.concatenate([[7, 8, 9], np.arange(0, NU, 5)]).astype(np.int32)


def _requests(seed, sizes, users=NU):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, users, s).astype(np.int32) for s in sizes)


BEFORE = _requests(1, (1, 8, 9, 32, 40, 70))
AFTER = _requests(2, (3, 33))


def run_jax(prog: str, devices: int) -> str:
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(prog)],
                         capture_output=True, text=True, env=env,
                         timeout=SUBPROCESS_TIMEOUT)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    return out.stdout


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    base = tmp_path_factory.mktemp("jax")
    out = base / "serving.npz"
    inputs = base / "inputs.npz"
    u, w, seen = _index_arrays()
    np.savez(inputs, u=u, w=w, seen=seen, users=USERS)
    prog = f"""
    import types
    import jax, jax.numpy as jnp, numpy as np
    from repro import mc
    from repro.compat import make_mesh
    from repro.config import GossipMCConfig
    from repro.core import grid as G, state as S
    from repro.data import lowrank_problem
    from repro.mesh import MeshPlan
    from repro.serve.quant import quantize_index
    from repro.serve.recommend import (RecommendIndex, recommend_topk,
                                       recommend_topk_sharded, shard_index)
    assert len(jax.devices()) == 4
    d = np.load({str(inputs)!r})
    index = RecommendIndex(jnp.asarray(d["u"]), jnp.asarray(d["w"]),
                           jnp.asarray(d["seen"]))
    users = jnp.asarray(d["users"])
    plan = MeshPlan.for_devices()
    save = {{}}
    save["plan"] = np.asarray([plan.p, plan.q, plan.row_size, plan.col_size,
                               plan.num_item_shards])
    save["all_axes"] = np.asarray(plan.all_axes)
    q = quantize_index(index)
    for tag, idx, method in (("f32", index, None), ("int8", q, "fused")):
        i, s = recommend_topk(idx, users, k={K}, method=method)
        save[tag + "_items"], save[tag + "_scores"] = np.asarray(i), np.asarray(s)
        sidx = shard_index(idx, plan)
        i, s = recommend_topk_sharded(sidx, users, k={K}, method=method)
        save[tag + "_sh_items"] = np.asarray(i)
        save[tag + "_sh_scores"] = np.asarray(s)
    sidx = shard_index(index, plan)
    def message(fn):
        try:
            fn()
        except ValueError as err:
            return np.asarray(str(err))
        raise AssertionError("no error")
    other = types.SimpleNamespace(
        problem=types.SimpleNamespace(plan=types.SimpleNamespace(
            num_item_shards=2)), to_recommend_index=lambda: index)
    save["msg_shards"] = message(lambda: sidx.refresh(other))
    small = RecommendIndex(index.u[:, :4], index.w[:100, :4], index.seen)
    shapes = types.SimpleNamespace(problem=None,
                                   to_recommend_index=lambda: small)
    save["msg_shapes"] = message(lambda: sidx.refresh(shapes))
    save["msg_q_shapes"] = message(
        lambda: shard_index(q, plan).refresh(shapes))
    save["msg_k"] = message(
        lambda: recommend_topk_sharded(sidx, users, k=60))
    # the grid fit: Gossip on a 2x2 mesh, then to_recommend_index
    cfg = GossipMCConfig(m={FM}, n={FN}, p=4, q=4, rank={FR}, **{HP!r})
    prob = mc.CompletionProblem.from_dataset(
        lowrank_problem({FM}, {FN}, {FR}, density=0.3, seed=0), 4, 4, {FR},
        layout="sparse")
    st0 = S.init_state(jax.random.PRNGKey(0),
                       G.GridSpec({FM}, {FN}, 4, 4, {FR}))
    res = mc.Trainer(cfg).fit(prob, mc.Gossip(
        num_rounds={FIT_ROUNDS}, mesh=make_mesh((2, 2), ("data", "model"))),
        state=st0)
    fidx = res.to_recommend_index()
    save["U0"], save["W0"] = np.asarray(st0.U), np.asarray(st0.W)
    save["fit_u"], save["fit_w"] = np.asarray(fidx.u), np.asarray(fidx.w)
    save["fit_seen"] = np.asarray(fidx.seen)
    np.savez({str(out)!r}, **save)
    """
    run_jax(prog, 4)
    return np.load(out)


# ---------------------------------------------------------------------- #
# tie order
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(4))
def test_topk_ordered_equals_jax_top_k_on_ties(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (5, 97)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = -np.inf
    x[rng.random(x.shape) < 0.1] = -0.0
    x[rng.random(x.shape) < 0.05] = np.inf
    for k in (1, 7, 60, 97):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = trec.topk_ordered(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                      np.asarray(jv).view(np.int32))
    # the issue's cases: [1, 2, 2, 2, 0, 2] and a row of zeros
    _, i = trec.topk_ordered(torch.tensor([[1., 2, 2, 2, 0, 2]]), 3)
    assert i.tolist() == [[1, 2, 3]]
    _, i = trec.topk_ordered(torch.zeros(1, 100_000), 5)
    assert i.tolist() == [[0, 1, 2, 3, 4]]


def _special_rows(case: str) -> tuple[np.ndarray, set]:
    """Distinct scores (6, 50), with one kind of row that a float
    ``topk`` cannot order alone at k = 5, and which rows those are."""

    x = np.random.default_rng(3).normal(size=(6, 50)).astype(np.float32)
    top = -np.sort(-x, axis=1)
    if case == "nan":                   # above +inf; inside and outside k
        x[1, 7] = x[4, 40] = np.nan
        return x, {1, 4}
    if case == "signed_zero":           # +0 above -0 at the boundary
        x[2] = -np.abs(x[2]) - 1.0
        x[2, :4] = 1.0 + np.arange(4)
        x[2, 10], x[2, 20] = -0.0, 0.0
        return x, {2}
    if case == "boundary_tie":          # the 5th value twice, ids 5, 45
        x[3] = -np.abs(x[3]) - 1.0
        x[3, [10, 20, 30, 40]] = [4.0, 3.0, 2.0, 1.0]
        x[3, 5] = x[3, 45] = 0.5
        return x, {3}
    if case == "inner_tie":             # two equal values inside the k
        x[5, 9] = x[5, 33] = top[5, 0] + 1.0
        return x, {5}
    return x, set()


@pytest.mark.parametrize("case", ["distinct", "nan", "signed_zero",
                                  "boundary_tie", "inner_tie"])
def test_topk_ordered_selects_again_only_the_rows_it_must(case,
                                                          monkeypatch):
    """The float ``topk`` answers rows whose k are distinct and strictly
    above the rest; only the other rows go through the int64 keys, and
    every row lands in ``jax.lax.top_k``'s order."""

    x, redo = _special_rows(case)
    seen = []
    keyed = trec._keyed_topk

    def spy(scores, k, ids):
        seen.append(scores.shape[0])
        return keyed(scores, k, ids)

    monkeypatch.setattr(trec, "_keyed_topk", spy)
    tv, ti = trec.topk_ordered(torch.from_numpy(x), 5)
    assert seen == ([len(redo)] if redo else [])
    jv, ji = jax.lax.top_k(jnp.asarray(x), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))
    # the merge's global ids break the ties in place of positions
    ids = torch.from_numpy(np.argsort(np.random.default_rng(4).random(
        x.shape), axis=1))
    mv, mi = trec.topk_ordered(torch.from_numpy(x), 5, ids)
    order = np.lexsort((ids.numpy(), -x), axis=1)
    fin = ~np.isnan(x).any(1) & ~(x == 0).any(1)
    np.testing.assert_array_equal(mi.numpy()[fin], order[fin, :5])


@pytest.mark.parametrize("tag", ["f32", "int8"])
def test_recommend_topk_breaks_ties_as_jax(jax_ref, tag):
    index = _index()
    method = None
    if tag == "int8":
        index, method = tq.quantize_index(index), "fused"
    items, scores = trec.recommend_topk(index, USERS, k=K, method=method)
    np.testing.assert_array_equal(items.numpy(), jax_ref[f"{tag}_items"])
    _scores_equal(scores.numpy(), jax_ref[f"{tag}_scores"], tag)
    # user 7 (USERS[0]): 3 unseen items first, then seen ones by id
    assert set(items[0, :3].tolist()) == {5, 100, 190}
    assert items[0, 3:].tolist() == [0, 1, 2, 3]
    assert bool(torch.isinf(scores[0, 3:]).all())
    # user 9 (zero row): every score 0, the lowest unseen ids
    seen9 = set(index.seen[9].tolist())
    assert items[2].tolist() == [i for i in range(NI) if i not in seen9][:K]


def _scores_equal(got, want, tag):
    if tag == "int8":
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    else:
        fin = np.isfinite(want)
        assert np.array_equal(np.isfinite(got), fin)
        np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL,
                                   atol=RTOL * float(np.abs(want[fin]).max()))


# ---------------------------------------------------------------------- #
# shards on one process
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("quantized", [False, True])
def test_one_rank_plan_is_bitwise_the_unsharded_path(quantized):
    index = _index()
    method = None
    if quantized:
        index, method = tq.quantize_index(index), "fused"
    sidx = trec.shard_index(index, MeshPlan.build(1, 1))
    assert sidx.num_item_shards == 1 and sidx.shard_items == NI
    got = trec.recommend_topk_sharded(sidx, USERS, k=K, method=method)
    want = trec.recommend_topk(index, USERS, k=K, method=method)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    svc = trec.RecommendService(index, batch=16, k=K, plan=MeshPlan.build(
        1, 1), quant_method=method)
    assert svc.index is None and svc.num_item_shards == 1
    assert svc.num_items == NI and svc.num_users == NU
    one = trec.RecommendService(index, batch=16, k=K, quant_method=method)
    for a, b in zip(svc.recommend(USERS), one.recommend(USERS)):
        np.testing.assert_array_equal(a, b)


def test_world_plan_equals_jax_for_devices(jax_ref):
    assert [WORLD.p, WORLD.q, WORLD.row_size, WORLD.col_size,
            WORLD.num_item_shards] == jax_ref["plan"].tolist()
    assert WORLD.all_axes == tuple(jax_ref["all_axes"].tolist())
    with pytest.raises(ValueError, match="not a multiple"):
        WORLD.item_slice(0, 203)
    with pytest.raises(IndexError):
        WORLD.item_slice(4, 204)


@pytest.mark.parametrize("rank", range(4))
def test_shard_index_keeps_a_contiguous_padded_slice(rank):
    index = _index()
    q = tq.quantize_index(index)
    s, sq = trec.shard_index(index, WORLD, rank), trec.shard_index(q, WORLD,
                                                                  rank)
    assert s.shard_items == sq.shard_items == 51 and s.start == 51 * rank
    sl = WORLD.item_slice(rank, 204)
    assert (sl.start, sl.stop) == (51 * rank, 51 * rank + 51)
    real = min(51, NI - s.start)
    assert torch.equal(s.index.w[:real], index.w[s.start:s.start + real])
    assert bool((s.index.w[real:] == 0).all())
    # per-row scales commute with slicing: the shard's codes are the
    # global codes
    assert torch.equal(sq.index.w_q[:real], q.w_q[s.start:s.start + real])
    assert torch.equal(sq.index.w_scale[:real],
                       q.w_scale[s.start:s.start + real])
    for t in (s.index.w, sq.index.w_q, sq.index.w_scale):
        assert t.is_contiguous()
    assert s.index.u is index.u and s.index.seen is index.seen
    with pytest.raises(TypeError, match="MeshPlan"):
        trec.shard_index(index, object())


def test_guard_messages_equal_jax(jax_ref):
    index = _index()
    sidx = trec.shard_index(index, WORLD, 0)
    other = types.SimpleNamespace(
        problem=types.SimpleNamespace(plan=MeshPlan.for_world(2)),
        to_recommend_index=lambda: index)
    with pytest.raises(ValueError) as err:
        sidx.refresh(other)
    assert str(err.value) == str(jax_ref["msg_shards"])
    small = trec.RecommendIndex(index.u[:, :4], index.w[:100, :4],
                                index.seen)
    shapes = types.SimpleNamespace(problem=None,
                                   to_recommend_index=lambda: small)
    with pytest.raises(ValueError) as err:
        sidx.refresh(shapes)
    assert str(err.value) == str(jax_ref["msg_shapes"])
    with pytest.raises(ValueError) as err:
        trec.shard_index(tq.quantize_index(index), WORLD, 0).refresh(shapes)
    assert str(err.value) == str(jax_ref["msg_q_shapes"])
    with pytest.raises(ValueError, match="per-shard") as err:
        trec.recommend_topk_sharded(sidx, USERS, k=60)
    assert str(err.value) == str(jax_ref["msg_k"])
    # a refresh that keeps the shapes re-shards in the same layout
    new = trec.shard_index(tq.quantize_index(index), WORLD, 3).refresh(
        types.SimpleNamespace(problem=None,
                              to_recommend_index=lambda: _index(1)))
    assert new.quantized and new.rank == 3
    assert torch.equal(new.index.w_q,
                       trec.shard_index(tq.quantize_index(_index(1)), WORLD,
                                        3).index.w_q)


# ---------------------------------------------------------------------- #
# one 2x2 gloo grid
# ---------------------------------------------------------------------- #


def _grid_answers(engine, rank, new):
    """Rank 0: answers to BEFORE, a refresh to ``new`` queued behind them,
    answers to AFTER; then a refused refresh and one more answer.  The
    other ranks refresh in step."""

    out = {}
    bad = new._replace(u=new.u[:, :4])
    if rank == 0:
        futures = [engine.submit(x) for x in BEFORE]
        engine.refresh(new)
        futures += [engine.submit(x) for x in AFTER]
        out["answers"] = [f.result(timeout=GRID_TIMEOUT) for f in futures]
    else:
        engine.refresh(new)
    try:
        engine.refresh(bad)
    except ValueError as err:
        out["refused"] = str(err)
    if rank == 0:
        out["last"] = engine.recommend(AFTER[0])
    return out


def _grid_rank(rank, device, state0):
    out = {}
    index, new = _index(), _index(1)
    for tag, idx, method in (("f32", index, None),
                             ("int8", tq.quantize_index(index), "fused")):
        sidx = trec.shard_index(idx, WORLD)
        items, scores = trec.recommend_topk_sharded(sidx, USERS, k=K,
                                                    method=method)
        out[f"{tag}_query"] = (items.numpy(), scores.numpy())
        svc = trec.RecommendService(idx, batch=16, k=K, plan=WORLD,
                                    quant_method=method)
        out[f"{tag}_service"] = svc.recommend(USERS)
        engine = ServingEngine(index, buckets=BUCKETS, k=K, plan=WORLD,
                               quant="int8" if method else None,
                               quant_method=method)
        with engine:
            out[f"{tag}_engine"] = _grid_answers(engine, rank, new)
        try:
            engine.submit(USERS)
        except RuntimeError as err:
            out[f"{tag}_closed"] = str(err)
        try:
            engine.refresh(new)
        except RuntimeError as err:
            out[f"{tag}_closed_refresh"] = str(err)
    # fault 1: serving straight from a grid fit
    recipe = FIT_RECIPE
    cfg = GossipMCConfig(m=FM, n=FN, p=4, q=4, rank=FR, **HP)
    plan = MeshPlan.build(4, 4, grid=GRID)
    problem = recipe.build(plan, device)
    res = Trainer(cfg).fit(problem, Gossip(num_rounds=FIT_ROUNDS),
                           state=state_from_numpy(*state0, 0, device))
    fidx = res.to_recommend_index()
    out["fit_index"] = [t.numpy() for t in fidx]
    with res.to_engine(buckets=BUCKETS, k=5) as engine:
        assert engine.plan == plan and engine._bufs.rank == rank
        out["fit_engine"] = (engine.recommend(np.arange(FM))
                             if rank == 0 else None)
    job = tserve.ServeJob(recipe, cfg, FIT_ROUNDS, 10,
                          _requests(3, (1, 8, 20, 45), FM),
                          _requests(4, (9,), FM),
                          quant="int8", quant_method="fused",
                          buckets=BUCKETS, k=5)
    out["serve_fit"] = tserve.serve_fit_rank(rank, device, job, GRID)
    # collectives of the default group on the main thread (a Gossip refit,
    # its cost) while the grid engine serves, then a refresh to the refit
    with res.to_engine(buckets=BUCKETS, k=5) as engine:
        futures = ([engine.submit(x) for x in SERVING_BEFORE]
                   if rank == 0 else [])
        refit = Trainer(cfg).fit(problem, Gossip(num_rounds=REFIT_ROUNDS),
                                 state=res.state)
        out["refit_cost"] = float(problem.total_cost_device(refit.state,
                                                            cfg.lam))
        engine.refresh(refit)
        if rank == 0:
            futures += [engine.submit(x) for x in SERVING_AFTER]
            out["refit_serving"] = [f.result(timeout=GRID_TIMEOUT)
                                    for f in futures]
    out["refit_index"] = [t.numpy() for t in refit.to_recommend_index()]
    out["refit_state"] = (refit.state.U.numpy(), refit.state.W.numpy())
    out["floor"] = tserve.collective_floor(device, K)
    return out


@pytest.fixture(scope="module")
def grid(jax_ref):
    t0 = time.monotonic()
    outs = tlaunch.run_on_grid(_grid_rank, GRID,
                               (jax_ref["U0"], jax_ref["W0"]),
                               device="cpu", timeout=GRID_TIMEOUT)
    assert time.monotonic() - t0 < GRID_TIMEOUT
    return outs


@pytest.mark.parametrize("tag", ["f32", "int8"])
def test_grid_two_stage_query_equals_jax_and_the_unsharded_path(grid,
                                                                jax_ref,
                                                                tag):
    index = _index()
    method = None
    if tag == "int8":
        index, method = tq.quantize_index(index), "fused"
    ui, us = trec.recommend_topk(index, USERS, k=K, method=method)
    for out in grid:                        # every rank holds the answer
        items, scores = out[f"{tag}_query"]
        np.testing.assert_array_equal(items, jax_ref[f"{tag}_sh_items"])
        np.testing.assert_array_equal(items, ui.numpy())
        _scores_equal(scores, jax_ref[f"{tag}_sh_scores"], tag)
        _scores_equal(scores, us.numpy(), tag)
        svc_items, svc_scores = out[f"{tag}_service"]
        np.testing.assert_array_equal(svc_items, items)
        np.testing.assert_array_equal(svc_scores, scores)


@pytest.mark.parametrize("tag", ["f32", "int8"])
def test_grid_engine_refresh_is_queued_between_requests(grid, tag):
    quant, method = (None, None) if tag == "f32" else ("int8", "fused")
    with ServingEngine(_index(), buckets=BUCKETS, k=K, quant=quant,
                       quant_method=method) as one:
        want = [one.recommend(x) for x in BEFORE]
        one.refresh(_index(1))
        want += [one.recommend(x) for x in AFTER]
    got = grid[0][f"{tag}_engine"]
    for (gi, gs), (wi, ws) in zip(got["answers"], want):
        np.testing.assert_array_equal(gi, wi)
        _scores_equal(gs, ws, tag)
    np.testing.assert_array_equal(got["last"][0], want[-2][0])
    # the refused refresh raised the same on every rank, and the engine
    # went on serving the version before it
    msgs = {out[f"{tag}_engine"]["refused"] for out in grid}
    assert len(msgs) == 1 and "refresh changes the factor shapes" in \
        msgs.pop()
    assert "shut down" in grid[0][f"{tag}_closed"]
    assert all("shut down" in out[f"{tag}_closed_refresh"] for out in grid)
    assert all("rank 0's engine" in out[f"{tag}_closed"] for out in grid[1:])


def test_grid_fit_serves_and_its_index_equals_jax(grid, jax_ref):
    u, w, seen = grid[0]["fit_index"]
    for out in grid[1:]:                    # every rank: the same index
        for a, b in zip(out["fit_index"], (u, w, seen)):
            np.testing.assert_array_equal(a, b)
    for a, b in ((u, jax_ref["fit_u"]), (w, jax_ref["fit_w"])):
        np.testing.assert_allclose(a, b, rtol=RTOL,
                                   atol=RTOL * float(np.abs(b).max()))
    np.testing.assert_array_equal(seen, jax_ref["fit_seen"])
    index = trec.RecommendIndex(*(torch.from_numpy(a) for a in (u, w, seen)))
    with ServingEngine(index, buckets=BUCKETS, k=5) as one:
        want = one.recommend(np.arange(FM))
    np.testing.assert_array_equal(grid[0]["fit_engine"][0], want[0])
    np.testing.assert_allclose(grid[0]["fit_engine"][1], want[1], rtol=RTOL)


def test_serve_fit_rank_answers_as_the_unsharded_engine(grid):
    outs = [out["serve_fit"] for out in grid]
    top = outs[0]
    assert top["items_equal"] and top["scores_bitwise"], top
    assert top["compiles"] == len(BUCKETS)
    assert [o["shard_items"] for o in outs] == [10] * 4     # n = 40 / 4
    assert top["users"] == 1 + 8 + 20 + 45 + 9
    assert sum(top["buckets"][b]["count"] for b in BUCKETS) == 6


def test_grid_refit_while_serving_then_refresh(grid):
    """A ``Gossip`` refit and its all-reduced cost on the grid's default
    group while every rank's engine serves (rank 0's worker busy with the
    requests, the followers waiting for its messages): the engine's
    collectives run on a group of their own, so nothing pairs wrongly.
    The answers before the refresh are the fit's, after it the refit's,
    as the unsharded engine gives them; every rank holds one refit and
    one cost, and that cost is the 1x1 problem's on the same state."""

    idx = [trec.RecommendIndex(*(torch.from_numpy(a) for a in arrays))
           for arrays in (grid[0]["fit_index"], grid[0]["refit_index"])]
    for out in grid[1:]:
        for a, b in zip(out["refit_index"], grid[0]["refit_index"]):
            np.testing.assert_array_equal(a, b)
        assert out["refit_cost"] == grid[0]["refit_cost"]
    with ServingEngine(idx[0], buckets=BUCKETS, k=5) as one:
        want = [one.recommend(x) for x in SERVING_BEFORE]
        one.refresh(idx[1])
        want += [one.recommend(x) for x in SERVING_AFTER]
    got = grid[0]["refit_serving"]
    assert len(got) == len(want)
    for (gi, gs), (wi, ws) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        _scores_equal(gs, ws, "f32")
    problem = FIT_RECIPE.build(None, "cpu")
    state = state_from_numpy(*grid[0]["refit_state"], 0, "cpu")
    want_cost = float(problem.total_cost_device(state, HP["lam"]))
    assert abs(grid[0]["refit_cost"] - want_cost) <= RTOL * abs(want_cost)
    floors = [out["floor"] for out in grid]
    assert all(f["broadcast_ms"] > 0 and f["all_gather_ms"] > 0
               for f in floors)


def test_engine_refuses_users_out_of_range_before_queueing():
    """A request the grid would fail on every rank never reaches it."""

    with ServingEngine(_index(), buckets=BUCKETS, k=K,
                       plan=MeshPlan.build(1, 1)) as engine:
        for bad in ([NU], [-1, 3]):
            with pytest.raises(ValueError, match="out of range"):
                engine.submit(bad)
        assert engine.recommend([NU - 1])[0].shape == (1, K)


def test_serve_recommend_bench_prints_the_reference_lines(capsys, tmp_path):
    out = tmp_path / "bench.json"
    tserve.main(["--device", "cpu", "--users", "100", "--items", "90",
                 "--iters", "3", "--batch", "32", "--json", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("index: 100 users x 90 items, rank 16")
    assert "1 item shard(s)" in lines[0]
    assert "users/s" in lines[1] and "M scores/s" in lines[1]
    assert lines[2].startswith("service: p50=") and "over 3 batches" in \
        lines[2]
    import json
    got = json.loads(out.read_text())
    assert got["item_shards"] == 1 and got["users_per_s"] > 0
