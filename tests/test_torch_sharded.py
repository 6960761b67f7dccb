"""The port's owner-routed sparse store (``sparse/sharded.py``) against the
JAX package's ``ShardedEntries`` on four forced host devices, on the CPU.

* ``ShardedEntries.from_coo`` / ``local`` / ``append``: each rank's tile,
  all eight arrays, exactly equal to JAX's device shard (the data of
  ``tests/test_mesh_plan.py::test_sharded_ingest_append_and_grads_match_global``:
  m, n = 64, 48, 4×4 blocks over a 2×2 grid), and to the tile of the
  port's global store; the routing counters and the overflow message as
  the reference gives them.
* ``f_grads_sharded`` at relative 1e-5 of JAX's (that reference test
  holds them at absolute 1e-5, which f32 rounding of gradients of size
  ~40 does not keep; relative is the port's bound for float paths).
* ``sample_minibatch_sharded``: the tile of the 1×1 draw.
* ``CompletionProblem.from_entries(plan=)`` never packs the global store;
  ``append`` and ``with_plan``.
* One 2×2 ``gloo`` grid: routed ingest on every rank equal to the sliced
  global store, ``total_cost_device`` all-reduced, routed appends, and
  ``Gossip`` on the routed store bitwise the same fit on the sliced one
  and within 1e-5 of 1×1.

One JAX subprocess and one rank grid for the file, each with a timeout.
"""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch import sparse as tsparse  # noqa: E402
from repro_torch.config import GossipMCConfig  # noqa: E402
from repro_torch.core.state import init_state  # noqa: E402
from repro_torch.launch import gossip as tlaunch  # noqa: E402
from repro_torch.mc import CompletionProblem, Gossip, Trainer  # noqa: E402
from repro_torch.mesh import MeshPlan  # noqa: E402
from repro_torch.sparse import sharded as tsharded  # noqa: E402
from repro_torch.sparse import store as tstore  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("rows", "cols", "vals", "valid", "col_perm", "row_ptr", "col_ptr")
SUBPROCESS_TIMEOUT = 300
GRID_TIMEOUT = 180
RTOL = 1e-5
M, N, P, Q, R = 64, 48, 4, 4, 4
GRID = (2, 2)
PLAN = MeshPlan.build(P, Q, grid=GRID)
HP = dict(rho=1e3, lam=1e-6, a=5e-4, b=5e-7)


def _data():
    """The reference test's entries, append batch and factors."""

    rng = np.random.default_rng(0)
    rows = rng.integers(0, M, 500)
    cols = rng.integers(0, N, 500)
    _, ui = np.unique(rows * N + cols, return_index=True)
    rows, cols = rows[ui], cols[ui]
    vals = rng.normal(size=len(rows)).astype(np.float32)
    arows, acols = rng.integers(0, M, 60), rng.integers(0, N, 60)
    avals = rng.normal(size=60).astype(np.float32)
    U = rng.normal(size=(P, Q, M // P, R)).astype(np.float32)
    W = rng.normal(size=(P, Q, N // Q, R)).astype(np.float32)
    return (rows, cols, vals), (arows, acols, avals), U, W


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
    out = tmp_path_factory.mktemp("jax") / "sharded.npz"
    (rows, cols, vals), (ar, ac, av), U, W = _data()
    path = tmp_path_factory.getbasetemp() / "inputs.npz"
    np.savez(path, rows=rows, cols=cols, vals=vals, ar=ar, ac=ac, av=av,
             U=U, W=W)
    prog = f"""
    import jax, jax.numpy as jnp, numpy as np
    from repro import obs
    from repro.mesh import MeshPlan, build_mesh
    from repro.sparse.sharded import ShardedEntries, f_grads_sharded
    assert len(jax.devices()) == 4
    d = np.load({str(path)!r})
    plan = MeshPlan.build({P}, {Q}, mesh=build_mesh((2, 2), ("data", "model")))
    save = {{}}
    obs.reset()
    sh, (M2, N2) = ShardedEntries.from_coo(d["rows"], d["cols"], d["vals"],
                                           {M}, {N}, plan, headroom=64)
    save["MN"] = np.asarray([M2, N2])
    for di in range(2):
        for dj in range(2):
            save[f"routed{{di}}{{dj}}"] = obs.counter(
                "ingest_routed_entries_total", shard=f"{{di}},{{dj}}").value
    sh2 = sh.append(d["ar"], d["ac"], d["av"])
    for di in range(2):
        for dj in range(2):
            for tag, s in (("ingest", sh), ("append", sh2)):
                loc = s.local(di, dj)
                for f in {FIELDS!r}:
                    save[f"{{tag}}_{{di}}{{dj}}_{{f}}"] = np.asarray(
                        getattr(loc.entries, f))
                save[f"{{tag}}_{{di}}{{dj}}_nnz"] = np.asarray(loc.nnz)
            save[f"after{{di}}{{dj}}"] = obs.counter(
                "ingest_routed_entries_total", shard=f"{{di}},{{dj}}").value
    gu, gw = f_grads_sharded(sh2, jnp.asarray(d["U"]), jnp.asarray(d["W"]))
    save["gu"], save["gw"] = np.asarray(gu), np.asarray(gw)
    # an append past a block's capacity: the reference's message
    small, _ = ShardedEntries.from_coo(d["rows"], d["cols"], d["vals"],
                                       {M}, {N}, plan, bucket=32)
    try:
        small.append(np.arange(150) % 16, np.arange(150) // 16 + 12,
                     np.ones(150, np.float32))
        raise AssertionError("no overflow")
    except ValueError as err:
        save["overflow"] = np.asarray(str(err))
    np.savez({str(out)!r}, **save)
    """
    run_jax(prog, 4)
    return np.load(out)


def _tile_equal(got: tstore.SparseProblem, want, prefix):
    for f in FIELDS:
        a = getattr(got.entries, f)
        np.testing.assert_array_equal(a.numpy(), want[f"{prefix}_{f}"],
                                      err_msg=f)
        assert a.dtype == (torch.float32 if f in ("vals", "valid")
                           else torch.int32), f
    np.testing.assert_array_equal(got.nnz.numpy(), want[f"{prefix}_nnz"])


def _routed(rank, headroom=64, bucket=tstore.DEFAULT_BUCKET):
    (rows, cols, vals), *_ = _data()
    return tsharded.ShardedEntries.from_coo(rows, cols, vals, M, N, PLAN,
                                            bucket, headroom, rank=rank,
                                            device="cpu")


@pytest.mark.parametrize("rank", range(4))
def test_from_coo_tile_equals_jax_shard_and_the_global_stores_tile(jax_ref,
                                                                  rank):
    sh, mn = _routed(rank)
    assert mn == tuple(jax_ref["MN"]) == (M, N)
    assert sh.plan == PLAN and sh.rank == rank and sh.local() is sh.sp
    di, dj = PLAN.coords(rank)
    _tile_equal(sh.local(), jax_ref, f"ingest_{di}{dj}")
    (rows, cols, vals), *_ = _data()
    whole, _ = tstore.from_entries(rows, cols, vals, M, N, P, Q, headroom=64,
                                   device="cpu")
    cut = tsharded.ShardedEntries.from_problem(whole, PLAN, rank).sp
    for a, b in zip((*sh.sp.entries, sh.sp.nnz), (*cut.entries, cut.nnz)):
        assert torch.equal(a, b)
    assert sh.capacity == whole.capacity


@pytest.mark.parametrize("rank", range(4))
def test_append_routes_to_the_owner_like_jax(jax_ref, rank):
    sh, _ = _routed(rank)
    _, (ar, ac, av), _, _ = _data()
    grown = sh.append(ar, ac, av)
    di, dj = PLAN.coords(rank)
    _tile_equal(grown.local(), jax_ref, f"append_{di}{dj}")
    # the old tile is never written
    _tile_equal(sh.local(), jax_ref, f"ingest_{di}{dj}")
    # entries only for other ranks' blocks leave this tile as it is
    mine, _ = tsharded.owner_entries(ar, ac, PLAN, M // P, N // Q, rank)
    assert sh.append(ar[~mine], ac[~mine], av[~mine]) is sh


def test_routing_counters_equal_jax(jax_ref):
    obs.reset()
    sh, _ = _routed(0)
    ingest = {f"{di}{dj}": obs.counter("ingest_routed_entries_total",
                                       shard=f"{di},{dj}").value
              for di in range(2) for dj in range(2)}
    assert ingest == {k: float(jax_ref[f"routed{k}"]) for k in ingest}
    _, (ar, ac, av), _, _ = _data()
    sh.append(ar, ac, av)
    after = {k: obs.counter("ingest_routed_entries_total",
                            shard=f"{k[0]},{k[1]}").value for k in ingest}
    assert after == {k: float(jax_ref[f"after{k}"]) for k in ingest}
    assert sum(ingest.values()) == len(_data()[0][0])


@pytest.mark.parametrize("rank", range(4))
def test_f_grads_sharded_is_the_tile_of_jax_gradients(jax_ref, rank):
    sh, _ = _routed(rank)
    _, (ar, ac, av), U, W = _data()
    sh = sh.append(ar, ac, av)
    tile = PLAN.tile(rank)
    for Ux, Wx in ((torch.from_numpy(U), torch.from_numpy(W)),
                   (torch.from_numpy(U[tile]), torch.from_numpy(W[tile]))):
        gu, gw = tsharded.f_grads_sharded(sh, Ux, Wx)
        for got, want in ((gu, jax_ref["gu"][tile]),
                          (gw, jax_ref["gw"][tile])):
            np.testing.assert_allclose(
                got.numpy(), want, rtol=RTOL,
                atol=RTOL * float(np.abs(want).max()))


def test_append_overflow_message_equals_jax(jax_ref):
    msgs = []
    for rank in range(4):
        sh, _ = _routed(rank, headroom=0, bucket=32)
        try:
            sh.append(np.arange(150) % 16, np.arange(150) // 16 + 12,
                      np.ones(150, np.float32))
        except ValueError as err:
            msgs.append(str(err))
    # the batch lands in block (0, 1) of rank 0; the others take none
    assert msgs == [str(jax_ref["overflow"])]


@pytest.mark.parametrize("rank", range(4))
def test_sample_minibatch_sharded_is_the_tile_of_the_1x1_draw(rank):
    sh, _ = _routed(rank)
    whole = tsparse.from_entries(*_data()[0], M, N, P, Q, headroom=64,
                                 device="cpu")[0]
    for step in (0, 9):
        g1 = torch.Generator().manual_seed(step)
        g2 = torch.Generator().manual_seed(step)
        want = PLAN.local_slice(tstore.sample_minibatch(g1, whole, 12), rank)
        got = tsharded.sample_minibatch_sharded(g2, sh, 12)
        for a, b in zip((*got.entries, got.nnz), (*want.entries, want.nnz)):
            assert torch.equal(a, b)


def test_problem_from_entries_with_plan_packs_only_the_tile(monkeypatch):
    (rows, cols, vals), (ar, ac, av), _, _ = _data()
    whole = CompletionProblem.from_entries(rows, cols, vals, (M, N), P, Q, R,
                                           headroom=64, device="cpu")

    def refuse(*a, **k):
        raise AssertionError("the global store was packed")

    monkeypatch.setattr(tstore, "from_entries", refuse)
    for rank in range(4):
        monkeypatch.setattr("repro_torch.mesh.plan.current_rank",
                            lambda r=rank: r)
        tile = CompletionProblem.from_entries(rows, cols, vals, (M, N), P, Q,
                                              R, headroom=64, plan=GRID,
                                              device="cpu")
        assert tile.plan == PLAN and tile.spec == whole.spec
        want = PLAN.local_slice(whole.data, rank)
        for a, b in zip((*tile.data.entries, tile.data.nnz),
                        (*want.entries, want.nnz)):
            assert torch.equal(a, b)
        # an owner-routed append is the tile of the global append
        grown = tile.append(ar, ac, av)
        want = PLAN.local_slice(whole.append(ar, ac, av).data, rank)
        for a, b in zip((*grown.data.entries, grown.data.nnz),
                        (*want.entries, want.nnz)):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(grown.seen_coo[0],
                                      whole.append(ar, ac, av).seen_coo[0])


def test_dense_append_and_with_plan_route_the_same_way(monkeypatch):
    (rows, cols, vals), (ar, ac, av), _, _ = _data()
    whole = CompletionProblem.from_entries(rows, cols, vals, (M, N), P, Q, R,
                                           layout="dense", device="cpu")
    grown = whole.append(ar, ac, av)
    one = whole.with_plan(MeshPlan.build(P, Q))
    assert one.plan.is_single_device and torch.equal(one.data.xb,
                                                     whole.data.xb)
    assert one.with_plan(None).plan is None
    for rank in range(4):
        monkeypatch.setattr("repro_torch.mesh.plan.current_rank",
                            lambda r=rank: r)
        tile = whole.with_plan(GRID)
        got = tile.append(ar, ac, av)
        want = PLAN.local_slice(grown.data, rank)
        assert torch.equal(got.data.xb, want.xb)
        assert torch.equal(got.data.maskb, want.maskb)
        with pytest.raises(ValueError, match="holds one tile"):
            tile.with_plan(GRID)
    # total_cost_device on one process is total_cost's, as a tensor
    st = init_state(torch.Generator().manual_seed(1), whole.spec)
    c = whole.total_cost_device(st, 1e-3)
    assert isinstance(c, torch.Tensor) and float(c) == whole.total_cost(
        st, 1e-3)


# ---------------------------------------------------------------------- #
# one 2x2 gloo grid
# ---------------------------------------------------------------------- #


def _grid_rank(rank, device):
    (rows, cols, vals), (ar, ac, av), _, _ = _data()
    cfg = GossipMCConfig(m=M, n=N, p=P, q=Q, rank=R, **HP)
    routed = CompletionProblem.from_entries(rows, cols, vals, (M, N), P, Q,
                                            R, headroom=64, plan=GRID,
                                            device=device)
    sliced = CompletionProblem.from_entries(
        rows, cols, vals, (M, N), P, Q, R, headroom=64,
        device=device).with_plan(GRID)
    st0 = init_state(torch.Generator().manual_seed(0), routed.spec)
    out = {"rank": rank,
           "tile": [t.numpy() for t in (*routed.data.entries,
                                        routed.data.nnz)],
           "sliced": [t.numpy() for t in (*sliced.data.entries,
                                          sliced.data.nnz)],
           "cost": float(routed.total_cost_device(st0, cfg.lam))}
    grown = routed.append(ar, ac, av)
    out["grown"] = [t.numpy() for t in (*grown.data.entries,
                                        grown.data.nnz)]
    sched = Gossip(num_rounds=12, eval_every=6)
    a = Trainer(cfg).fit(routed, sched, state=st0)
    b = Trainer(cfg).fit(sliced, sched, state=st0)
    out["bitwise"] = bool(torch.equal(a.state.U, b.state.U)
                          and torch.equal(a.state.W, b.state.W))
    out["U"], out["W"] = a.state.U.numpy(), a.state.W.numpy()
    out["history"] = a.history
    return out


@pytest.fixture(scope="module")
def grid():
    t0 = time.monotonic()
    outs = tlaunch.run_on_grid(_grid_rank, GRID, device="cpu",
                               timeout=GRID_TIMEOUT)
    assert time.monotonic() - t0 < GRID_TIMEOUT
    return outs


def _whole():
    (rows, cols, vals), (ar, ac, av), _, _ = _data()
    problem = CompletionProblem.from_entries(rows, cols, vals, (M, N), P, Q,
                                             R, headroom=64, device="cpu")
    return problem, problem.append(ar, ac, av)


@pytest.mark.parametrize("rank", range(4))
def test_grid_routed_ingest_and_append_are_the_global_tiles(grid, rank):
    problem, grown = _whole()
    out = grid[rank]
    want = PLAN.local_slice(problem.data, rank)
    for got, sl, w in zip(out["tile"], out["sliced"], (*want.entries,
                                                       want.nnz)):
        np.testing.assert_array_equal(got, w.numpy())
        np.testing.assert_array_equal(sl, w.numpy())
    want = PLAN.local_slice(grown.data, rank)
    for got, w in zip(out["grown"], (*want.entries, want.nnz)):
        np.testing.assert_array_equal(got, w.numpy())


def test_grid_total_cost_device_is_the_whole_grids(grid):
    problem, _ = _whole()
    st0 = init_state(torch.Generator().manual_seed(0), problem.spec)
    want = problem.total_cost(st0, HP["lam"])
    for out in grid:
        assert out["cost"] == pytest.approx(want, rel=RTOL)


def test_grid_gossip_on_routed_store_is_the_sliced_fit_and_1x1(grid):
    problem, _ = _whole()
    st0 = init_state(torch.Generator().manual_seed(0), problem.spec)
    cfg = GossipMCConfig(m=M, n=N, p=P, q=Q, rank=R, **HP)
    one = Trainer(cfg).fit(problem, Gossip(num_rounds=12, eval_every=6),
                           state=st0)
    assert all(out["bitwise"] for out in grid)
    for out in grid:
        assert float(np.abs(out["U"] - one.state.U.numpy()).max()) < 1e-5
        assert float(np.abs(out["W"] - one.state.W.numpy()).max()) < 1e-5
        np.testing.assert_allclose([c for _, c in out["history"]],
                                   [c for _, c in one.history], rtol=1e-4)
