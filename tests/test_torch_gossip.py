"""The port's synchronous gossip against the JAX package's, on the CPU.

* ``MeshPlan`` geometry (owners, local blocks, edge counts, ``describe``)
  against the JAX plan on forced host devices, run in a subprocess (jax
  fixes the device count at first init), and the validation errors.
* ``core/compress.py`` against ``repro.core.compress`` on seeded inputs:
  int8 codes and scales exactly, values to 1e-6; top-k inputs have
  distinct values.
* ``Gossip`` on the 1×1 plan: bitwise equal to the port's ``FullGD`` (the
  same ops in the same order), and against JAX ``Gossip`` from the JAX
  package's initial ``State`` to the reference's own distributed-test
  tolerance: max |ΔU|, |ΔW| < 1e-5 and the cost to rel 1e-4.
* ``Gossip`` on a 2×2 grid of four ``gloo`` CPU processes
  (``repro_torch.launch.gossip``) against JAX ``Gossip`` on four forced
  host devices in a subprocess, from the same ``State``, to the same
  tolerance; the halo-byte counter equal to the JAX one.

Every subprocess and every rank grid has a timeout of its own.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import mc as jmc  # noqa: E402
from repro.config import GossipMCConfig as JConfig  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core import gossip as jgossip  # noqa: E402
from repro.core import grid as jgrid  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.data import lowrank_problem as j_lowrank  # noqa: E402
from repro.mesh import MeshPlan as JPlan  # noqa: E402
from repro_torch import mc as tmc  # noqa: E402
from repro_torch.config import GossipMCConfig as TConfig  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import gossip as tgossip  # noqa: E402
from repro_torch.faults import FaultPlan  # noqa: E402
from repro_torch.launch import gossip as tlaunch  # noqa: E402
from repro_torch.mesh import MeshPlan  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U_ATOL = 1e-5        # tests/test_distributed.py: max |ΔU| after the rounds
COST_RTOL = 1e-4     # tests/test_distributed.py: relative cost
SUBPROCESS_TIMEOUT = 300
GRID_TIMEOUT = 180

GEOMETRIES = [(4, 4, 1, 1), (4, 4, 2, 2), (4, 2, 4, 2), (6, 6, 3, 2)]
M, N, R = 48, 40, 3
HP = dict(rho=1e3, lam=1e-6, a=5e-4, b=5e-7)


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


def _geometry(plan, owner):
    R_, C_ = plan.row_size, plan.col_size
    return {
        "row_size": R_, "col_size": C_, "num_devices": plan.num_devices,
        "single": plan.is_single_device,
        "bpr": plan.blocks_per_row_shard, "bpc": plan.blocks_per_col_shard,
        "edges": [plan.num_u_edges, plan.num_w_edges, plan.num_halo_edges],
        "owner_coords": [[list(plan.owner_coords(i, j))
                          for j in range(plan.q)] for i in range(plan.p)],
        "owner": [[owner(plan, i, j) for j in range(plan.q)]
                  for i in range(plan.p)],
        "block_owners": plan.block_owners().tolist(),
        "local_blocks": [[[list(b) for b in plan.local_blocks(di, dj)]
                          for dj in range(C_)] for di in range(R_)],
        "describe": plan.describe(),
    }


@pytest.fixture(scope="module")
def jax_geometry():
    """The JAX plan's geometry for every case, on 8 forced host devices;
    ``owner`` as the flat index of the owning device in the mesh."""

    prog = f"""
    import json
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.mesh import MeshPlan
    out = {{}}
    for p, q, R, C in {GEOMETRIES!r}:
        devs = jax.devices()[:R * C]
        mesh = Mesh(np.asarray(devs).reshape(R, C), ("data", "model"))
        plan = MeshPlan.build(p, q, mesh=mesh)
        flat = list(plan.mesh.devices.reshape(-1))
        out[f"{{p}},{{q}},{{R}},{{C}}"] = {{
            "row_size": plan.row_size, "col_size": plan.col_size,
            "num_devices": plan.num_devices,
            "single": plan.is_single_device,
            "bpr": plan.blocks_per_row_shard,
            "bpc": plan.blocks_per_col_shard,
            "edges": [plan.num_u_edges, plan.num_w_edges,
                      plan.num_halo_edges],
            "owner_coords": [[list(plan.owner_coords(i, j))
                              for j in range(q)] for i in range(p)],
            "owner": [[flat.index(plan.owner(i, j)) for j in range(q)]
                      for i in range(p)],
            "block_owners": plan.block_owners().tolist(),
            "local_blocks": [[[list(b) for b in plan.local_blocks(di, dj)]
                              for dj in range(C)] for di in range(R)],
            "describe": plan.describe(),
        }}
    try:
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                    ("data", "model"))
        MeshPlan.build(5, 4, mesh=mesh)
    except ValueError as e:
        out["tiling_error"] = str(e)
    print("JSON" + json.dumps(out))
    """
    line = [ln for ln in run_jax(prog, 8).splitlines()
            if ln.startswith("JSON")][-1]
    return json.loads(line[4:])


@pytest.mark.parametrize("p,q,R_,C_", GEOMETRIES)
def test_plan_geometry_equals_jax(jax_geometry, p, q, R_, C_):
    plan = MeshPlan.build(p, q, grid=(R_, C_))
    got = _geometry(plan, lambda pl, i, j: pl.owner(i, j))
    assert got == jax_geometry[f"{p},{q},{R_},{C_}"]


def test_plan_validation_errors_match_jax(jax_geometry):
    with pytest.raises(ValueError) as got:
        MeshPlan.build(5, 4, grid=(2, 2))
    # the reference names shard_map where the port names ranks
    assert str(got.value).split(" (")[0] == \
        jax_geometry["tiling_error"].split(" (")[0]
    plan = MeshPlan.build(4, 4, grid=(2, 2))
    assert MeshPlan.build(4, 4, plan) is plan
    with pytest.raises(ValueError) as got:
        MeshPlan.build(4, 2, plan)
    with pytest.raises(ValueError) as want:
        JPlan.build(4, 2, mesh=JPlan.build(4, 4))
    assert str(got.value) == str(want.value)
    with pytest.raises(IndexError, match="outside the 4x4 grid"):
        plan.owner(4, 0)


def test_single_rank_plan_equals_jax_single_device_plan():
    got = _geometry(MeshPlan.build(3, 2), lambda pl, i, j: pl.owner(i, j))
    jplan = JPlan.build(3, 2)
    want = _geometry(jplan, lambda pl, i, j: 0)
    assert got == want


@pytest.mark.parametrize("rank", range(4))
def test_local_slice_cuts_each_ranks_tile(rank):
    plan = MeshPlan.build(4, 4, grid=(2, 2))
    ds = tmc.CompletionProblem.from_dataset(
        _t_lowrank(), 4, 4, R, layout="sparse", device="cpu")
    tile = plan.local_slice(ds.data, rank)
    di, dj = divmod(rank, 2)
    blocks = plan.local_blocks(di, dj)
    for got, full in zip(tile.entries, ds.data.entries):
        assert got.shape[:2] == (2, 2) and got.is_contiguous()
        for (i, j) in blocks:
            assert torch.equal(got[i - 2 * di, j - 2 * dj], full[i, j])
    assert torch.equal(tile.nnz, ds.data.nnz[2 * di:2 * di + 2,
                                              2 * dj:2 * dj + 2])


def test_placed_problem_keeps_only_its_tile_and_refuses_other_schedules():
    plan = MeshPlan.build(4, 4, grid=(2, 2))
    full = tmc.CompletionProblem.from_dataset(_t_lowrank(), 4, 4, R,
                                              device="cpu")
    placed = tmc.CompletionProblem.from_dataset(_t_lowrank(), 4, 4, R,
                                                plan=plan, device="cpu")
    assert placed.plan == plan and placed.spec == full.spec
    assert torch.equal(placed.data.xb, full.data.xb[:2, :2])
    with pytest.raises(ValueError, match="only the Gossip schedule"):
        tmc.Trainer(TConfig(m=M, n=N, p=4, q=4, rank=R)).fit(
            placed, tmc.FullGD(num_rounds=1))


@pytest.mark.parametrize("R_,C_", [(1, 1), (2, 2), (4, 2), (3, 2)])
@pytest.mark.parametrize("compression", ["none", "int8", "topk"])
def test_halo_bytes_per_round_equals_jax(R_, C_, compression):
    p, q = 12, 8
    got = tgossip.halo_bytes_per_round(MeshPlan.build(p, q, grid=(R_, C_)),
                                       30, 20, 5, compression)
    want = jgossip.halo_bytes_per_round(JPlan.build(p, q), 30, 20, 5,
                                        compression, grid=(R_, C_))
    assert got == want
    if (R_, C_) == (1, 1):
        assert got["total_bytes"] == 0


def test_exchange_rounds_in_equals_jax():
    for start in range(0, 9):
        for n in range(0, 9):
            for every in (1, 2, 3, 5):
                assert tgossip.exchange_rounds_in(start, n, every) == \
                    jgossip.exchange_rounds_in(start, n, every)


# ---------------------------------------------------------------------- #
# compression
# ---------------------------------------------------------------------- #


def _msg(seed, shape=(3, 17, 5), distinct=False):
    rng = np.random.default_rng(seed)
    if distinct:      # top-k needs a strict order of magnitudes
        mags = rng.permutation(np.arange(1, np.prod(shape) + 1))
        x = mags * rng.choice([-1.0, 1.0], size=mags.shape) / mags.size
        return x.reshape(shape).astype(np.float32)
    return (rng.normal(size=shape) * 2.0).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_int8_codes_and_scale_equal_jax(seed):
    x = _msg(seed)
    q, s = tcompress.int8_compress(torch.from_numpy(x.copy()))
    jq, js = jcompress.int8_compress(jax.numpy.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_allclose(
        tcompress.int8_decompress(q, s).numpy(),
        np.asarray(jcompress.int8_decompress(jq, js)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("fraction", [0.05, 0.25, 0.5])
def test_topk_mask_equals_jax(fraction):
    x = _msg(7, distinct=True)
    got = tcompress.topk_mask(torch.from_numpy(x.copy()), fraction).numpy()
    want = np.asarray(jcompress.topk_mask(jax.numpy.asarray(x), fraction))
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["none", "int8", "topk"])
def test_compress_message_with_error_feedback_equals_jax(method):
    shape = (2, 11, 4)
    t_st = tcompress.init_state(shape, device="cpu")
    j_st = jcompress.init_state(shape)
    for rnd in range(5):
        x = _msg(100 + rnd, shape, distinct=(method == "topk"))
        sent, t_st = tcompress.compress_message(
            torch.from_numpy(x.copy()), method, t_st, topk_fraction=0.3)
        jsent, j_st = jcompress.compress_message(
            jax.numpy.asarray(x), method, j_st, topk_fraction=0.3)
        np.testing.assert_allclose(sent.numpy(), np.asarray(jsent), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(t_st.residual.numpy(),
                                   np.asarray(j_st.residual), rtol=0,
                                   atol=1e-6)
    for n in (1, 7, 1000):
        assert tcompress.message_bytes_n(n, method, 0.3) == \
            jcompress.message_bytes_n(n, method, 0.3)
    with pytest.raises(ValueError):
        tcompress.compress_message(torch.zeros(3), "fp4")


# ---------------------------------------------------------------------- #
# Gossip on the 1x1 plan
# ---------------------------------------------------------------------- #


def _t_lowrank():
    from repro_torch.data import lowrank_problem

    return lowrank_problem(M, N, R, density=0.3, seed=0)


def _problems(layout, p=4, q=4):
    jp = jmc.CompletionProblem.from_dataset(
        j_lowrank(M, N, R, density=0.3, seed=0), p, q, R, layout=layout)
    tp = tmc.CompletionProblem.from_dataset(_t_lowrank(), p, q, R,
                                            layout=layout, device="cpu")
    return jp, tp


def _state0(p=4, q=4):
    st = jstate.init_state(jax.random.PRNGKey(0),
                           jgrid.GridSpec(M, N, p, q, R))
    return st, tuple(np.asarray(x) for x in st)


def _close(got_u, got_w, want_u, want_w):
    assert float(np.abs(got_u - np.asarray(want_u)).max()) < U_ATOL
    assert float(np.abs(got_w - np.asarray(want_w)).max()) < U_ATOL


@pytest.mark.parametrize("staleness", [1, 2])
@pytest.mark.parametrize("compression", ["none", "int8"])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_gossip_1x1_equals_fullgd_and_jax_gossip(layout, compression,
                                                 staleness):
    jp, tp = _problems(layout)
    js0, np0 = _state0()
    kw = dict(num_rounds=40, eval_every=20)
    sched = dict(staleness=staleness, compression=compression)
    jres = jmc.Trainer(JConfig(m=M, n=N, p=4, q=4, rank=R, **HP)).fit(
        jp, jmc.Gossip(**kw, **sched), state=js0)
    trainer = tmc.Trainer(TConfig(m=M, n=N, p=4, q=4, rank=R, **HP))
    got = trainer.fit(tp, tmc.Gossip(**kw, **sched),
                      state=state_from_numpy(*np0, "cpu"))
    full = trainer.fit(tp, tmc.FullGD(**kw),
                       state=state_from_numpy(*np0, "cpu"))
    assert got.schedule == "gossip"
    assert torch.equal(got.state.U, full.state.U)
    assert torch.equal(got.state.W, full.state.W)
    assert got.history == full.history
    assert got.t == jres.t
    _close(got.state.U.numpy(), got.state.W.numpy(), jres.state.U,
           jres.state.W)
    np.testing.assert_allclose([c for _, c in got.history],
                               [c for _, c in jres.history], rtol=COST_RTOL)


def test_gossip_schedule_registry_and_counters():
    from repro_torch import obs

    assert isinstance(tmc.make_schedule("gossip", num_rounds=3),
                      tmc.Gossip)
    _, tp = _problems("sparse")
    _, np0 = _state0()
    obs.reset()
    tmc.Trainer(TConfig(m=M, n=N, p=4, q=4, rank=R, **HP)).fit(
        tp, "gossip", num_rounds=6, eval_every=4,
        state=state_from_numpy(*np0, "cpu"))
    assert obs.counter("train_gossip_rounds_total").value == 6
    assert obs.counter("train_gossip_halo_bytes_total").value == 0
    assert obs.histogram("train_gossip_round_seconds").count == 2


@pytest.mark.parametrize("kw,kind", [
    (dict(faults=FaultPlan(p_drop_edge=0.5)), None),
    (dict(async_rounds=True), None),
    (dict(async_rounds=True, exchange_every=2), None),
    (dict(exchange_every=2), ValueError),
    (dict(async_rounds=True, staleness=2), ValueError),
    (dict(batch=64), ValueError),
    (dict(batch=64, layout="sparse", steps_per_call=2), ValueError),
    (dict(faults=object(), compression="int8"), ValueError),
])
def test_unported_and_invalid_options_raise_like_the_reference(kw, kind):
    """``faults=`` and ``async_rounds`` (the options this file once pinned
    as unported) build a step that runs a round; invalid options raise
    the reference's ``ValueError`` word for word."""

    cfg = TConfig(m=M, n=N, p=4, q=4, rank=R, **HP)
    if kind is None:
        step = tgossip.make_gossip_step((4, 4), cfg, **kw)
        _, tp = _problems("dense")
        _, np0 = _state0()
        carry = tgossip.init_carry(state_from_numpy(*np0, "cpu"))
        out = step(tp.data, carry)
        assert out.rnd == 1 and int(out.state.t) == tp.spec.num_structures
        assert not torch.equal(out.state.U, carry.state.U)
        return
    with pytest.raises(kind) as got:
        tgossip.make_gossip_step((4, 4), cfg, **kw)
    with pytest.raises(ValueError) as want:
        jgossip.make_gossip_step(None, (4, 4), JConfig(m=M, n=N, p=4, q=4,
                                                       rank=R), **kw)
    assert str(got.value) == str(want.value)


def test_minibatch_step_builds_and_takes_problem_f_scale_carry():
    """``batch=`` on the sparse layout is ported: the step takes one
    minibatch store, the (p, q) f-scale and the carry, and runs a round."""

    import inspect

    from repro_torch import sparse as tsparse

    cfg = TConfig(m=M, n=N, p=4, q=4, rank=R, **HP)
    step = tgossip.make_gossip_step((4, 4), cfg, batch=64, layout="sparse")
    assert list(inspect.signature(step).parameters) == ["problem", "f_scale",
                                                         "carry"]
    _, tp = _problems("sparse")
    _, np0 = _state0()
    carry = tgossip.init_carry(state_from_numpy(*np0, "cpu"))
    mbat = tsparse.MinibatchStream(tp.data, 64, seed=0).batch_at(0)
    out = step(mbat, tsparse.minibatch_grad_scale(tp.data, 64), carry)
    assert out.rnd == 1 and int(out.state.t) == tp.spec.num_structures
    assert not torch.equal(out.state.U, carry.state.U)


def test_gossip_schedule_raises_for_unported_options():
    """The schedule runs ``faults=`` and ``async_rounds`` (once unported)
    for a round on the 1×1 plan, bitwise the plain round there (no edge
    exists, so no event counts); ``batch=`` on the dense layout still
    raises."""

    _, tp = _problems("dense")
    _, np0 = _state0()
    trainer = tmc.Trainer(TConfig(m=M, n=N, p=4, q=4, rank=R, **HP))
    plain = trainer.fit(tp, tmc.Gossip(num_rounds=1),
                        state=state_from_numpy(*np0, "cpu"))
    for kw in (dict(faults=FaultPlan(p_drop_edge=0.5)),
               dict(async_rounds=True, exchange_every=2), dict(batch=8)):
        if "batch" in kw:
            with pytest.raises(ValueError, match="layout='sparse'"):
                trainer.fit(tp, tmc.Gossip(num_rounds=1, **kw))
            continue
        got = trainer.fit(tp, tmc.Gossip(num_rounds=1, **kw),
                          state=state_from_numpy(*np0, "cpu"))
        assert torch.equal(got.state.U, plain.state.U)
        assert got.history == plain.history


# ---------------------------------------------------------------------- #
# Gossip on a 2x2 grid of gloo processes against JAX on 4 host devices
# ---------------------------------------------------------------------- #

GRID_CASES = [
    # layout, compression, staleness, rounds, eval_every
    ("dense", "none", 1, 120, 60),
    ("sparse", "int8", 2, 120, 120),
]


def _jax_grid_run(tmp_path, layout, compression, staleness, rounds,
                  eval_every):
    out = tmp_path / "jax.npz"
    prog = f"""
    import json
    import jax, numpy as np
    from repro import mc, obs
    from repro.compat import make_mesh
    from repro.config import GossipMCConfig
    from repro.core import grid as G, state as S
    from repro.data import lowrank_problem
    assert len(jax.devices()) == 4
    cfg = GossipMCConfig(m={M}, n={N}, p=4, q=4, rank={R}, **{HP!r})
    prob = mc.CompletionProblem.from_dataset(
        lowrank_problem({M}, {N}, {R}, density=0.3, seed=0), 4, 4, {R},
        layout={layout!r})
    st0 = S.init_state(jax.random.PRNGKey(0), G.GridSpec({M}, {N}, 4, 4,
                                                         {R}))
    mesh = make_mesh((2, 2), ("data", "model"))
    obs.reset()
    res = mc.Trainer(cfg).fit(prob, mc.Gossip(
        num_rounds={rounds}, eval_every={eval_every}, mesh=mesh,
        staleness={staleness}, compression={compression!r}), state=st0)
    np.savez({str(out)!r}, U0=np.asarray(st0.U), W0=np.asarray(st0.W),
             U=np.asarray(res.state.U), W=np.asarray(res.state.W),
             hist=np.asarray([c for _, c in res.history]),
             ts=np.asarray([t for t, _ in res.history]),
             halo=obs.counter("train_gossip_halo_bytes_total").value)
    """
    run_jax(prog, 4)
    return np.load(out)


@pytest.mark.parametrize("layout,compression,staleness,rounds,eval_every",
                         GRID_CASES)
def test_gossip_2x2_gloo_grid_equals_jax_on_four_devices(
        tmp_path, layout, compression, staleness, rounds, eval_every):
    want = _jax_grid_run(tmp_path, layout, compression, staleness, rounds,
                         eval_every)
    recipe = tlaunch.ProblemRecipe(
        "lowrank_problem", dict(m=M, n=N, r=R, density=0.3, seed=0),
        p=4, q=4, rank=R, layout=layout)
    t0 = time.monotonic()
    got, = tlaunch.fit_on_grid(
        [tlaunch.FitJob(recipe, TConfig(m=M, n=N, p=4, q=4, rank=R, **HP),
                        tmc.Gossip(num_rounds=rounds, eval_every=eval_every,
                                   staleness=staleness,
                                   compression=compression),
                        state=(want["U0"], want["W0"], 0))],
        grid=(2, 2), device="cpu", timeout=GRID_TIMEOUT)
    assert time.monotonic() - t0 < GRID_TIMEOUT
    assert got["backend"] == "gloo" and not got["staged"]
    assert sum(got["launches"].values()) == 0     # CPU: the plain versions
    _close(got["U"], got["W"], want["U"], want["W"])
    assert [t for t, _ in got["history"]] == want["ts"].tolist()
    np.testing.assert_allclose([c for _, c in got["history"]], want["hist"],
                               rtol=COST_RTOL)
    exchanges = -(-eval_every // staleness) * (rounds // eval_every)
    per_round = tgossip.halo_bytes_per_round(
        MeshPlan.build(4, 4, grid=(2, 2)), M // 4, N // 4, R,
        compression)["total_bytes"]
    assert got["counters"]["train_gossip_halo_bytes_total"] == \
        exchanges * per_round == float(want["halo"])


def _fail_on_rank_2(rank, device):
    if rank == 2:
        raise RuntimeError("rank 2 gives up")
    torch.distributed.barrier()


def _hang(rank, device):
    time.sleep(600)


def test_grid_launcher_reports_a_failed_rank_and_a_hung_grid():
    with pytest.raises(RuntimeError, match="rank 2 gives up"):
        tlaunch.run_on_grid(_fail_on_rank_2, (2, 2), device="cpu",
                            timeout=GRID_TIMEOUT)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        tlaunch.run_on_grid(_hang, (1, 2), device="cpu", timeout=10)
    assert time.monotonic() - t0 < 40


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_grid_launcher_leaves_no_process_behind_at_exit(tmp_path):
    # a program that ran a grid and ends without calling shutdown: the
    # forkserver and the resource tracker must be gone when it has exited
    prog = """
        import multiprocessing.forkserver as fs
        import multiprocessing.resource_tracker as rt
        from repro_torch.launch.gossip import run_on_grid

        def rank_id(rank, device):
            return rank

        if __name__ == "__main__":
            assert run_on_grid(rank_id, (1, 2), device="cpu",
                               timeout=60) == [0, 1]
            print(fs._forkserver._forkserver_pid,
                  rt._resource_tracker._pid)
    """
    path = tmp_path / "grid_exit.py"      # a file: the ranks import it
    path.write_text(textwrap.dedent(prog))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, str(path)], capture_output=True,
                         text=True, env=env, timeout=SUBPROCESS_TIMEOUT)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    pids = [int(x) for x in out.stdout.split()]
    assert len(pids) == 2
    assert not [pid for pid in pids if _alive(pid)]


def test_grid_launcher_shutdown_stops_its_helpers_and_a_later_grid_runs():
    import multiprocessing.forkserver as fs
    import multiprocessing.resource_tracker as rt

    assert tlaunch.run_on_grid(_rank_id, (1, 2), device="cpu",
                               timeout=GRID_TIMEOUT) == [0, 1]
    pids = [fs._forkserver._forkserver_pid, rt._resource_tracker._pid]
    assert all(pids)
    tlaunch.shutdown()
    assert not [pid for pid in pids if _alive(pid)]
    assert tlaunch.run_on_grid(_rank_id, (1, 2), device="cpu",
                               timeout=GRID_TIMEOUT) == [0, 1]
    tlaunch.shutdown()


def _rank_id(rank, device):
    return rank
