"""The port's asynchronous gossip rounds against the JAX package's, on the
CPU, and the bitwise identities of the fault/async path.

* ``Gossip(async_rounds=True, exchange_every=3, max_staleness=2)`` on a
  2×2 grid of four ``gloo`` CPU processes against JAX ``Gossip`` on four
  forced host devices from the same state: U and W within ``U_ATOL``,
  costs within ``COST_RTOL`` (the reference's distributed-test
  tolerances); the skipped-exchange, stale-round and halo-byte counters
  and the halo-age histogram **exactly** equal, and the skips equal to
  ``rounds − ceil(rounds / e)``.
* Bitwise, within the port: async with ``exchange_every=1,
  max_staleness=0`` against the synchronous fit, and ``FaultPlan`` with
  p = 0 against ``faults=None``, on both layouts; a synchronous fit
  (staleness 1) stopped after its second checkpoint and resumed with
  ``resume_from=`` against the uninterrupted one, full-gradient and with
  ``batch=``.

Every subprocess and rank grid has a timeout of its own.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import faults as tfaults  # noqa: E402
from repro_torch import mc as tmc  # noqa: E402
from repro_torch.config import GossipMCConfig as TConfig  # noqa: E402
from repro_torch.core import gossip as tgossip  # noqa: E402
from repro_torch.launch import gossip as tlaunch  # noqa: E402
from repro_torch.mesh import MeshPlan  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U_ATOL = 1e-5        # tests/test_distributed.py: max |ΔU| after the rounds
COST_RTOL = 1e-4     # tests/test_distributed.py: relative cost
SUBPROCESS_TIMEOUT = 300
GRID_TIMEOUT = 180

M, N, R = 48, 40, 3
HP = dict(rho=1e3, lam=1e-6, a=5e-4, b=5e-7)
ROUNDS, EVAL = 60, 20
EVERY, BOUND = 3, 2
BATCH = 32


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


def _recipe(layout):
    return tlaunch.ProblemRecipe(
        "lowrank_problem", dict(m=M, n=N, r=R, density=0.3, seed=0),
        p=4, q=4, rank=R, layout=layout)


CFG = TConfig(m=M, n=N, p=4, q=4, rank=R, **HP)


@pytest.fixture(scope="module")
def jax_async(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_async") / "jax.npz"
    prog = f"""
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
        layout="sparse")
    st0 = S.init_state(jax.random.PRNGKey(0), G.GridSpec({M}, {N}, 4, 4,
                                                         {R}))
    mesh = make_mesh((2, 2), ("data", "model"))
    obs.reset()
    res = mc.Trainer(cfg).fit(prob, mc.Gossip(
        num_rounds={ROUNDS}, eval_every={EVAL}, mesh=mesh,
        async_rounds=True, exchange_every={EVERY},
        max_staleness={BOUND}), state=st0)
    snap = obs.snapshot()
    ages = snap["histograms"]["gossip_halo_age"]
    np.savez({str(out)!r}, U0=np.asarray(st0.U), W0=np.asarray(st0.W),
             U=np.asarray(res.state.U), W=np.asarray(res.state.W),
             hist=np.asarray([c for _, c in res.history]),
             ts=np.asarray([t for t, _ in res.history]),
             counters=np.asarray([snap["counters"].get(k, 0.0) for k in (
                 "gossip_skipped_exchanges_total",
                 "gossip_stale_rounds_total",
                 "train_gossip_halo_bytes_total",
                 "gossip_edges_dropped_total")]),
             ages=np.asarray([ages["count"], ages["sum"]]))
    """
    run_jax(prog, 4)
    return dict(np.load(out))


def _gossip(**kw):
    return tmc.Gossip(num_rounds=ROUNDS, eval_every=EVAL, **kw)


@pytest.fixture(scope="module")
def port_grid(jax_async, tmp_path_factory):
    """One grid for every case: [async vs JAX, then per layout: sync,
    async e=1, faults p=0; then sync stop/resume and batch stop/resume,
    each after its uninterrupted twin]."""

    ck = tmp_path_factory.mktemp("checkpoints")
    st0 = (jax_async["U0"], jax_async["W0"], 0)
    jobs = [tlaunch.FitJob(_recipe("sparse"), CFG, _gossip(
        async_rounds=True, exchange_every=EVERY, max_staleness=BOUND),
        state=st0)]
    for layout in ("sparse", "dense"):
        jobs += [tlaunch.FitJob(_recipe(layout), CFG, s, state=st0) for s in (
            _gossip(), _gossip(async_rounds=True, max_staleness=0),
            _gossip(faults=tfaults.FaultPlan(key=5)))]
    for name, sched in (("full", _gossip(max_staleness=1)),
                        ("batch", _gossip(max_staleness=1, batch=BATCH))):
        d = str(ck / name)
        jobs += [
            tlaunch.FitJob(_recipe("sparse"), CFG, sched, state=st0),
            tlaunch.FitJob(_recipe("sparse"), CFG, sched, state=st0,
                           callbacks=(tmc.Checkpoint(d),
                                      tlaunch.StopAt(2 * EVAL))),
            tlaunch.FitJob(_recipe("sparse"), CFG, sched, state=st0,
                           resume_from=d)]
    return tlaunch.fit_on_grid(jobs, grid=(2, 2), device="cpu",
                               timeout=GRID_TIMEOUT)


def _bitwise(a, b):
    return np.array_equal(a["U"], b["U"]) and np.array_equal(a["W"], b["W"])


def test_async_2x2_grid_equals_jax_on_four_devices(jax_async, port_grid):
    got, want = port_grid[0], jax_async
    assert float(np.abs(got["U"] - want["U"]).max()) < U_ATOL
    assert float(np.abs(got["W"] - want["W"]).max()) < U_ATOL
    assert [t for t, _ in got["history"]] == want["ts"].tolist()
    np.testing.assert_allclose([c for _, c in got["history"]], want["hist"],
                               rtol=COST_RTOL)


def test_async_skip_stale_and_halo_counters_equal_jax(jax_async, port_grid):
    c = port_grid[0]["counters"]
    got = [c["gossip_skipped_exchanges_total"],
           c["gossip_stale_rounds_total"],
           c["train_gossip_halo_bytes_total"],
           c["gossip_edges_dropped_total"]]
    assert got == jax_async["counters"].tolist()
    assert got[0] == ROUNDS - -(-ROUNDS // EVERY)
    per_round = tgossip.halo_bytes_per_round(
        MeshPlan.build(4, 4, grid=(2, 2)), M // 4, N // 4, R)["total_bytes"]
    assert got[2] == -(-ROUNDS // EVERY) * per_round
    ages = port_grid[0]["halo_age"]
    assert [ages["count"], ages["sum"]] == jax_async["ages"].tolist()


@pytest.mark.parametrize("layout,offset", [("sparse", 1), ("dense", 4)])
def test_async_e1_and_p0_faults_are_bitwise_the_synchronous_fit(
        port_grid, layout, offset):
    sync, e1, p0 = port_grid[offset:offset + 3]
    assert _bitwise(sync, e1) and _bitwise(sync, p0)
    assert sync["history"] == e1["history"] == p0["history"]
    assert p0["counters"]["gossip_edges_dropped_total"] == 0
    assert e1["counters"]["gossip_skipped_exchanges_total"] == 0
    assert e1["counters"]["train_gossip_halo_bytes_total"] == \
        sync["counters"]["train_gossip_halo_bytes_total"]


@pytest.mark.parametrize("offset", [7, 10], ids=["full", "batch"])
def test_stopped_and_resumed_grid_fit_is_bitwise_uninterrupted(port_grid,
                                                               offset):
    whole, stopped, resumed = port_grid[offset:offset + 3]
    assert stopped["stopped_at"] == 2 * EVAL and "U" not in stopped
    rounds = resumed["counters"]["train_gossip_rounds_total"]
    assert rounds == ROUNDS - 2 * EVAL
    assert _bitwise(whole, resumed)
    assert resumed["history"] == whole["history"][2:]


def test_async_options_compose_and_validate():
    cfg = CFG
    step = tgossip.make_gossip_step((4, 4), cfg, async_rounds=True,
                                    exchange_every=2, batch=8,
                                    layout="sparse")
    assert callable(step)
    with pytest.raises(ValueError, match="exchange_every must be >= 1"):
        tgossip.make_gossip_step((4, 4), cfg, async_rounds=True,
                                 exchange_every=0)
    for start in range(5):
        for n in range(7):
            want = sum(1 for r in range(start, start + n) if r % 3 == 0)
            assert tgossip.exchange_rounds_in(start, n, 3) == want


def test_gossip_async_bench_twin_smoke_runs_on_a_cpu_grid(tmp_path):
    """``python -m repro_torch.launch.gossip_async --smoke`` (the twin of
    ``benchmarks/gossip_async.py``) on a 2×2 CPU grid: every arm's skip
    accounting exact (it raises otherwise), e = 1 bit-identical."""

    import json

    from repro_torch.launch import gossip_async

    path = tmp_path / "async.json"
    gossip_async.main(["--device", "cpu", "--smoke", "--json", str(path)])
    out = json.loads(path.read_text())
    assert out["async_e1_bit_identical"] is True
    assert [r["arm"] for r in out["rows"]] == [
        "sync_full", "sync_minibatch", "async_minibatch_e2",
        "async_minibatch_e4"]
    for row in out["rows"][2:]:
        e = row["exchange_every"]
        assert row["counters"]["gossip_skipped_exchanges_total"] == \
            row["rounds"] - -(-row["rounds"] // e)
