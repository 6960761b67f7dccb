"""The port's fault injection and self-healing fits against the JAX
package's, on the CPU.

* ``FaultPlan``, ``DivergenceGuard``/``DivergenceError`` and
  ``RecoveryPolicy``: validation and error messages equal the reference's
  word for word.
* The port's fault stream (host PCG64 keyed by ``(key, restart, round,
  edge)``) is deterministic and sensitive to each; it cannot be the
  reference's threefry stream, so ``FaultPlan.from_masks`` replays the
  reference's ``replay`` output exactly.
* ``Gossip(faults=...)`` on a 2×2 grid of four ``gloo`` CPU processes,
  fed the JAX plan's replayed masks, against JAX ``Gossip(faults=
  FaultPlan(key=0, ...))`` on four forced host devices from the same
  state: U and W within ``U_ATOL``, costs within ``COST_RTOL`` (the
  reference's own distributed-test tolerances), the drop, stale and
  straggle counters and the halo-age histogram **exactly** equal, and the
  drops equal to the replay masked to existing edges.  ``nan_at`` trips
  ``DivergenceGuard`` at the same unit on both sides.
* The self-healing Wave fit: its ``recovery_log`` has the reference's
  keys and values; the guard runs before ``Checkpoint``.

Every subprocess and rank grid has a timeout of its own.
"""

import os
import subprocess
import sys
import textwrap

import jax  # noqa: F401  (JAX on the CPU before torch, as the other files)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import faults as jfaults  # noqa: E402
from repro import mc as jmc  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.config import GossipMCConfig as JConfig  # noqa: E402
from repro_torch import faults as tfaults  # noqa: E402
from repro_torch import mc as tmc  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.config import GossipMCConfig as TConfig  # noqa: E402
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
FAULTS = dict(key=0, p_drop_edge=0.2, p_straggle=0.05)
MAX_STALENESS = 1
NAN_AT, NAN_EVAL = 25, 10


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


def _message(fn):
    with pytest.raises(ValueError) as got:
        fn()
    return str(got.value)


# ---------------------------------------------------------------------- #
# validation and messages
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("kw", [dict(p_drop_edge=1.5), dict(p_straggle=-0.1),
                                dict(straggler_scale=0.5),
                                dict(nan_at=-3)])
def test_fault_plan_validation_messages_equal_jax(kw):
    assert _message(lambda: tfaults.FaultPlan(**kw)) == \
        _message(lambda: jfaults.FaultPlan(**kw))


@pytest.mark.parametrize("kw", [dict(max_restarts=-1), dict(backoff=0.0),
                                dict(backoff=1.5),
                                dict(on_divergence="retry")])
def test_recovery_policy_messages_equal_jax(kw):
    assert _message(lambda: tfaults.RecoveryPolicy(**kw)) == \
        _message(lambda: jfaults.RecoveryPolicy(**kw))


def test_guard_and_divergence_messages_equal_jax():
    assert _message(lambda: tfaults.DivergenceGuard(explode_factor=0.5)) \
        == _message(lambda: jfaults.DivergenceGuard(explode_factor=0.5))
    tcfg, jcfg = TConfig(m=M, n=N, **HP), JConfig(m=M, n=N, **HP)
    for costs, kw in (([1.0, float("nan")], {}),
                      ([1.0, 2.0], dict(max_cost=1.5)),
                      ([1.0, 0.5, 600.0], dict(explode_factor=1e3))):
        msgs = []
        for mod, cfg in ((tfaults, tcfg), (jfaults, jcfg)):
            guard = mod.DivergenceGuard(**kw)
            guard.on_fit_start(None, tmc.Wave() if mod is tfaults
                               else jmc.Wave(), cfg)
            with pytest.raises(mod.DivergenceError) as err:
                for unit, c in enumerate(costs, 1):
                    guard.on_eval(unit, c, None, None)
            msgs.append((str(err.value), err.value.unit, err.value.reason))
        assert msgs[0] == msgs[1]
    plain = (tfaults.DivergenceError(3, float("inf")),
             jfaults.DivergenceError(3, float("inf")))
    assert str(plain[0]) == str(plain[1])


# ---------------------------------------------------------------------- #
# the fault stream
# ---------------------------------------------------------------------- #


def test_port_replay_is_deterministic_and_keyed():
    fp = tfaults.FaultPlan(key=3, p_drop_edge=0.2, p_straggle=0.1)
    a, b = fp.replay(400, 4), fp.replay(400, 4)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    for other in (tfaults.FaultPlan(key=4, p_drop_edge=0.2, p_straggle=0.1),
                  fp.refold(1)):
        c = other.replay(400, 4)
        assert not np.array_equal(a["drops"], c["drops"])
    # rounds and edges each draw their own events, at the plan's rates
    assert not all(np.array_equal(a["drops"][0], a["drops"][k])
                   for k in range(1, 10))
    assert not np.array_equal(a["drops"][:, 0], a["drops"][:, 1])
    assert abs(a["drops"].mean() - 0.2) < 0.03
    assert abs(a["straggles"].mean() - 0.1) < 0.03
    d, s = fp.edge_events(17, 2)
    assert np.array_equal(d, a["drops"][17, 2])
    assert np.array_equal(s, a["straggles"][17, 2])
    assert tfaults.FaultPlan(p_drop_edge=0.0).replay(50, 4)["drops"].sum() == 0
    nan = tfaults.FaultPlan(nan_at=10)
    assert nan.nan_event(10) and not nan.nan_event(9)
    assert nan.refold(2).nan_at is None and nan.refold(2).restart == 2
    plan = MeshPlan.build(4, 4, grid=(2, 2))
    assert tfaults.FaultPlan(p_drop_edge=0.25).expected_drops(plan, 8) == \
        0.25 * plan.num_halo_edges * 8
    with pytest.raises(ValueError, match="non-negative int"):
        tfaults.FaultPlan(key=-1)


def test_from_masks_returns_the_jax_replay():
    want = jfaults.FaultPlan(**FAULTS).replay(30, 4)
    fp = tfaults.FaultPlan.from_masks(want["drops"], want["straggles"],
                                      nan_at=7)
    got = fp.replay(30, 4)
    for k in ("drops", "straggles"):
        assert np.array_equal(got[k], want[k])
    for rnd in (0, 11, 29):
        for e in range(4):
            d, s = fp.edge_events(rnd, e)
            jd, js = jfaults.FaultPlan(**FAULTS).edge_events(rnd, e)
            assert np.array_equal(d, np.asarray(jd))
            assert np.array_equal(s, np.asarray(js))
    assert fp.nan_event(7) and fp.refold(1).nan_at is None
    assert np.array_equal(fp.refold(1).replay(30, 4)["drops"], want["drops"])
    with pytest.raises(IndexError, match="outside the plan's masks"):
        fp.edge_events(30, 0)
    with pytest.raises(ValueError, match="rounds, num_edges, 4"):
        tfaults.FaultPlan.from_masks(want["drops"][0], want["straggles"][0])


# ---------------------------------------------------------------------- #
# Gossip(faults=) on a 2x2 grid against JAX on 4 host devices
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def jax_faults(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_faults") / "jax.npz"
    prog = f"""
    import jax, numpy as np
    from repro import mc, obs
    from repro.compat import make_mesh
    from repro.config import GossipMCConfig
    from repro.core import grid as G, state as S
    from repro.data import lowrank_problem
    from repro.faults import DivergenceError, DivergenceGuard, FaultPlan
    assert len(jax.devices()) == 4
    cfg = GossipMCConfig(m={M}, n={N}, p=4, q=4, rank={R}, **{HP!r})
    prob = mc.CompletionProblem.from_dataset(
        lowrank_problem({M}, {N}, {R}, density=0.3, seed=0), 4, 4, {R},
        layout="sparse")
    st0 = S.init_state(jax.random.PRNGKey(0), G.GridSpec({M}, {N}, 4, 4,
                                                         {R}))
    mesh = make_mesh((2, 2), ("data", "model"))
    fp = FaultPlan(**{FAULTS!r})
    obs.reset()
    res = mc.Trainer(cfg).fit(prob, mc.Gossip(
        num_rounds={ROUNDS}, eval_every={EVAL}, mesh=mesh, faults=fp,
        max_staleness={MAX_STALENESS}), state=st0)
    snap = obs.snapshot()
    ages = snap["histograms"]["gossip_halo_age"]
    rp = fp.replay({ROUNDS}, 4)
    try:
        mc.Trainer(cfg, callbacks=[DivergenceGuard()]).fit(prob, mc.Gossip(
            num_rounds={ROUNDS}, eval_every={NAN_EVAL}, mesh=mesh,
            faults=FaultPlan(nan_at={NAN_AT})), state=st0)
        nan = (-1, "")
    except DivergenceError as err:
        nan = (err.unit, str(err))
    np.savez({str(out)!r}, U0=np.asarray(st0.U), W0=np.asarray(st0.W),
             U=np.asarray(res.state.U), W=np.asarray(res.state.W),
             hist=np.asarray([c for _, c in res.history]),
             ts=np.asarray([t for t, _ in res.history]),
             counters=np.asarray([snap["counters"][k] for k in (
                 "gossip_edges_dropped_total", "gossip_stale_rounds_total",
                 "gossip_straggled_edges_total",
                 "train_gossip_halo_bytes_total")]),
             ages=np.asarray([ages["count"], ages["sum"]]),
             drops=rp["drops"], straggles=rp["straggles"],
             nan_unit=nan[0], nan_message=nan[1])
    """
    run_jax(prog, 4)
    return dict(np.load(out))


@pytest.fixture(scope="module")
def port_faults(jax_faults):
    recipe = tlaunch.ProblemRecipe(
        "lowrank_problem", dict(m=M, n=N, r=R, density=0.3, seed=0),
        p=4, q=4, rank=R, layout="sparse")
    cfg = TConfig(m=M, n=N, p=4, q=4, rank=R, **HP)
    st0 = (jax_faults["U0"], jax_faults["W0"], 0)
    fp = tfaults.FaultPlan.from_masks(jax_faults["drops"],
                                      jax_faults["straggles"])
    return tlaunch.fit_on_grid([
        tlaunch.FitJob(recipe, cfg, tmc.Gossip(
            num_rounds=ROUNDS, eval_every=EVAL, faults=fp,
            max_staleness=MAX_STALENESS), state=st0),
        tlaunch.FitJob(recipe, cfg, tmc.Gossip(
            num_rounds=ROUNDS, eval_every=NAN_EVAL,
            faults=tfaults.FaultPlan(nan_at=NAN_AT)), state=st0,
            callbacks=(tfaults.DivergenceGuard(),)),
    ], grid=(2, 2), device="cpu", timeout=GRID_TIMEOUT)


def test_faults_2x2_grid_equals_jax_on_four_devices(jax_faults,
                                                     port_faults):
    got, want = port_faults[0], jax_faults
    assert float(np.abs(got["U"] - want["U"]).max()) < U_ATOL
    assert float(np.abs(got["W"] - want["W"]).max()) < U_ATOL
    assert [t for t, _ in got["history"]] == want["ts"].tolist()
    np.testing.assert_allclose([c for _, c in got["history"]], want["hist"],
                               rtol=COST_RTOL)
    assert sum(got["launches"].values()) == 0     # CPU: the plain versions


def test_fault_counters_equal_jax_and_the_replay_exactly(jax_faults,
                                                         port_faults):
    c = port_faults[0]["counters"]
    got = [c["gossip_edges_dropped_total"], c["gossip_stale_rounds_total"],
           c["gossip_straggled_edges_total"],
           c["train_gossip_halo_bytes_total"]]
    assert got == jax_faults["counters"].tolist()
    assert got[0] > 0 and got[1] > 0 and got[2] > 0
    ages = port_faults[0]["halo_age"]
    assert [ages["count"], ages["sum"]] == jax_faults["ages"].tolist()
    exists = tfaults.edges_exist(MeshPlan.build(4, 4, grid=(2, 2)))
    assert got[0] == int((jax_faults["drops"] & exists[None]).sum())


def test_nan_at_raises_divergence_at_the_same_unit(jax_faults, port_faults):
    div = port_faults[1]["diverged"]
    assert div is not None and "U" not in port_faults[1]
    assert div["unit"] == int(jax_faults["nan_unit"]) > NAN_AT
    assert div["reason"] == "non-finite cost"
    assert div["message"] == str(jax_faults["nan_message"])


# ---------------------------------------------------------------------- #
# the self-healing fit
# ---------------------------------------------------------------------- #

DIVERGING_A = 2e-3   # the reference's tests: Wave blows up by the 1st eval
STABLE_A = 5e-4


def _dense(seed=0, m=24, n=20, r=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
    mask = (rng.random((m, n)) < 0.6).astype(np.float32)
    return x, mask


def _fit_both(a, tmp_path, **kw):
    x, mask = _dense()
    out = []
    for mod, cfg_cls, prob in (
            (tmc, TConfig, tmc.CompletionProblem.from_dense(
                x, mask, 2, 2, 2, device="cpu")),
            (jmc, JConfig, jmc.CompletionProblem.from_dense(
                x, mask, p=2, q=2, rank=2))):
        ck = mod.Checkpoint(str(tmp_path / mod.__name__))
        tr = mod.Trainer(cfg_cls(m=24, n=20, rank=2, p=2, q=2, a=a),
                         callbacks=[ck])
        out.append(tr.fit(prob, "wave", num_rounds=20, eval_every=5,
                          recovery=(tfaults if mod is tmc else jfaults)
                          .RecoveryPolicy(**kw)))
    return out


def test_self_healing_wave_fit_recovery_log_equals_the_reference(tmp_path):
    tobs.reset()
    jobs.reset()
    got, want = _fit_both(DIVERGING_A, tmp_path, max_restarts=3,
                          backoff=0.25)
    assert np.isfinite(got.final_cost)
    assert len(got.recovery_log) == len(want.recovery_log) == 1
    g, w = got.recovery_log[0], want.recovery_log[0]
    assert g.keys() == w.keys()
    assert {k: g[k] for k in g if k != "cost"} == \
        {k: w[k] for k in w if k != "cost"}
    assert not np.isfinite(g["cost"]) and not np.isfinite(w["cost"])
    assert g["step_a"] == pytest.approx(DIVERGING_A * 0.25)
    assert tobs.snapshot()["counters"]["fit_recoveries_total"] == \
        jobs.snapshot()["counters"]["fit_recoveries_total"] == 1.0


def test_recovery_restores_from_a_checkpoint(tmp_path):
    x, mask = _dense()
    prob = tmc.CompletionProblem.from_dense(x, mask, 2, 2, 2, device="cpu")
    ck = tmc.Checkpoint(str(tmp_path))
    tmc.Trainer(TConfig(m=24, n=20, rank=2, p=2, q=2, a=STABLE_A),
                callbacks=[ck]).fit(prob, "wave", num_rounds=10,
                                    eval_every=5)
    assert ck.manager.latest_step() == 10
    res = tmc.Trainer(TConfig(m=24, n=20, rank=2, p=2, q=2, a=DIVERGING_A),
                      callbacks=[ck]).fit(
        prob, "wave", num_rounds=20, eval_every=5, resume_from=ck,
        recovery=tfaults.RecoveryPolicy(max_restarts=2, backoff=0.25))
    assert np.isfinite(res.final_cost)
    assert res.recovery_log and res.recovery_log[0]["resumed_from"] >= 10


def test_recovery_exhausts_max_restarts_and_raise_mode(tmp_path):
    tobs.reset()
    with pytest.raises(tfaults.DivergenceError):
        _fit_both(DIVERGING_A, tmp_path / "a", max_restarts=2, backoff=1.0)
    assert tobs.snapshot()["counters"]["fit_recoveries_total"] == 2.0
    with pytest.raises(tfaults.DivergenceError):
        _fit_both(DIVERGING_A, tmp_path / "b", on_divergence="raise")


def test_recovery_without_checkpoint_rejected_like_the_reference():
    x, mask = _dense()
    msgs = []
    for mod, cfg_cls, prob, pol in (
            (tmc, TConfig, tmc.CompletionProblem.from_dense(
                x, mask, 2, 2, 2, device="cpu"), tfaults.RecoveryPolicy()),
            (jmc, JConfig, jmc.CompletionProblem.from_dense(
                x, mask, p=2, q=2, rank=2), jfaults.RecoveryPolicy())):
        msgs.append(_message(lambda: mod.Trainer(cfg_cls(
            m=24, n=20, rank=2, p=2, q=2, a=DIVERGING_A)).fit(
            prob, "wave", num_rounds=5, recovery=pol)))
    assert msgs[0] == msgs[1] and "Checkpoint" in msgs[0]


def test_guard_runs_before_checkpoint(tmp_path):
    """A diverged state is never persisted: the guard fires at the
    boundary the Checkpoint would have saved, first — even when the
    callbacks list the Checkpoint before the guard."""

    x, mask = _dense()
    prob = tmc.CompletionProblem.from_dense(x, mask, 2, 2, 2, device="cpu")
    ck = tmc.Checkpoint(str(tmp_path))
    with pytest.raises(tfaults.DivergenceError):
        tmc.Trainer(TConfig(m=24, n=20, rank=2, p=2, q=2, a=DIVERGING_A),
                    callbacks=[ck, tfaults.DivergenceGuard()]).fit(
            prob, "wave", num_rounds=20, eval_every=5,
            recovery=tfaults.RecoveryPolicy(on_divergence="raise"))
    assert ck.manager.latest_step() is None   # nothing poisoned on disk


def test_gossip_faults_bench_twin_runs_on_a_cpu_grid(tmp_path):
    """``python -m repro_torch.launch.gossip_faults`` (the twin of
    ``benchmarks/gossip_faults.py``) on a 2×2 CPU grid: injected ==
    observed drops (it raises otherwise), p = 0 bit-identical."""

    import json

    from repro_torch.launch import gossip_faults

    path = tmp_path / "faults.json"
    gossip_faults.main(["--device", "cpu", "--rounds", "20", "--drops",
                        "0,0.2", "--staleness-bounds", "1,3", "--json",
                        str(path)])
    out = json.loads(path.read_text())
    assert out["bench"] == "gossip_faults" and out["grid"] == "2x2"
    assert out["p0_bit_identical"] is True
    assert [(r["p_drop"], r["max_staleness"]) for r in out["rows"]] == \
        [(0.0, 1), (0.0, 3), (0.2, 1), (0.2, 3)]
    assert set(out["rows"][0]) >= {
        "rmse", "final_cost", "rmse_vs_clean", "counters", "expected_drops",
        "sim_round_slowdown"}
    assert out["rows"][2]["counters"]["gossip_edges_dropped_total"] == \
        out["rows"][2]["expected_drops"] > 0
