"""The port's Table 1 presets and Table 2 loop against the JAX package's.

Presets: every field of every preset equal.  Table 2: exp1 and exp2 at a
reduced horizon (three checkpoints, 100 FullGD rounds apart), the JAX
side run as ``benchmarks/table2_synthetic.py::run_experiment`` runs it,
the port through ``repro_torch.launch.paper_tables.run_experiment`` on the
CPU, both from the JAX package's initial ``State`` (threefry cannot be
reproduced in torch).  Tolerance: the cost at each checkpoint to rel 1e-5;
the step counts equal.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import gossip_mc as jpresets  # noqa: E402
from repro.core.state import init_state as j_init_state  # noqa: E402
from repro.data import lowrank_problem as j_lowrank  # noqa: E402
from repro.mc import CompletionProblem as JProblem  # noqa: E402
from repro.mc import FullGD as JFullGD  # noqa: E402
from repro.mc import Trainer as JTrainer  # noqa: E402
from repro_torch.configs import gossip_mc as tpresets  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.launch import paper_tables  # noqa: E402

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
COST_RTOL = 1e-5
N_CHECKPOINTS = 3
ROUNDS_APART = 100


def _bench():
    spec = importlib.util.spec_from_file_location(
        "table2_synthetic", ROOT / "benchmarks" / "table2_synthetic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(jpresets.EXPERIMENTS))
def test_experiment_presets_equal(name):
    assert dataclasses.asdict(tpresets.EXPERIMENTS[name]) == \
        dataclasses.asdict(jpresets.EXPERIMENTS[name])


def test_config_production_and_smoke_presets_equal():
    assert sorted(tpresets.EXPERIMENTS) == sorted(jpresets.EXPERIMENTS)
    for got, want in ((tpresets.CONFIG, jpresets.CONFIG),
                      (tpresets.PRODUCTION, jpresets.PRODUCTION),
                      (tpresets.smoke_config(), jpresets.smoke_config())):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_checkpoints_follow_the_benchmark():
    bench = _bench()
    assert paper_tables.CHECKPOINTS == bench.CHECKPOINTS
    for name, cfg in jpresets.EXPERIMENTS.items():
        want = (10_000, 20_000) if cfg.m >= 5000 else bench.CHECKPOINTS
        assert paper_tables.checkpoints_for(name) == want
        assert paper_tables.checkpoints_for(name, full=True) == \
            bench.CHECKPOINTS


def _jax_rows(name, checkpoints):
    """``table2_synthetic.run_experiment``'s loop at the given
    checkpoints; returns its rows and the initial state as numpy."""

    cfg = jpresets.EXPERIMENTS[name]
    ds = j_lowrank(cfg.m, cfg.n, cfg.rank, density=cfg.density, seed=1)
    problem = JProblem.from_dataset(ds, cfg.p, cfg.q, cfg.rank)
    n_struct = problem.spec.num_structures
    trainer = JTrainer(cfg)
    state = j_init_state(jax.random.PRNGKey(cfg.seed), problem.spec)
    st0 = tuple(np.asarray(x) for x in state)
    rows = [(0, problem.total_cost(state, cfg.lam))]
    for target_t in checkpoints:
        rounds = max(1, (target_t - int(state.t)) // n_struct)
        res = trainer.fit(problem, JFullGD(num_rounds=rounds,
                                           eval_every=rounds), state=state)
        state = res.state
        rows.append((res.t, res.final_cost))
    return rows, st0


@pytest.mark.parametrize("name", ["exp1", "exp2"])
def test_table2_reduced_horizon_matches_jax_fullgd(name):
    cfg = jpresets.EXPERIMENTS[name]
    n_struct = 2 * (cfg.p - 1) * (cfg.q - 1)
    checkpoints = tuple(n_struct * ROUNDS_APART * (k + 1)
                        for k in range(N_CHECKPOINTS))
    want, st0 = _jax_rows(name, checkpoints)
    got, wall, _ = paper_tables.run_experiment(
        name, device="cpu", state=state_from_numpy(*st0, "cpu"),
        checkpoints=checkpoints)
    assert wall > 0
    assert [t for t, _ in got] == [t for t, _ in want] == \
        [0, *checkpoints]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want],
                               rtol=COST_RTOL)
    # the cost falls between checkpoints, as in the paper's table
    assert all(b < a for (_, a), (_, b) in zip(got, got[1:]))
    line = paper_tables.row(name, got, wall)
    assert line.startswith(f"table2_{name},") and f"t{checkpoints[-1]}=" \
        in line
