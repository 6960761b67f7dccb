"""The port's minibatch sampling and minibatch gossip against the JAX
package's, on the CPU.

Threefry cannot be reproduced in torch, so the parity tests draw the
positions with ``jax.random.randint`` on the keys ``_sample_block`` uses
and feed them to the port's assembly; the port's own draw is held to its
contracts (restart-exact, grid-invariant, the sorted layout).

* ``assemble_minibatch`` from JAX's positions against JAX
  ``sample_minibatch``: every field exactly, empty blocks included;
  ``minibatch_grad_scale`` exactly.
* ``MinibatchStream``: ``batch_at(t)`` repeats across instances and moves
  with the step and the seed; a rank's tile of the draw equals the same
  blocks of the 1×1 draw; the sorted-batch invariants of
  ``tests/test_sparse.py``.
* One ``Gossip`` minibatch step fed JAX's minibatch and scale against JAX's
  step on 1×1 (JAX in a subprocess), rel 1e-5; a 2×2 ``gloo`` grid with
  ``batch=`` against 1×1 from one state and seed, max |ΔU| < 1e-5; the
  option errors.

Every subprocess and every rank grid has a timeout of its own.
"""

import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import sparse as jsparse  # noqa: E402
from repro.config import GossipMCConfig as JConfig  # noqa: E402
from repro.core import gossip as jgossip  # noqa: E402
from repro_torch import mc as tmc  # noqa: E402
from repro_torch import sparse as tsparse  # noqa: E402
from repro_torch.config import GossipMCConfig as TConfig  # noqa: E402
from repro_torch.convert import (sparse_problem_from_numpy,  # noqa: E402
                                 state_from_numpy)
from repro_torch.core import gossip as tgossip  # noqa: E402
from repro_torch.core.state import init_state  # noqa: E402
from repro_torch.launch import gossip as tlaunch  # noqa: E402
from repro_torch.mesh import MeshPlan  # noqa: E402
from repro_torch.mesh import plan as tplan  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("rows", "cols", "vals", "valid", "col_perm", "row_ptr", "col_ptr")
RTOL = 1e-5          # float paths: torch and XLA round differently
U_ATOL = 1e-5        # tests/test_distributed.py: max |ΔU| after the rounds
COST_RTOL = 1e-4
SUBPROCESS_TIMEOUT = 300
GRID_TIMEOUT = 180
M, N, R = 48, 40, 3
HP = dict(rho=1e3, lam=1e-6, a=5e-4, b=5e-7)


def _blocks(p=2, q=2, mb=12, nb=10, density=0.3, seed=0, empty=(0, 1)):
    rng = np.random.default_rng(seed)
    mask = (rng.random((p, q, mb, nb)) < density).astype(np.float32)
    if empty is not None:
        mask[empty] = 0.0
    x = rng.normal(size=mask.shape).astype(np.float32) * mask
    return (jsparse.from_blocks(x, mask, bucket=32),
            tsparse.from_blocks(x, mask, bucket=32, device="cpu"))


def _jax_positions(key, sp, batch):
    """The positions ``_sample_block`` draws for each block, in the
    reference's key order."""

    p, q = sp.nnz.shape
    keys = jax.random.split(key, p * q)
    nnz = np.asarray(sp.nnz).reshape(-1)
    return np.stack([
        np.asarray(jax.random.randint(k, (batch,), 0, max(int(c), 1)))
        for k, c in zip(keys, nnz)]).reshape(p, q, batch)


@pytest.mark.parametrize("seed,batch,empty", [(0, 16, (0, 1)), (1, 40, None),
                                              (2, 7, (1, 0))])
def test_assembly_from_jax_positions_equals_jax_sample(seed, batch, empty):
    jsp, tsp = _blocks(seed=seed, empty=empty)
    key = jax.random.PRNGKey(seed + 9)
    want = jsparse.sample_minibatch(key, jsp, batch)
    pos = torch.from_numpy(_jax_positions(key, jsp, batch))
    got = tsparse.assemble_minibatch(tsp, pos)
    for f in FIELDS:
        a, b = getattr(got.entries, f), np.asarray(getattr(want.entries, f))
        assert a.dtype == (torch.float32 if b.dtype == np.float32
                           else torch.int32), f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    np.testing.assert_array_equal(got.nnz.numpy(), np.asarray(want.nnz))
    if empty is not None:
        assert int(got.nnz[empty]) == 0
        assert float(got.entries.valid[empty].sum()) == 0.0
    np.testing.assert_array_equal(
        tsparse.minibatch_grad_scale(tsp, batch).numpy(),
        np.asarray(jsparse.minibatch_grad_scale(jsp, batch)))


def test_stream_is_restart_exact():
    _, tsp = _blocks(seed=5)
    s1 = tsparse.MinibatchStream(tsp, batch=24, seed=11)
    s2 = tsparse.MinibatchStream(tsp, batch=24, seed=11)
    for step in (0, 3, 1000):
        a, b = s1.batch_at(step), s2.batch_at(step)
        for fa, fb in zip((*a.entries, a.nnz), (*b.entries, b.nnz)):
            assert torch.equal(fa, fb)
    assert not torch.equal(s1.batch_at(3).entries.rows,
                           s1.batch_at(4).entries.rows)
    other = tsparse.MinibatchStream(tsp, batch=24, seed=12).batch_at(3)
    assert not torch.equal(other.entries.rows, s1.batch_at(3).entries.rows)
    # positions sit inside each block's entries; an empty block draws 0
    pos = s1.positions_at(7)
    nnz = tsp.nnz.long().unsqueeze(-1)
    assert bool((pos >= 0).all()) and bool((pos < nnz.clamp(min=1)).all())
    assert bool((pos[0, 1] == 0).all())
    with pytest.raises(ValueError, match="batch must be positive"):
        tsparse.MinibatchStream(tsp, batch=0)


@pytest.mark.parametrize("rank", range(4))
def test_stream_is_grid_invariant(monkeypatch, rank):
    """A rank's stream over its tile draws the 1×1 stream's entries for
    its blocks, at every step."""

    _, tsp = _blocks(p=4, q=4, mb=9, nb=8, seed=3, empty=(2, 3))
    plan = MeshPlan.build(4, 4, grid=(2, 2))
    one = tsparse.MinibatchStream(tsp, batch=20, seed=7)
    monkeypatch.setattr(tplan, "current_rank", lambda: rank)
    tile = plan.local_slice(tsp, rank)
    mine = tsparse.MinibatchStream(tile, batch=20, seed=7, plan=plan)
    for step in (0, 5, 77):
        want = plan.local_slice(one.batch_at(step), rank)
        got = mine.batch_at(step)
        for fa, fb in zip((*got.entries, got.nnz), (*want.entries, want.nnz)):
            assert torch.equal(fa, fb)


def test_sample_minibatch_sorted_batch_invariants():
    """As tests/test_sparse.py pins for the reference: rows non-decreasing,
    the CSR/CSC offsets consistent with the sampled entries, col_perm a
    permutation to column order, nnz == batch in non-empty blocks, and a
    repeated position kept as a repeated entry."""

    _, tsp = _blocks(p=3, q=2, mb=15, nb=11, density=0.15, seed=6,
                     empty=None)
    batch = 40
    g = torch.Generator().manual_seed(9)
    mbat = tsparse.sample_minibatch(g, tsp, batch)
    e = mbat.entries
    assert e.row_ptr.shape == (3, 2, 16) and e.col_ptr.shape == (3, 2, 12)
    repeats = 0
    for i in range(3):
        for j in range(2):
            r_, c_ = e.rows[i, j].numpy(), e.cols[i, j].numpy()
            assert int(mbat.nnz[i, j]) == batch
            assert np.all(np.diff(r_) >= 0)
            np.testing.assert_array_equal(np.diff(e.row_ptr[i, j].numpy()),
                                          np.bincount(r_, minlength=15))
            assert int(e.row_ptr[i, j, -1]) == batch
            pm = e.col_perm[i, j].numpy()
            assert sorted(pm) == list(range(batch))
            assert np.all(np.diff(c_[pm]) >= 0)
            np.testing.assert_array_equal(np.diff(e.col_ptr[i, j].numpy()),
                                          np.bincount(c_, minlength=11))
            keys = r_ * 11 + c_
            repeats += len(keys) - len(np.unique(keys))
    assert repeats > 0        # with replacement: duplicates are kept


# ---------------------------------------------------------------------- #
# minibatch gossip
# ---------------------------------------------------------------------- #


def run_jax(prog: str, devices: int = 1) -> str:
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(prog)],
                         capture_output=True, text=True, env=env,
                         timeout=SUBPROCESS_TIMEOUT)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    return out.stdout


def test_minibatch_step_equals_jax_step(tmp_path):
    """Three rounds, each fed the same JAX-sampled minibatch and the same
    full-store scale, on the 1×1 plan."""

    out = tmp_path / "jax.npz"
    prog = f"""
    import jax, numpy as np
    from repro import mc, sparse
    from repro.config import GossipMCConfig
    from repro.core import gossip, grid as G, state as S
    from repro.data import lowrank_problem
    cfg = GossipMCConfig(m={M}, n={N}, p=4, q=4, rank={R}, **{HP!r})
    prob = mc.CompletionProblem.from_dataset(
        lowrank_problem({M}, {N}, {R}, density=0.3, seed=0), 4, 4, {R},
        layout="sparse")
    st0 = S.init_state(jax.random.PRNGKey(0), G.GridSpec({M}, {N}, 4, 4,
                                                         {R}))
    step, _ = gossip.make_gossip_step(None, (4, 4), cfg, layout="sparse",
                                      batch=16)
    scale = sparse.minibatch_grad_scale(prob.data, 16)
    stream = sparse.MinibatchStream(prob.data, 16, seed=3)
    carry = gossip.init_carry(st0)
    save = dict(U_init=np.asarray(st0.U), W_init=np.asarray(st0.W),
                scale=np.asarray(scale))
    for t in range(3):
        mbat = stream.batch_at(t)
        for f in ("rows", "cols", "vals", "valid", "col_perm", "row_ptr",
                  "col_ptr"):
            save[f"{{f}}{{t}}"] = np.asarray(getattr(mbat.entries, f))
        save[f"nnz{{t}}"] = np.asarray(mbat.nnz)
        carry = step(mbat, scale, carry)
        save[f"U{{t}}"] = np.asarray(carry.state.U)
        save[f"W{{t}}"] = np.asarray(carry.state.W)
        save[f"t{{t}}"] = int(carry.state.t)
    np.savez({str(out)!r}, **save)
    """
    run_jax(prog)
    want = np.load(out)
    cfg = TConfig(m=M, n=N, p=4, q=4, rank=R, **HP)
    step = tgossip.make_gossip_step((4, 4), cfg, layout="sparse", batch=16)
    scale = torch.from_numpy(want["scale"])
    carry = tgossip.init_carry(state_from_numpy(want["U_init"],
                                                want["W_init"], 0, "cpu"))
    for t in range(3):
        mbat = sparse_problem_from_numpy(
            *(want[f"{f}{t}"] for f in FIELDS), want[f"nnz{t}"], "cpu")
        carry = step(mbat, scale, carry)
        assert int(carry.state.t) == int(want[f"t{t}"])
        assert carry.rnd == t + 1
        for a, b in ((carry.state.U, want[f"U{t}"]),
                     (carry.state.W, want[f"W{t}"])):
            np.testing.assert_allclose(a.numpy(), b, rtol=RTOL,
                                       atol=RTOL * float(np.abs(b).max()))


def test_minibatch_gossip_2x2_grid_equals_1x1():
    recipe = tlaunch.ProblemRecipe(
        "lowrank_problem", dict(m=M, n=N, r=R, density=0.3, seed=0),
        p=4, q=4, rank=R, layout="sparse")
    cfg = TConfig(m=M, n=N, p=4, q=4, rank=R, **HP)
    sched = tmc.Gossip(num_rounds=30, eval_every=10, batch=16)
    problem = recipe.build(device="cpu")
    st0 = init_state(torch.Generator().manual_seed(0), problem.spec)
    np0 = (st0.U.numpy(), st0.W.numpy(), 0)
    one = tmc.Trainer(cfg).fit(problem, sched, state=st0)
    costs = [c for _, c in one.history]
    assert costs[-1] < problem.total_cost(st0, cfg.lam)
    t0 = time.monotonic()
    got, = tlaunch.fit_on_grid([tlaunch.FitJob(recipe, cfg, sched, np0)],
                               grid=(2, 2), device="cpu",
                               timeout=GRID_TIMEOUT)
    assert time.monotonic() - t0 < GRID_TIMEOUT
    assert got["counters"]["train_gossip_rounds_total"] == 30
    for a, b in ((got["U"], one.state.U), (got["W"], one.state.W)):
        assert float(np.abs(a - b.numpy()).max()) < U_ATOL
    assert [t for t, _ in got["history"]] == [t for t, _ in one.history]
    np.testing.assert_allclose([c for _, c in got["history"]], costs,
                               rtol=COST_RTOL)


def test_minibatch_gossip_stream_follows_the_fit_seed_or_batch_seed():
    """From one injected state: the same fit seed replays the run, another
    seed draws another stream, and ``batch_seed`` fixes the stream
    whatever the fit's seed."""

    recipe = tlaunch.ProblemRecipe(
        "lowrank_problem", dict(m=M, n=N, r=R, density=0.3, seed=0),
        p=4, q=4, rank=R, layout="sparse")
    problem = recipe.build(device="cpu")
    st0 = init_state(torch.Generator().manual_seed(0), problem.spec)
    trainer = tmc.Trainer(TConfig(m=M, n=N, p=4, q=4, rank=R, **HP))

    def run(seed, **kw):
        return trainer.fit(problem, tmc.Gossip(num_rounds=6, batch=8, **kw),
                           seed=seed, state=st0).state.U

    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))
    assert torch.equal(run(1, batch_seed=5), run(2, batch_seed=5))
    assert not torch.equal(run(1, batch_seed=5), run(1, batch_seed=6))


@pytest.mark.parametrize("kw", [dict(batch=32),
                                dict(batch=32, layout="sparse",
                                     steps_per_call=4)])
def test_minibatch_step_option_errors_equal_jax(kw):
    with pytest.raises(ValueError) as got:
        tgossip.make_gossip_step((2, 2), TConfig(m=M, n=N, p=2, q=2,
                                                 rank=R), **kw)
    with pytest.raises(ValueError) as want:
        jgossip.make_gossip_step(None, (2, 2), JConfig(m=M, n=N, p=2, q=2,
                                                       rank=R), **kw)
    assert str(got.value) == str(want.value)


def test_gossip_batch_on_the_dense_layout_raises_like_the_reference():
    from repro import mc as jmc
    from repro.data import lowrank_problem as j_lowrank
    from repro_torch.data import lowrank_problem as t_lowrank

    jp = jmc.CompletionProblem.from_dataset(
        j_lowrank(M, N, R, density=0.3, seed=0), 4, 4, R)
    tp = tmc.CompletionProblem.from_dataset(
        t_lowrank(M, N, R, density=0.3, seed=0), 4, 4, R, device="cpu")
    with pytest.raises(ValueError) as got:
        tmc.Trainer(TConfig(m=M, n=N, p=4, q=4, rank=R)).fit(
            tp, tmc.Gossip(num_rounds=1, batch=8))
    with pytest.raises(ValueError) as want:
        jmc.Trainer(JConfig(m=M, n=N, p=4, q=4, rank=R)).fit(
            jp, jmc.Gossip(num_rounds=1, batch=8))
    assert str(got.value) == str(want.value)
