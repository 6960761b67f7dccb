"""The port's fit end to end against the JAX package's, on the CPU.

Random streams cannot be shared (threefry vs torch), so the reference's
initial ``State`` is injected on both sides through ``repro_torch.convert``;
the wave order and the sequential structure picks are given to both sides.

Tolerances: FullGD over 20 rounds is held to rtol=1e-4, atol=1e-5·max|ref|
— the float32 rounding differences of each step feed the next, so the
error grows over the rounds; one Wave round and ten Sequential steps to
rtol=1e-5, atol=1e-5·max|ref|.  Top-k items must be equal wherever the
scores have no ties."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import mc as jmc  # noqa: E402
from repro.config import GossipMCConfig as JConfig  # noqa: E402
from repro.core import assemble as jasm  # noqa: E402
from repro.core import grid as jgrid  # noqa: E402
from repro.core import sequential as jseq  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.core import waves as jwaves  # noqa: E402
from repro.data import lowrank_problem as j_lowrank  # noqa: E402
from repro.serve import recommend as jrec  # noqa: E402
from repro_torch import mc as tmc  # noqa: E402
from repro_torch.config import GossipMCConfig as TConfig  # noqa: E402
from repro_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.core import assemble as tasm  # noqa: E402
from repro_torch.core import sequential as tseq  # noqa: E402
from repro_torch.core import state as tstate  # noqa: E402
from repro_torch.core import waves as twaves  # noqa: E402
from repro_torch.data import lowrank_problem as t_lowrank  # noqa: E402
from repro_torch.serve import recommend as trec  # noqa: E402

torch.set_num_threads(2)

M, N, P, Q, R = 60, 48, 3, 2, 3
HP = dict(rho=1e3, lam=1e-6, a=5e-4, b=5e-7)


def _problems(layout, method="segment"):
    kw = dict(density=0.3, seed=0)
    jp = jmc.CompletionProblem.from_dataset(
        j_lowrank(M, N, R, **kw), P, Q, R, layout=layout,
        engine=jmc.EngineOptions(method=method))
    tp = tmc.CompletionProblem.from_dataset(
        t_lowrank(M, N, R, **kw), P, Q, R, layout=layout,
        engine=tmc.EngineOptions(method=method), device="cpu")
    return jp, tp


def _state0():
    st = jstate.init_state(jax.random.PRNGKey(0), jgrid.GridSpec(M, N, P, Q, R))
    return st, state_from_numpy(st.U, st.W, st.t, "cpu")


def _close_state(tst, jst, rtol):
    U, W, t = state_to_numpy(tst)
    assert t == int(jst.t)
    for a, b in ((U, jst.U), (W, jst.W)):
        b = np.asarray(b, np.float64)
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=1e-5 * float(np.abs(b).max()))


@pytest.mark.parametrize("layout,method", [("dense", "segment"),
                                           ("sparse", "segment"),
                                           ("sparse", "scatter")])
def test_fullgd_20_rounds_matches_jax_trainer(layout, method):
    jp, tp = _problems(layout, method)
    js0, ts0 = _state0()
    jres = jmc.Trainer(JConfig(m=M, n=N, p=P, q=Q, rank=R, **HP)).fit(
        jp, jmc.FullGD(num_rounds=20, eval_every=5), state=js0)
    tres = tmc.Trainer(TConfig(m=M, n=N, p=P, q=Q, rank=R, **HP)).fit(
        tp, tmc.FullGD(num_rounds=20, eval_every=5), state=ts0)
    assert [t for t, _ in tres.history] == [t for t, _ in jres.history]
    np.testing.assert_allclose([c for _, c in tres.history],
                               [c for _, c in jres.history], rtol=1e-4)
    assert tres.t == jres.t == 20 * 2 * (P - 1) * (Q - 1)
    _close_state(tres.state, jres.state, rtol=1e-4)
    assert tres.rmse() == pytest.approx(jres.rmse(), rel=1e-4)
    assert tres.history[-1][1] < tres.history[0][1]


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_full_gd_rounds_matches_jax(layout):
    jp, tp = _problems(layout)
    js, ts = _state0()
    js = jwaves.full_gd_rounds(jp.data, js, rounds=3, **HP)
    ts = twaves.full_gd_rounds(tp.data, ts, rounds=3, **HP)
    _close_state(ts, js, rtol=1e-5)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_wave_round_matches_jax(layout):
    jp, tp = _problems(layout)
    js, ts = _state0()
    jt = jwaves.wave_tables(P, Q)
    tt = twaves.wave_tables(P, Q, "cpu")
    order = np.random.default_rng(0).permutation(len(jt))
    for w in order:
        js = jwaves.wave_step(jp.data, js, jt[w], **HP)
        ts = twaves.wave_step(tp.data, ts, tt[w], **HP)
    _close_state(ts, js, rtol=1e-5)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_sequential_steps_match_jax(layout):
    jp, tp = _problems(layout)
    js, ts = _state0()
    structs = jgrid.enumerate_structures(P, Q)
    jt = jstate.build_tables(P, Q, structs)
    tt = tstate.build_tables(P, Q, structs, "cpu")
    for key in jax.random.split(jax.random.PRNGKey(1), 10):
        # the index the reference draws inside its step, given to the port
        s = int(jax.random.randint(key, (), 0, len(structs)))
        js = jseq.sgd_structure_step(jp.data, js, jt, key, **HP)
        ts = tseq.sgd_structure_step(tp.data, ts, tt, s, **HP)
    _close_state(ts, js, rtol=1e-5)


def test_sequential_and_wave_fits_run():
    _, tp = _problems("sparse")
    cfg = TConfig(m=M, n=N, p=P, q=Q, rank=R, **HP)
    cb = tmc.EvalRMSE()
    res = tmc.Trainer(cfg, callbacks=[cb]).fit(
        tp, tmc.Sequential(num_iters=60, eval_every=20), seed=3)
    assert res.t == 60 and len(res.history) == 3 and len(cb.history) == 3
    assert np.isfinite([c for _, c in res.history]).all()
    res = tmc.Trainer(cfg).fit(tp, "wave", num_rounds=2, seed=3)
    assert res.t == 2 * len(jgrid.enumerate_structures(P, Q))


def test_assemble_rmse_and_topk_match_jax():
    rng = np.random.default_rng(7)
    spec_j = jgrid.GridSpec(M, N, P, Q, R)
    U = rng.normal(size=(P, Q, M // P, R)).astype(np.float32)
    W = rng.normal(size=(P, Q, N // Q, R)).astype(np.float32)
    ju, jw = jasm.assemble(U, W, spec_j)
    tu, tw = tasm.assemble(torch.from_numpy(U), torch.from_numpy(W),
                           spec_j)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6)
    np.testing.assert_allclose(tasm.consensus_error(torch.from_numpy(U),
                                                    torch.from_numpy(W)),
                               jasm.consensus_error(U, W), rtol=1e-6)
    rows, cols = rng.integers(0, M, 200), rng.integers(0, N, 200)
    vals = rng.normal(size=200).astype(np.float32)
    assert tasm.rmse(tu, tw, rows, cols, vals, batch=64) == pytest.approx(
        jasm.rmse(ju, jw, rows, cols, vals, batch=64), rel=1e-5)

    mask = (rng.random((M - 3, N - 5)) < 0.3).astype(np.float32)
    srows, scols = np.nonzero(mask)
    jidx = jrec.build_index(U, W, spec_j, num_users=M - 3, num_items=N - 5,
                            seen_coo=(srows, scols))
    tidx = trec.build_index(torch.from_numpy(U), torch.from_numpy(W), spec_j,
                            num_users=M - 3, num_items=N - 5,
                            seen_coo=(srows, scols))
    np.testing.assert_array_equal(tidx.seen.numpy(), np.asarray(jidx.seen))
    np.testing.assert_array_equal(
        trec.build_seen_table(mask, N - 5), jrec.build_seen_table(mask, N - 5))
    users = np.arange(0, M - 3, 3)
    for exclude in (True, False):
        ji, js = jrec.recommend_topk(jidx, users, k=7, exclude_seen=exclude)
        ti, ts = trec.recommend_topk(tidx, users, k=7, exclude_seen=exclude)
        ji, js = np.asarray(ji), np.asarray(js)
        np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-5)
        gaps = np.abs(np.diff(np.sort(tidx.u[users].numpy() @ tidx.w.numpy().T,
                                      axis=1), axis=1))
        tie_free = (gaps > 1e-4).all(axis=1)
        assert tie_free.sum() > len(users) // 2
        np.testing.assert_array_equal(ti.numpy()[tie_free], ji[tie_free])
        if exclude:
            seen = set(zip(srows.tolist(), scols.tolist()))
            assert not any((int(u), int(i)) in seen
                           for u, row in zip(users, ti.numpy()) for i in row)
