"""The port's streaming loop against the JAX package's, on the CPU.

* ``sparse.append_entries``: the same base stores (``tests/test_streaming.py``
  ``_coo_problem``) and the same appends through both packages give every
  integer field and ``vals`` exactly equal; the appended store equals a
  fresh ingest of the union at the same capacity, field for field; edits,
  within-batch duplicates, the overflow message, input validation; the base
  store is untouched.
* Gradients on an appended store against JAX, both layouts: rel 1e-5.
* ``CompletionProblem.append`` against JAX on both layouts (μ-centring,
  ``seen_coo``, validation), and a rank's tile under a 2×2 plan.
* ``Trainer.refit`` against JAX ``refit`` from the same injected state,
  the ``"full"`` refit and the default ``Incremental`` one (40 Wave rounds,
  JAX's wave orders injected into the port's draws): ``t`` carried over,
  states to rel 1e-5; ``reset_clock``; the spec check; ``Incremental`` as
  the default.
* ``RefreshPolicy`` and ``ServingEngine.note_append`` on a CPU engine
  (every engine in a ``with`` block, every ``future.result`` with a
  timeout), and ``launch/streaming.py`` at a tiny size.
"""

import contextlib
import io

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import mc as jmc  # noqa: E402
from repro import sparse as jsparse  # noqa: E402
from repro.config import GossipMCConfig as JConfig  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.core import waves as jwaves  # noqa: E402
from repro.data import lowrank_problem as j_lowrank  # noqa: E402
from repro.serving import RefreshPolicy as JPolicy  # noqa: E402
from repro_torch import mc as tmc  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import sparse as tsparse  # noqa: E402
from repro_torch.config import GossipMCConfig as TConfig  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.core import waves as twaves  # noqa: E402
from repro_torch.launch import streaming as tstreaming  # noqa: E402
from repro_torch.mesh import MeshPlan  # noqa: E402
from repro_torch.serve.recommend import recommend_topk  # noqa: E402
from repro_torch.serving import RefreshPolicy, ServingEngine  # noqa: E402

torch.set_num_threads(2)

FIELDS = ("rows", "cols", "vals", "valid", "col_perm", "row_ptr", "col_ptr")
RTOL = 1e-5          # float paths: torch and XLA round differently
TIMEOUT = 60


def _coo(m=60, n=48, density=0.2, seed=0, base_frac=0.7):
    """A COO ratings log split into (base, streamed remainder), as
    tests/test_streaming.py::_coo_problem makes it."""

    rng = np.random.default_rng(seed)
    mask = rng.random((m, n)) < density
    rr, cc = np.nonzero(mask)
    vv = rng.normal(size=len(rr)).astype(np.float32)
    perm = rng.permutation(len(rr))
    cut = int(base_frac * len(rr))
    return (rr, cc, vv), (perm[:cut], perm[cut:])


def _stores(coo, idx, m=60, n=48, p=3, q=2, bucket=32, headroom=96):
    rr, cc, vv = coo
    jsp, _ = jsparse.from_entries(rr[idx], cc[idx], vv[idx], m, n, p, q,
                                  bucket=bucket, headroom=headroom)
    tsp, _ = tsparse.from_entries(rr[idx], cc[idx], vv[idx], m, n, p, q,
                                  bucket=bucket, headroom=headroom,
                                  device="cpu")
    return jsp, tsp


def _host(sp):
    return {f: getattr(sp.entries, f).clone() for f in FIELDS} | {
        "nnz": sp.nnz.clone()}


def _assert_store_equals_jax(tsp, jsp):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tsp.entries, f).numpy(),
                                      np.asarray(getattr(jsp.entries, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tsp.nnz.numpy(), np.asarray(jsp.nnz))


def _assert_unchanged(tsp, before):
    for f in FIELDS:
        assert torch.equal(getattr(tsp.entries, f), before[f]), f
    assert torch.equal(tsp.nnz, before["nnz"])


# ---------------------------------------------------------------------- #
# append_entries
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("seed,base_frac", [(0, 0.7), (1, 0.5), (2, 0.95)])
def test_append_equals_jax_and_a_fresh_ingest(seed, base_frac):
    coo, (base, stream) = _coo(seed=seed, base_frac=base_frac)
    rr, cc, vv = coo
    jsp, tsp = _stores(coo, base)
    _assert_store_equals_jax(tsp, jsp)
    before = _host(tsp)
    got = tsparse.append_entries(tsp, rr[stream], cc[stream], vv[stream])
    want = jsparse.append_entries(jsp, rr[stream], cc[stream], vv[stream])
    _assert_store_equals_jax(got, want)
    _assert_unchanged(tsp, before)
    assert got.capacity == tsp.capacity
    # a fresh ingest of the union at the same capacity: every field equal
    E = got.capacity
    union = np.concatenate([base, stream])
    fresh, _ = tsparse.from_entries(
        rr[union], cc[union], vv[union], 60, 48, 3, 2, bucket=32,
        headroom=E - int(got.nnz.max()), device="cpu")
    assert fresh.capacity == E
    for f in FIELDS:
        assert torch.equal(getattr(fresh.entries, f),
                           getattr(got.entries, f)), f
    assert torch.equal(fresh.nnz, got.nnz)
    assert torch.equal(got.free_slots, E - got.nnz)


def test_append_empty_returns_the_store():
    coo, (base, _) = _coo()
    _, tsp = _stores(coo, base)
    assert tsparse.append_entries(tsp, [], [], []) is tsp


def test_append_edits_and_batch_duplicates_equal_jax():
    coo, (base, stream) = _coo()
    rr, cc, vv = coo
    jsp, tsp = _stores(coo, base)
    before = _host(tsp)
    # two edits of a stored pair (the last wins), a new pair given twice,
    # and a run of new entries
    r0, c0 = int(rr[base[0]]), int(cc[base[0]])
    r1, c1 = int(rr[stream[0]]), int(cc[stream[0]])
    rows = np.concatenate([[r0, r1, r0, r1], rr[stream[1:20]]])
    cols = np.concatenate([[c0, c1, c0, c1], cc[stream[1:20]]])
    vals = np.concatenate([[5.0, 6.0, 9.0, 7.0], vv[stream[1:20]]]).astype(
        np.float32)
    got = tsparse.append_entries(tsp, rows, cols, vals)
    want = jsparse.append_entries(jsp, rows, cols, vals)
    _assert_store_equals_jax(got, want)
    _assert_unchanged(tsp, before)
    assert int(got.nnz.sum()) == int(tsp.nnz.sum()) + 20
    xb, _ = tsparse.to_dense(got)
    mb, nb = got.mb, got.nb
    assert xb[r0 // mb, c0 // nb, r0 % mb, c0 % nb] == 9.0
    assert xb[r1 // mb, c1 // nb, r1 % mb, c1 % nb] == 7.0


def test_append_overflow_message_equals_jax():
    coo, (base, _) = _coo()
    rr, cc, _ = coo
    jsp, tsp = _stores(coo, base, headroom=0)
    free = int(tsp.free_slots[0, 0])
    assert free == int(np.asarray(jsp.free_slots)[0, 0])
    mb, nb = tsp.mb, tsp.nb
    have = {(int(r), int(c)) for r, c in zip(rr[base], cc[base])}
    newr, newc = zip(*[(r, c) for r in range(mb) for c in range(nb)
                       if (r, c) not in have][: free + 5])
    args = (np.array(newr), np.array(newc), np.ones(len(newr), np.float32))
    before = _host(tsp)
    with pytest.raises(ValueError) as got:
        tsparse.append_entries(tsp, *args)
    with pytest.raises(ValueError) as want:
        jsparse.append_entries(jsp, *args)
    assert str(got.value) == str(want.value)
    assert "headroom" in str(got.value)
    _assert_unchanged(tsp, before)


@pytest.mark.parametrize("args", [
    ([1, 2], [1], [1.0]),
    ([10_000], [0], [1.0]),
    ([0], [-1], [1.0]),
    (np.zeros((2, 2)), np.zeros((2, 2)), np.zeros((2, 2))),
])
def test_append_validation_equals_jax(args):
    coo, (base, _) = _coo()
    jsp, tsp = _stores(coo, base)
    with pytest.raises(ValueError) as got:
        tsparse.append_entries(tsp, *args)
    with pytest.raises(ValueError) as want:
        jsparse.append_entries(jsp, *args)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------- #
# CompletionProblem.append and gradients on the grown problem
# ---------------------------------------------------------------------- #

M, N, P, Q, R = 96, 80, 3, 2, 4


def _split(density=0.25, frac=0.8):
    ds = j_lowrank(M, N, R, density=density, seed=0)
    rr, cc = np.nonzero(ds.train_mask)
    vv = ds.x[rr, cc]
    perm = np.random.default_rng(1).permutation(len(rr))
    cut = int(frac * len(rr))
    return (rr, cc, vv), (perm[:cut], perm[cut:])


def _problems(layout, mean_center=False, **kw):
    (rr, cc, vv), (base, _) = _split()
    args = (rr[base], cc[base], vv[base])
    common = dict(shape=(M, N), p=P, q=Q, rank=R, layout=layout,
                  mean_center=mean_center)
    if layout == "sparse":
        common["headroom"] = 256
    jp = jmc.CompletionProblem.from_entries(*args, **common)
    tp = tmc.CompletionProblem.from_entries(*args, **common, device="cpu",
                                            **kw)
    return jp, tp


@pytest.mark.parametrize("mean_center", [False, True])
@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_problem_append_equals_jax(layout, mean_center):
    (rr, cc, vv), (_, stream) = _split()
    jp, tp = _problems(layout, mean_center)
    assert tp.mu == pytest.approx(jp.mu, rel=1e-6)
    # the stream plus an edit of its first rating, given last
    rows = np.concatenate([rr[stream], rr[stream[:1]]])
    cols = np.concatenate([cc[stream], cc[stream[:1]]])
    vals = np.concatenate([vv[stream], [4.5]]).astype(np.float32)
    jg = jp.append(rows, cols, vals)
    tg = tp.append(rows, cols, vals)
    assert tg.layout == layout and tg.mu == tp.mu
    if layout == "sparse":
        if not mean_center:
            _assert_store_equals_jax(tg.data, jg.data)
        else:          # μ from the two packages' float sums: values to 1e-6
            for f in FIELDS:
                a = getattr(tg.data.entries, f).numpy()
                b = np.asarray(getattr(jg.data.entries, f))
                if f == "vals":
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
                else:
                    np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(tg.data.maskb.numpy(),
                                      np.asarray(jg.data.maskb))
        np.testing.assert_allclose(tg.data.xb.numpy(),
                                   np.asarray(jg.data.xb), rtol=0,
                                   atol=1e-6 if mean_center else 0)
        assert not torch.equal(tg.data.maskb, tp.data.maskb)
    np.testing.assert_array_equal(tg.seen_coo[0], jg.seen_coo[0])
    np.testing.assert_array_equal(tg.seen_coo[1], jg.seen_coo[1])
    assert tp.append([], [], []) is tp
    for bad in (([M + 5], [0], [1.0]), ([0, 1], [0], [1.0])):
        with pytest.raises(ValueError) as got:
            tp.append(*bad)
        with pytest.raises(ValueError) as want:
            jp.append(*bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_gradients_on_the_grown_problem_equal_jax(layout):
    (rr, cc, vv), (_, stream) = _split()
    jp, tp = _problems(layout)
    jg = jp.append(rr[stream], cc[stream], vv[stream])
    tg = tp.append(rr[stream], cc[stream], vv[stream])
    st = jstate.init_state(jax.random.PRNGKey(3), jg.spec)
    U, W = (torch.from_numpy(np.asarray(x).copy()) for x in st[:2])
    want = jwaves.full_gradients(jg.data, st.U, st.W, rho=0.1, lam=0.01)
    got = twaves.full_gradients(tg.data, U, W, rho=0.1, lam=0.01)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL,
                                   atol=RTOL * float(np.abs(b).max()))


def test_placed_problem_appends_only_its_tiles_blocks():
    """Under a 2×2 plan a rank's problem splices only its tile's entries
    (this process is rank 0): the tile of the global append."""

    (rr, cc, vv), (base, stream) = _split()
    args = (rr[base], cc[base], vv[base])
    kw = dict(shape=(M, N), p=4, q=4, rank=R, headroom=256, device="cpu")
    plan = MeshPlan.build(4, 4, grid=(2, 2))
    full = tmc.CompletionProblem.from_entries(*args, **kw)
    placed = tmc.CompletionProblem.from_entries(*args, plan=plan, **kw)
    s = (rr[stream], cc[stream], vv[stream])
    want = plan.local_slice(full.append(*s).data, rank=0)
    got = placed.append(*s)
    assert got.plan == plan
    for f in FIELDS:
        assert torch.equal(getattr(got.data.entries, f),
                           getattr(want.entries, f)), f
    assert torch.equal(got.data.nnz, want.nnz)
    np.testing.assert_array_equal(got.seen_coo[0], full.append(*s).seen_coo[0])


# ---------------------------------------------------------------------- #
# Trainer.refit
# ---------------------------------------------------------------------- #

HP = dict(a=1e-3, b=1e-5, rho=1e2)


@pytest.fixture(scope="module")
def fitted():
    (rr, cc, vv), (base, stream) = _split()
    jp, tp = _problems("sparse")
    cfg = dict(m=jp.spec.m, n=jp.spec.n, p=P, q=Q, rank=R, **HP)
    js0 = jstate.init_state(jax.random.PRNGKey(0), jp.spec)
    np0 = tuple(np.asarray(x) for x in js0)
    jtr, ttr = jmc.Trainer(JConfig(**cfg)), tmc.Trainer(TConfig(**cfg))
    jres = jtr.fit(jp, jmc.FullGD(num_rounds=10), state=js0)
    tres = ttr.fit(tp, tmc.FullGD(num_rounds=10),
                   state=state_from_numpy(*np0, "cpu"))
    s = (rr[stream], cc[stream], vv[stream])
    return (jtr, jres, jp.append(*s)), (ttr, tres, tp.append(*s))


def _close_state(got, want):
    for a, b in ((got.U, want.U), (got.W, want.W)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL,
                                   atol=RTOL * float(np.abs(b).max()))


def _jax_wave_orders(seed, rounds, n_tables):
    """The wave order of each round of JAX's wave ``_fit`` from
    ``PRNGKey(seed)``: a split per round, a permutation of its subkey."""

    key, orders = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, rk = jax.random.split(key)
        orders.append(np.asarray(jax.random.permutation(rk, n_tables)))
    return orders


@pytest.mark.parametrize("reset_clock", [False, True])
def test_refit_equals_jax_refit(fitted, reset_clock, monkeypatch):
    (jtr, jres, jgrown), (ttr, tres, tgrown) = fitted
    want = jtr.refit(jres, jgrown, "full", num_rounds=20,
                     reset_clock=reset_clock)
    got = ttr.refit(tres, tgrown, "full", num_rounds=20,
                    reset_clock=reset_clock)
    assert got.t == want.t
    n_struct = tgrown.spec.num_structures
    assert got.t == (0 if reset_clock else tres.t) + 20 * n_struct
    assert got.schedule == want.schedule == "full"
    assert got.problem is tgrown
    _close_state(got.state, want.state)
    np.testing.assert_allclose([c for _, c in got.history],
                               [c for _, c in want.history], rtol=1e-4)

    # the default Incremental refit: 40 Wave rounds, each in a random wave
    # order, which the port draws from a torch generator; JAX's orders
    # (threefry, not reproducible in torch) are fed to its draws
    rounds = tmc.Incremental().num_rounds
    n_tables = len(twaves.wave_tables(P, Q, "cpu"))
    orders = iter(_jax_wave_orders(0, rounds, n_tables))
    real = torch.randperm

    def replay(n, **kw):
        assert n == n_tables
        return torch.from_numpy(next(orders).copy())

    want = jtr.refit(jres, jgrown, reset_clock=reset_clock)
    monkeypatch.setattr(torch, "randperm", replay)
    got = ttr.refit(tres, tgrown, reset_clock=reset_clock)
    monkeypatch.setattr(torch, "randperm", real)
    assert next(orders, None) is None          # every round drew once
    assert got.schedule == want.schedule == "incremental"
    assert got.t == want.t == (0 if reset_clock else tres.t) + rounds * \
        n_struct
    _close_state(got.state, want.state)
    np.testing.assert_allclose(got.final_cost, want.final_cost, rtol=1e-4)


def test_refit_defaults_and_spec_check(fitted):
    (jtr, jres, _), (ttr, tres, tgrown) = fitted
    assert tmc.make_schedule("incremental") == tmc.Incremental()
    assert (tmc.Incremental().num_rounds, tmc.Incremental().eval_every) == \
        (jmc.Incremental().num_rounds, jmc.Incremental().eval_every) == (40, 0)
    again = ttr.refit(tres, tgrown)
    assert again.schedule == "incremental"
    # 40 wave rounds of every structure; the clock carried over
    assert again.t == tres.t + 40 * tgrown.spec.num_structures
    assert np.isfinite(again.final_cost)
    # defaults to the fitted problem
    assert ttr.refit(tres, num_rounds=1).problem is tres.problem
    with pytest.raises(TypeError) as got:
        ttr.refit(tres, tres.problem.data)
    with pytest.raises(TypeError) as want:
        jtr.refit(jres, jres.problem.data)
    assert str(got.value).split(",")[0] == str(want.value).split(",")[0]
    other = tmc.CompletionProblem.from_dense(
        np.zeros((M, N + Q), np.float32), np.ones((M, N + Q), np.float32),
        P, Q, R, device="cpu")
    with pytest.raises(ValueError, match="matching factor shapes"):
        ttr.refit(tres, other)


# ---------------------------------------------------------------------- #
# RefreshPolicy and note_append
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("kw", [
    dict(), dict(max_appends=0), dict(max_appends=-3),
    dict(max_age_seconds=0.0), dict(max_appends=5, max_age_seconds=-1.0),
])
def test_refresh_policy_validation_equals_jax(kw):
    with pytest.raises(ValueError) as got:
        RefreshPolicy(**kw)
    with pytest.raises(ValueError) as want:
        JPolicy(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(max_appends=10), dict(max_age_seconds=2.5),
    dict(max_appends=10, max_age_seconds=2.5),
])
def test_refresh_policy_due_equals_jax(kw):
    got, want = RefreshPolicy(**kw), JPolicy(**kw)
    for appends in (0, 9, 10, 11):
        for age in (0.0, 2.4, 2.5, 9.0):
            assert got.due(appends, age) == want.due(appends, age)


def _tiny_fit():
    (rr, cc, vv), (base, stream) = _split()
    _, tp = _problems("sparse")
    cfg = TConfig(m=tp.spec.m, n=tp.spec.n, p=P, q=Q, rank=R, **HP)
    trainer = tmc.Trainer(cfg)
    return trainer, trainer.fit(tp, tmc.Wave(num_rounds=5), seed=0), \
        (rr[stream], cc[stream], vv[stream])


def test_note_append_trips_refit_and_hot_swap():
    trainer, result, (rs, cs, vs) = _tiny_fit()
    obs.reset()
    users = np.arange(20, dtype=np.int32)
    policy = RefreshPolicy(max_appends=100)
    with result.to_engine(buckets=(8, 32), k=5, trainer=trainer,
                          refresh_policy=policy, seen_headroom=64) as eng:
        old = eng._bufs
        before = eng.submit(users).result(timeout=TIMEOUT)
        problem, tripped_on = result.problem, None
        trips = []
        for s in range(0, len(rs), 60):
            sl = slice(s, s + 60)
            problem = problem.append(rs[sl], cs[sl], vs[sl])
            trips.append(eng.note_append(len(rs[sl]), problem))
            tripped_on = problem if trips[-1] else tripped_on
        after = eng.submit(users).result(timeout=TIMEOUT)
        metrics = eng.metrics()
        new = eng._bufs
    n_trips, acc, expect = sum(trips), 0, []
    for s in range(0, len(rs), 60):
        acc += len(rs[s:s + 60])
        expect.append(acc >= policy.max_appends)
        acc = 0 if expect[-1] else acc
    assert trips == expect and n_trips >= 1
    assert metrics["refreshes"] == n_trips
    assert metrics["compiles"] == 2
    assert metrics["appends_since_refresh"] == eng.appends_since_refresh
    assert eng.appends_since_refresh < policy.max_appends
    assert new is not old
    # each answer is the index version it ran against
    for (items, scores), idx in ((before, old), (after, new)):
        want_i, want_s = recommend_topk(idx, np.pad(users, (0, 12)), k=5)
        np.testing.assert_array_equal(scores, want_s.numpy()[:20])
        np.testing.assert_array_equal(items, want_i.numpy()[:20])
    # the last refit ran on the problem grown up to its trip
    assert eng._fit_result.problem is tripped_on
    assert eng._fit_result.schedule == "incremental"


def test_note_append_unbound_is_bookkeeping():
    trainer, result, _ = _tiny_fit()
    obs.reset()
    with result.to_engine(buckets=(8,), k=5) as eng:
        assert eng.note_append(500) is False
        assert eng.appends_since_refresh == 500
        assert eng.metrics()["appends_since_refresh"] == 500
        assert eng.metrics()["refreshes"] == 0
        with pytest.raises(ValueError, match="non-negative"):
            eng.note_append(-1)
    with ServingEngine(result.to_recommend_index(), buckets=(8,), k=5,
                       refresh_policy=RefreshPolicy(max_appends=1)) as eng:
        assert eng.note_append(5) is False       # no trainer bound
        eng.refresh(result)
        assert eng.appends_since_refresh == 0


# ---------------------------------------------------------------------- #
# launch/streaming.py
# ---------------------------------------------------------------------- #


def test_streaming_launcher_prints_the_benchmarks_rows():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tstreaming.main(["--m", "40", "--n", "36", "--grid", "2", "2",
                         "--rank", "3", "--rounds", "8", "--batches", "10",
                         "50", "--headroom", "64", "--device", "cpu"])
    text = out.getvalue()
    assert "ingest: " in text and "capacity 256/block, headroom 64" in text
    lines = text.splitlines()
    rows = lines[lines.index(f"{'batch':>8} {'ms':>9} {'entries/s':>12}")
                 + 1:][:2]
    assert [int(r.split()[0]) for r in rows] == [10, 50]
    for label, rounds in (("initial fit", 8), ("warm refit", 2),
                          ("cold fit", 8)):
        row = [ln for ln in lines if ln.strip().startswith(label)]
        assert len(row) == 1 and int(row[0].split()[2]) == rounds
        assert np.isfinite(float(row[0].split()[-1]))
    assert "refit speedup" in lines[-1] and "2/8 rounds" in lines[-1]
