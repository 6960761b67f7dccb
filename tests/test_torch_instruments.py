"""The port's twins of the paper workload's instruments against the JAX
package's scripts in ``benchmarks/``, loaded by file path.

* ``launch/serving_traffic.py``: the request tape and the random index
  bitwise; the engine phase's answers equal to the JAX engine's on every
  row whose top k + 1 scores are apart by more than 1e-4 (float64 on the
  host); the int8 overlap gate failing the run when the codes are
  degraded; the ``--json`` payload keys equal to the JAX script's.
* ``kernels/quant/autotune.py``: the committed sweep reader.
* ``launch/sparse_vs_dense.py``: the three engines agree to 1e-5
  (relative to max |∇L| and to |cost|); dense, sorted and scatter ∇L and
  cost equal to JAX's on the same problem and JAX's initial ``State`` to
  rel 1e-5; the row keys hold the JAX script's.
* ``launch/gossip_comm.py``: the analytic rows exactly equal at the JAX
  script's ICI rate; ``--measure`` on 2 × 2 ``gloo`` CPU ranks gives JAX's
  halo bytes and its consensus error to 1e-5 abs, both fits from JAX's
  initial ``State`` (JAX on 4 forced host devices in a subprocess).
"""

import argparse
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.state import init_state as j_init_state  # noqa: E402
from repro.data import lowrank_problem as j_lowrank  # noqa: E402
from repro.mc import CompletionProblem as JProblem  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.config import GossipMCConfig  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.data import lowrank_problem  # noqa: E402
from repro_torch.kernels.quant import autotune  # noqa: E402
from repro_torch.launch import gossip_comm as GC  # noqa: E402
from repro_torch.launch import serving_traffic as ST  # noqa: E402
from repro_torch.launch import sparse_vs_dense as SVD  # noqa: E402
from repro_torch.launch.gossip import shutdown  # noqa: E402
from repro_torch.roofline import HW  # noqa: E402
from repro_torch.serve import quant as tq  # noqa: E402

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SUBPROCESS_TIMEOUT = 300
# the small serving cell: ~300 x 200, r = 8, 20 requests
SMALL = dict(users=300, items=200, rank=8, density=0.02, seed=0,
             requests=20, rate=2000.0)
BUCKETS = (8, 32)
TIE_GAP = 1e-4


def _bench(name):
    if str(ROOT) not in sys.path:          # the scripts import benchmarks.run
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jst():
    return _bench("serving_traffic")


def _args(**kw):
    return argparse.Namespace(**{**SMALL, **kw})


# ---------------------------------------------------------------------------
# serving_traffic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,rate,requests,buckets",
                         [(0, 100.0, 200, (16, 64, 256)),
                          (3, 2000.0, 20, BUCKETS),
                          (7, 50.0, 300, (16, 64, 256, 1024))])
def test_tape_is_bitwise_the_jax_tape(jst, seed, rate, requests, buckets):
    a = _args(seed=seed, rate=rate, requests=requests)
    jg, jr = jst._make_schedule(a, buckets)
    tg, tr = ST.make_schedule(requests, rate, a.users, seed, buckets)
    assert np.array_equal(jg, tg) and jg.dtype == tg.dtype
    assert len(jr) == len(tr)
    for x, y in zip(jr, tr):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_random_index_is_the_jax_index(jst):
    ji = jst._random_index(_args())
    ti = ST.random_index(300, 200, 8, 0.02, 0, "cpu")
    for name in ("u", "w", "seen"):
        assert np.array_equal(np.asarray(getattr(ji, name)),
                              getattr(ti, name).numpy())


def _tie_free(u, w, seen_mask, users, k):
    s = u[users].astype(np.float64) @ w.T.astype(np.float64)
    s[seen_mask[users]] = -np.inf
    top = -np.sort(-s, axis=1)[:, :k + 1]
    return (-np.diff(top, axis=1) > TIE_GAP).all(axis=1)


def test_engine_answers_equal_the_jax_engine(jst):
    a = _args()
    k = 10
    gaps, reqs = ST.make_schedule(a.requests, a.rate, a.users, a.seed,
                                  BUCKETS)
    index = ST.random_index(a.users, a.items, a.rank, a.density, a.seed,
                            "cpu")
    payload, extra = ST.replay(index, gaps, reqs, buckets=BUCKETS, k=k,
                               log=lambda *_: None)
    assert payload["engine"]["compiles"] == len(BUCKETS)
    assert payload["baseline"]["compiles"] == 1     # the in-band warm-up
    jeng = JEngine(jst._random_index(a), buckets=BUCKETS, k=k)
    try:
        _, _, jans = jst._drive(jeng.submit, gaps, reqs)
    finally:
        jeng.shutdown()
    rng = np.random.default_rng(a.seed)
    u = rng.normal(size=(a.users, a.rank)).astype(np.float32)
    w = rng.normal(size=(a.items, a.rank)).astype(np.float32)
    mask = rng.random((a.users, a.items)) < a.density
    checked = 0
    for users, got, want in zip(reqs, extra["answers"], jans):
        ok = _tie_free(u, w, mask, users, k)
        np.testing.assert_array_equal(got[ok], want[ok])
        checked += int(ok.sum())
    assert checked > 0.9 * sum(len(r) for r in reqs)


def _cli(**kw):
    a = {**SMALL, **kw}
    out = []
    for key in ("users", "items", "rank", "density", "seed", "requests",
                "rate"):
        out += [f"--{key}", str(a[key])]
    return out + ["--buckets", ",".join(map(str, BUCKETS))]


def test_quant_payload_keys_equal_jax_and_gate_holds(jst, tmp_path,
                                                     monkeypatch):
    jpath, tpath = tmp_path / "jax.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["serving_traffic.py", *_cli(),
                                      "--quant", "--json", str(jpath)])
    jst.main()
    payload = ST.main([*_cli(), "--quant", "--json", str(tpath),
                       "--device", "cpu"])
    want, got = json.loads(jpath.read_text()), json.loads(tpath.read_text())
    envelope = {"bench", "backend", "machine", "git_rev", "config",
                "metrics"}
    assert set(payload) == set(want) - envelope
    assert set(got) >= set(payload) | {"bench", "backend", "machine",
                                       "config", "metrics"}
    for key in ("engine", "quant", "index_bytes"):
        assert set(payload[key]) == set(want[key]), key
    assert set(payload["engine_metrics"]) == set(want["engine_metrics"])
    assert set(payload["method_sweep_ms"]) == set(want["method_sweep_ms"])
    assert set(got["method_sweep_spread_ms"]) == \
        set(payload["method_sweep_ms"])
    assert payload["index_bytes"] == want["index_bytes"]
    assert payload["overlap_at_k"] >= 0.99
    assert got["backend"] == "cpu" and got["config"]["k"] == 100
    # without --quant: the baseline's keys
    plain = ST.main([*_cli(), "--device", "cpu"])
    assert set(plain) == {"engine", "engine_metrics", "baseline"}


def test_quant_gate_fails_the_run_on_degraded_codes(monkeypatch):
    def degraded(index):
        q = tq.quantize_index(index)
        return q._replace(w_q=q.w_q.flip(0))        # items' codes shuffled

    monkeypatch.setattr(ST, "quantize_index", degraded)
    with pytest.raises(AssertionError, match="accuracy gate"):
        ST.main([*_cli(), "--quant", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the committed method sweep
# ---------------------------------------------------------------------------


def test_sweep_reader_on_a_file(tmp_path):
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps({"backend": "cuda", "method_sweep_ms": {
        "fused": 0.5, "dequant": 0.25, "other": 0.01}}))
    assert autotune._sweep_table(str(path)) == {"cuda": "dequant"}
    path.write_text(json.dumps({"backend": "cuda"}))
    assert autotune._sweep_table(str(path)) == {}


def test_explicit_method_wins_and_cpu_resolves_to_dequant():
    for device in ("cpu", "cuda"):
        for m in autotune.METHODS:
            assert autotune.resolve_method(m, device) == m
    assert autotune.resolve_method(None, "cpu") == "dequant"
    with pytest.raises(ValueError):
        autotune.resolve_method("int4", "cpu")


def test_cuda_resolves_to_the_committed_winner():
    data = json.loads(pathlib.Path(autotune.SWEEP_PATH).read_text())
    assert data["backend"] == "cuda" and data["bench"] == "serving_traffic"
    sweep = data["method_sweep_ms"]
    assert set(sweep) == set(autotune.METHODS)
    winner = min(sweep, key=sweep.get)
    assert autotune._committed_sweep() == {"cuda": winner}
    assert autotune.resolve_method(None, "cuda") == winner
    assert autotune.resolve_method(None, torch.device("cuda", 0)) == winner
    card = data["machine"]["card"]
    assert card["name"] and card["power_limit"]
    cfg = data["config"]
    assert (cfg["users"], cfg["items"], cfg["rank"]) == (6040, 3706, 15)
    assert cfg["buckets"] == [16, 64, 256, 1024] and cfg["quant"]


# ---------------------------------------------------------------------------
# sparse_vs_dense
# ---------------------------------------------------------------------------

M, N, P, Q, R = 64, 48, 2, 2, 4
DENSITIES = (0.1, 0.3)


def _jax_state():
    from repro.core import grid as G

    st = j_init_state(jax.random.PRNGKey(0), G.GridSpec(M, N, P, Q, R))
    return np.asarray(st.U), np.asarray(st.W)


@pytest.mark.parametrize("density", DENSITIES)
def test_engines_equal_jax_cost_and_gradient(density):
    cfg = GossipMCConfig(m=M, n=N, p=P, q=Q, rank=R)
    jd = JProblem.from_dataset(j_lowrank(M, N, R, density=density, seed=0),
                               P, Q, R, layout="dense")
    jst_ = j_init_state(jax.random.PRNGKey(0), jd.spec)
    jg = [np.asarray(x) for x in jd.full_gradients(jst_, rho=cfg.rho,
                                                   lam=cfg.lam)]
    jc = float(jd.total_cost(jst_, cfg.lam))
    st = state_from_numpy(np.asarray(jst_.U), np.asarray(jst_.W), 0, "cpu")
    for pr in SVD.engines(lowrank_problem(M, N, R, density=density, seed=0),
                          P, Q, R, "cpu"):
        g = pr.full_gradients(st, rho=cfg.rho, lam=cfg.lam)
        for x, y in zip(g, jg):
            np.testing.assert_allclose(x.numpy(), y, rtol=0,
                                       atol=1e-5 * np.abs(y).max())
        assert abs(pr.total_cost(st, cfg.lam) - jc) <= 1e-5 * abs(jc)


def test_sweep_rows_agree_and_hold_the_jax_keys(tmp_path, monkeypatch):
    jsvd = _bench("sparse_vs_dense")
    path = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", [
        "sparse_vs_dense.py", "--m", str(M), "--n", str(N), "--grid", "2",
        "2", "--rank", str(R), "--densities", *map(str, DENSITIES),
        "--iters", "1", "--chunks", "16", "32", "--json", str(path)])
    jsvd.main()
    want = json.loads(path.read_text())["rows"]
    U, W = _jax_state()
    rows = SVD.sweep(M, N, (P, Q), R, DENSITIES, iters=1, chunks=(16, 32),
                     device="cpu", state=state_from_numpy(U, W, 0, "cpu"))
    assert len(rows) == len(want)
    for got, w in zip(rows, want):
        assert set(got) >= set(w)
        assert got["nnz"] == w["nnz"] and got["density"] == w["density"]
        assert set(got["chunk_sweep_ms"]) == set(w["chunk_sweep_ms"])
        for key in ("grad_reldiff_sorted_vs_dense",
                    "grad_reldiff_scatter_vs_dense",
                    "cost_reldiff_sorted_vs_dense",
                    "cost_reldiff_scatter_vs_dense"):
            assert got[key] <= 1e-5, (key, got[key])
    out = SVD.main(["--m", str(M), "--n", str(N), "--grid", "2", "2",
                    "--rank", str(R), "--densities", "0.2", "--iters", "1",
                    "--chunks", "16", "--device", "cpu"])
    assert out[0]["chunk_best"] == 16


# ---------------------------------------------------------------------------
# gossip_comm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [64, 15])
def test_analytic_rows_equal_jax(rank):
    jgc = _bench("gossip_comm")
    got = GC.analytic_rows(rank, HW(ici_bw=jgc.ICI))
    want = jgc.analytic_rows(rank)
    assert len(got) == 9 == len(want)
    assert got == want
    h100 = GC.analytic_rows(rank)
    assert [r["ici_us"] for r in h100] == [
        r["gossip_bytes"] / 450e9 * 1e6 for r in want]


MEASURE_ROUNDS = 5


def test_measure_on_gloo_ranks_equals_jax(tmp_path):
    out = tmp_path / "jax.npz"
    prog = f"""
    import json, sys
    import importlib.util
    import jax, numpy as np
    sys.path.insert(0, {str(ROOT)!r})
    from repro import mc
    from repro.core import state as S
    assert len(jax.devices()) == 4
    spec = importlib.util.spec_from_file_location(
        "gossip_comm", {str(ROOT / "benchmarks" / "gossip_comm.py")!r})
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = {{}}
    fit = mc.Trainer.fit

    def fit_from_state(self, problem, schedule, *a, **kw):
        # the bench draws its state inside the fit; hand it one drawn
        # here, so that the port can start from the same
        st0 = S.init_state(jax.random.PRNGKey(0), problem.spec)
        saved.update(U0=np.asarray(st0.U), W0=np.asarray(st0.W))
        return fit(self, problem, schedule, *a, state=st0, **kw)

    mc.Trainer.fit = fit_from_state
    row = mod.measured_row({MEASURE_ROUNDS})
    np.savez({str(out)!r}, consensus=row["consensus_error"],
             cost=row["final_cost"], halo=json.dumps(row["halo"]),
             grid=row["grid"], **saved)
    """
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(prog)],
                         capture_output=True, text=True, env=env,
                         timeout=SUBPROCESS_TIMEOUT)
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr}"
    want = np.load(out)
    try:
        got = GC.measured_row(MEASURE_ROUNDS, device="cpu",
                              state=(want["U0"], want["W0"], 0))
    finally:
        shutdown()
    assert got["grid"] == str(want["grid"]) == "2x2"
    assert got["backend"] == "gloo" and got["devices"] == 4
    assert got["halo"] == json.loads(str(want["halo"]))
    assert abs(got["consensus_error"] - float(want["consensus"])) <= 1e-5
    assert abs(got["final_cost"] - float(want["cost"])) <= \
        1e-4 * abs(float(want["cost"]))
    assert got["ms_per_round"] > 0
