"""The port's objective and gradients against the JAX package's, on the CPU.

Same numpy data and factors on both sides; the port's plain paths run on
CPU tensors.  Tolerance: rtol=1e-5, atol=1e-5·max|ref| (float32 sums in
another order).  The port's sparse and dense layouts are also held to
each other at 1e-5, as the reference's are (DESIGN.md §3)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import sparse as jsparse  # noqa: E402
from repro.core import grid as jgrid  # noqa: E402
from repro.core import objective as jobj  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.core import waves as jwaves  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    problem_from_numpy,
    sparse_problem_from_numpy,
)
from repro_torch.core import objective as tobj  # noqa: E402
from repro_torch.core import state as tstate  # noqa: E402
from repro_torch.core import waves as twaves  # noqa: E402
from repro_torch.sparse import objective as tsparse_obj  # noqa: E402
from repro_torch.sparse.store import ensure_layout  # noqa: E402

torch.set_num_threads(2)

RHO, LAM = 1e3, 1e-6


def _setup(p=3, q=2, mb=16, nb=20, r=3, density=0.3, seed=0):
    rng = np.random.default_rng(seed)
    m, n = p * mb, q * nb
    x = rng.normal(size=(m, n)).astype(np.float32) * 2.0
    mask = (rng.random((m, n)) < density).astype(np.float32)
    mask[:mb, :nb] = 0.0                         # block (0, 0) has no entries
    spec = jgrid.GridSpec(m, n, p, q, r)
    jd = jstate.make_problem(x, mask, spec)
    js = jsparse.from_blocks(np.asarray(jd.xb), np.asarray(jd.maskb),
                             bucket=64)
    e = js.entries
    td = problem_from_numpy(np.asarray(jd.xb), np.asarray(jd.maskb), "cpu")
    ts = sparse_problem_from_numpy(
        *(np.asarray(f) for f in e), np.asarray(js.nnz), device="cpu")
    U = rng.normal(size=(p, q, mb, r)).astype(np.float32)
    W = rng.normal(size=(p, q, nb, r)).astype(np.float32)
    return {"dense": (jd, td), "sparse": (js, ts)}, U, W, spec


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("layout,method", [("dense", "segment"),
                                           ("sparse", "segment"),
                                           ("sparse", "scatter")])
def test_full_gradients_match_jax(layout, method):
    probs, U, W, _ = _setup()
    jp, tp = probs[layout]
    jg = jwaves.full_gradients(jp, U, W, rho=RHO, lam=LAM, method=method)
    tg = twaves.full_gradients(tp, torch.from_numpy(U), torch.from_numpy(W),
                               rho=RHO, lam=LAM, method=method)
    for g, want in zip(tg, jg):
        _close(g, want)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_total_cost_and_objective_match_jax(layout):
    probs, U, W, _ = _setup(seed=1)
    jp, tp = probs[layout]
    tU, tW = torch.from_numpy(U), torch.from_numpy(W)
    _close(tobj.total_cost(tp, tU, tW, LAM), jobj.total_cost(jp, U, W, LAM))
    for a, b in zip(tobj.consensus_costs(tU, tW), jobj.consensus_costs(U, W)):
        _close(a, b)
    jd, td = probs["dense"]
    _close(tobj.full_objective(td.xb, td.maskb, tU, tW, RHO, LAM),
           jobj.full_objective(jd.xb, jd.maskb, U, W, RHO, LAM))
    js, ts = probs["sparse"]
    _close(tsparse_obj.full_objective_sparse(ts, tU, tW, RHO, LAM),
           jsparse.full_objective_sparse(js, U, W, RHO, LAM))
    _close(tobj.block_residual(td.xb[1, 1], td.maskb[1, 1], tU[1, 1], tW[1, 1]),
           jobj.block_residual(jd.xb[1, 1], jd.maskb[1, 1], U[1, 1], W[1, 1]))


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_structure_grads_match_jax(layout):
    """All structures of the grid at once on the port side (leading axes,
    one f-gradient call) against per-structure calls on the JAX side."""

    probs, U, W, spec = _setup(p=3, q=3, seed=2)
    jp, tp = probs[layout]
    structs = jgrid.enumerate_structures(spec.p, spec.q)
    jt = jstate.build_tables(spec.p, spec.q, structs)
    tt = tstate.build_tables(spec.p, spec.q, structs, device="cpu")
    bi, bj = tt.blocks[..., 0].long(), tt.blocks[..., 1].long()
    tU, tW = torch.from_numpy(U), torch.from_numpy(W)
    if layout == "sparse":
        gu, gw = tobj.structure_grads_sparse(
            tp.entries.gather(bi, bj), tU[bi, bj], tW[bi, bj],
            tt.cf, tt.cu, tt.cw, rho=RHO, lam=LAM)
    else:
        gu, gw = tobj.structure_grads(
            tp.xb[bi, bj], tp.maskb[bi, bj], tU[bi, bj], tW[bi, bj],
            tt.cf, tt.cu, tt.cw, rho=RHO, lam=LAM)
    blocks = np.asarray(jt.blocks)
    for s in range(len(structs)):
        b0, b1 = blocks[s, :, 0], blocks[s, :, 1]
        args = (U[b0, b1], W[b0, b1], jt.cf[s], jt.cu[s], jt.cw[s])
        if layout == "sparse":
            want = jobj.structure_grads_sparse(jp.entries.gather(b0, b1),
                                               *args, rho=RHO, lam=LAM)
        else:
            want = jobj.structure_grads(jp.xb[b0, b1], jp.maskb[b0, b1],
                                        *args, rho=RHO, lam=LAM)
        _close(gu[s], want[0])
        _close(gw[s], want[1])


@pytest.mark.parametrize("method", ["segment", "scatter"])
def test_port_sparse_matches_port_dense(method):
    probs, U, W, _ = _setup(seed=3)
    (_, td), (_, ts) = probs["dense"], probs["sparse"]
    tU, tW = torch.from_numpy(U), torch.from_numpy(W)
    dense = twaves.full_gradients(td, tU, tW, rho=RHO, lam=LAM)
    sparse = twaves.full_gradients(ts, tU, tW, rho=RHO, lam=LAM,
                                   method=method)
    for a, b in zip(sparse, dense):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tobj.total_cost(ts, tU, tW, LAM, method=method),
                               tobj.total_cost(td, tU, tW, LAM), rtol=1e-5,
                               atol=0)


def test_gamma_matches_jax():
    t = np.array([0, 7, 123456], np.int32)
    _close(tobj.gamma(torch.from_numpy(t).float(), 5e-4, 5e-7),
           jobj.gamma(t.astype(np.float32), 5e-4, 5e-7), rtol=1e-7)


def test_ensure_layout():
    probs, _, _, _ = _setup(seed=4)
    (jd, td), (js, ts) = probs["dense"], probs["sparse"]
    assert ensure_layout(td, None) is td and ensure_layout(ts, "sparse") is ts
    assert ensure_layout(td, "dense") is td
    got = ensure_layout(td, "sparse", bucket=64)
    for f, want in zip(got.entries, js.entries):
        np.testing.assert_array_equal(f.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="to_dense"):
        ensure_layout(ts, "dense")
    with pytest.raises(ValueError, match="unknown layout"):
        ensure_layout(td, "csr")
