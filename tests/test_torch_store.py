"""The port's data plumbing against the JAX package's: grid bookkeeping,
structure tables and the segment-sorted sparse store.  These are integer
and copy paths, so they are held equal exactly, field for field."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import sparse as jsparse  # noqa: E402
from repro.core import grid as jgrid  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.data import movielens_proxy as j_movielens  # noqa: E402
from repro.mc import CompletionProblem as JProblem  # noqa: E402
from repro.mc import EngineOptions as JEngine  # noqa: E402
from repro_torch.core import grid as tgrid  # noqa: E402
from repro_torch.core import state as tstate  # noqa: E402
from repro_torch.data import movielens_proxy as t_movielens  # noqa: E402
from repro_torch.mc import CompletionProblem as TProblem  # noqa: E402
from repro_torch.mc import EngineOptions as TEngine  # noqa: E402
from repro_torch.sparse import store as tstore  # noqa: E402

torch.set_num_threads(2)

FIELDS = ("rows", "cols", "vals", "valid", "col_perm", "row_ptr", "col_ptr")


def _assert_store_equal(tsp, jsp):
    assert tsp.capacity == jsp.capacity
    for f in FIELDS:
        a = getattr(tsp.entries, f)
        b = np.asarray(getattr(jsp.entries, f))
        assert str(a.dtype) == f"torch.{b.dtype}", f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    assert tsp.nnz.dtype == torch.int32
    np.testing.assert_array_equal(tsp.nnz.numpy(), np.asarray(jsp.nnz))


def _blocks(p, q, mb, nb, density, seed):
    rng = np.random.default_rng(seed)
    mask = (rng.random((p, q, mb, nb)) < density).astype(np.float32)
    mask[0, 0] = 0.0                                   # an empty block
    x = (rng.normal(size=mask.shape) * mask).astype(np.float32)
    return x, mask


@pytest.mark.parametrize("p,q,mb,nb,density,bucket,headroom", [
    (2, 3, 16, 24, 0.3, 64, 0), (3, 2, 40, 17, 0.3, 256, 5),
    (2, 2, 20, 20, 1.0, 16, 0),
])
def test_from_blocks_fields_equal(p, q, mb, nb, density, bucket, headroom):
    x, mask = _blocks(p, q, mb, nb, density, seed=p * q + mb)
    tsp = tstore.from_blocks(x, mask, bucket, headroom, device="cpu")
    jsp = jsparse.from_blocks(x, mask, bucket, headroom)
    _assert_store_equal(tsp, jsp)
    assert tsp.mb == mb and tsp.nb == nb
    assert tstore.density(tsp) == pytest.approx(jsparse.density(jsp), abs=0)
    xb, maskb = tstore.to_dense(tsp)
    np.testing.assert_array_equal(xb, x)
    np.testing.assert_array_equal(maskb, mask)


@pytest.mark.parametrize("m,n,p,q", [(37, 29, 3, 2), (40, 40, 2, 2)])
def test_from_entries_fields_equal(m, n, p, q):
    rng = np.random.default_rng(m + n)
    lin = rng.choice(m * n, size=m * n // 4, replace=False)
    rows, cols = lin // n, lin % n
    vals = rng.normal(size=len(lin)).astype(np.float32)
    tsp, tshape = tstore.from_entries(rows, cols, vals, m, n, p, q, 32,
                                      device="cpu")
    jsp, jshape = jsparse.from_entries(rows, cols, vals, m, n, p, q, 32)
    assert tshape == jshape
    _assert_store_equal(tsp, jsp)


def test_from_entries_rejects_out_of_range():
    with pytest.raises(ValueError, match="out of range"):
        tstore.from_entries(np.array([5]), np.array([0]), np.array([1.0]),
                            5, 5, 1, 1, device="cpu")


def test_bucketed_capacity_equal():
    for args in [(0, 256, 0), (300, 256, 0), (10, 8, 7), (512, 256, 1)]:
        assert tstore.bucketed_capacity(*args) == \
            jsparse.bucketed_capacity(*args)
    with pytest.raises(ValueError):
        tstore.bucketed_capacity(3, 0)


@pytest.mark.parametrize("p,q", [(2, 2), (2, 3), (3, 3), (5, 5)])
def test_grid_and_tables_equal(p, q):
    np.testing.assert_array_equal(tgrid.enumerate_structures(p, q),
                                  jgrid.enumerate_structures(p, q))
    for k, v in jgrid.normalization_coefficients(p, q).items():
        np.testing.assert_array_equal(
            tgrid.normalization_coefficients(p, q)[k], v)
    tw, jw = tgrid.wave_schedule(p, q), jgrid.wave_schedule(p, q)
    assert len(tw) == len(jw)
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a, b)
    structs = jgrid.enumerate_structures(p, q)
    tt = tstate.build_tables(p, q, structs, device="cpu")
    jt = jstate.build_tables(p, q, structs)
    for a, b in zip(tt, jt):
        assert str(a.dtype) == f"torch.{np.asarray(b).dtype}"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_blockify_and_make_problem_equal():
    rng = np.random.default_rng(0)
    spec = tgrid.GridSpec(12, 15, 3, 5, 2)
    x = rng.normal(size=(12, 15)).astype(np.float32)
    mask = (rng.random((12, 15)) < 0.4).astype(np.float32)
    tp = tstate.make_problem(x, mask, spec, device="cpu")
    jp = jstate.make_problem(x, mask, jgrid.GridSpec(12, 15, 3, 5, 2))
    np.testing.assert_array_equal(tp.xb.numpy(), np.asarray(jp.xb))
    np.testing.assert_array_equal(tp.maskb.numpy(), np.asarray(jp.maskb))
    np.testing.assert_array_equal(tgrid.unblockify(tp.xb.numpy(), spec),
                                  x * mask)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_completion_problem_data_equal(layout):
    """Constructors over a MovieLens-like proxy (grid padding, mean
    centering) build the same data and seen table as the reference."""

    kw = dict(num_users=90, num_items=70, num_ratings=1500, seed=1)
    tds, jds = t_movielens(**kw), j_movielens(**kw)
    np.testing.assert_array_equal(tds.x, jds.x)
    np.testing.assert_array_equal(tds.test_vals, jds.test_vals)
    tp = TProblem.from_dataset(tds, 4, 3, 5, layout=layout,
                               mean_center=True, engine=TEngine(bucket=32),
                               device="cpu")
    jp = JProblem.from_dataset(jds, 4, 3, 5, layout=layout,
                               mean_center=True, engine=JEngine(bucket=32))
    assert tp.spec == tgrid.GridSpec(*jp.spec.__dict__.values())
    assert tp.mu == jp.mu and tp.layout == jp.layout
    assert tp.density == pytest.approx(jp.density, rel=1e-6)
    for a, b in zip(tp.seen_coo, jp.seen_coo):
        np.testing.assert_array_equal(a, b)
    if layout == "sparse":
        _assert_store_equal(tp.data, jp.data)
        back = tp.with_layout("dense").data
        np.testing.assert_array_equal(back.xb.numpy(),
                                      np.asarray(jp.with_layout("dense").data.xb))
    else:
        np.testing.assert_array_equal(tp.data.xb.numpy(), np.asarray(jp.data.xb))
        np.testing.assert_array_equal(tp.data.maskb.numpy(),
                                      np.asarray(jp.data.maskb))
        _assert_store_equal(tp.with_layout("sparse").data,
                            jp.with_layout("sparse").data)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_from_entries_problem_equal(layout):
    rng = np.random.default_rng(5)
    lin = rng.choice(33 * 21, size=150, replace=False)
    rows, cols = lin // 21, lin % 21
    vals = rng.normal(size=150).astype(np.float32)
    tp = TProblem.from_entries(rows, cols, vals, (33, 21), 2, 2, 3,
                               layout=layout, mean_center=True, device="cpu")
    jp = JProblem.from_entries(rows, cols, vals, (33, 21), 2, 2, 3,
                               layout=layout, mean_center=True)
    assert tp.mu == jp.mu and tp.layout == layout
    if layout == "sparse":
        _assert_store_equal(tp.data, jp.data)
    else:
        np.testing.assert_array_equal(tp.data.xb.numpy(), np.asarray(jp.data.xb))
    for a, b in zip(tp.seen_coo, jp.seen_coo):
        np.testing.assert_array_equal(a, b)
