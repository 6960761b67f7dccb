"""The port's int8 serving math against the JAX package's, on the CPU.

Same numpy inputs on both sides: ``quantize_rows``, the fused and dequant
scoring methods, ``score_pairs`` and ``recommend_topk`` on both index
layouts, and the overlap@100 gate of int8 against f32.

Tolerances:
* integer paths and the fused score are compared **bitwise**: the codes
  and scales come from the same f32 division and round-half-to-even, and
  the fused score is an exact integer dot followed by the same two f32
  multiplies in the same order on both sides;
* float matmul paths (the dequant method, f32 scores, ``score_pairs``)
  at rtol=1e-5 — the two frameworks sum the products in another order;
* top-k items are compared on rows whose top k+1 scores have no ties
  (``torch.topk`` and ``lax.top_k`` may order equal scores differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.quant import dequant_score as j_dequant_score  # noqa: E402
from repro.kernels.quant import dequant_score_ref as j_dequant_ref  # noqa: E402
from repro.kernels.quant import fused_score_xla  # noqa: E402
from repro.serve import quant as jq  # noqa: E402
from repro.serve import recommend as jrec  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.convert import (index_from_numpy,  # noqa: E402
                                 quantized_index_from_numpy)
from repro_torch.kernels.quant import ops as t_ops  # noqa: E402
from repro_torch.kernels.quant import (FALLBACK_METHOD,  # noqa: E402
                                       dequant_score_ref, fused_score_ref,
                                       resolve_method)
from repro_torch.serve import quant as tq  # noqa: E402
from repro_torch.serve import recommend as trec  # noqa: E402

torch.set_num_threads(2)

K = 100


def _arrays(m, n, r, seed, seen_per_user=4):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(m, r)).astype(np.float32)
    w = rng.normal(size=(n, r)).astype(np.float32)
    seen = np.full((m, 16), n, np.int32)
    seen[:, :seen_per_user] = rng.integers(0, n, size=(m, seen_per_user))
    return u, w, seen


def _indexes(m, n, r, seed, seen_per_user=4):
    """(JAX f32, JAX int8, port f32, port int8) over the same arrays; the
    port's int8 index is the JAX codes handed across."""

    u, w, seen = _arrays(m, n, r, seed, seen_per_user)
    jf = jrec.RecommendIndex(jnp.asarray(u), jnp.asarray(w),
                             jnp.asarray(seen))
    jqi = jq.quantize_index(jf)
    tf = index_from_numpy(u, w, seen, "cpu")
    tqi = quantized_index_from_numpy(*(np.asarray(a) for a in jqi), "cpu")
    return jf, jqi, tf, tqi


def _tie_free(top, rel):
    """Rows whose k+1 top scores are pairwise apart by more than
    ``rel``·max|score| (exactly distinct for ``rel=0``)."""

    top = np.asarray(top, np.float64)
    gap = np.abs(np.diff(top, axis=1))
    return (gap > rel * np.abs(top).max()).all(axis=1)


# --------------------------------------------------------------------------
# quantization
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed,shape", [(0, (50, 8)), (1, (200, 32)),
                                        (2, (17, 48)), (3, (1, 128)),
                                        (4, (6040, 15))])
def test_quantize_rows_equals_jax_bitwise(seed, shape):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * rng.lognormal(size=(shape[0], 1))
         ).astype(np.float32)
    x[:: max(1, shape[0] // 3)] *= 0.0                # zero rows
    jqv, jsv = jq.quantize_rows(x)
    q, s = tq.quantize_rows(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jsv))
    zero = ~x.any(axis=1)
    assert zero.any() and (s.numpy()[zero] == 1.0).all()
    assert (q.numpy()[zero] == 0).all()
    back = q.numpy().astype(np.float32) * s.numpy()[:, None]
    bound = np.abs(x).max(axis=1) / 254.0 + 1e-6     # s/2 = amax/254
    assert (np.abs(x - back) <= bound[:, None]).all()


def test_quantize_index_gauges_bytes_and_dequantize():
    obs.reset()
    jf, jqi, tf, _ = _indexes(100, 500, 32, seed=0)
    q = tq.quantize_index(tf)
    assert isinstance(q, tq.QuantizedRecommendIndex)
    assert tq.quantize_index(q) is q
    assert (q.num_users, q.num_items, q.rank) == (100, 500, 32)
    for name in ("u_q", "u_scale", "w_q", "w_scale", "seen"):
        np.testing.assert_array_equal(getattr(q, name).numpy(),
                                      np.asarray(getattr(jqi, name)))
    assert tq.index_nbytes(q) == jq.index_nbytes(jqi)
    assert tq.index_nbytes(tf) == jq.index_nbytes(jf)
    g = obs.snapshot()["gauges"]
    assert g["serve_index_bytes{dtype=f32}"] == tq.index_nbytes(tf)
    assert g["serve_index_bytes{dtype=int8}"] == tq.index_nbytes(q)
    back, jback = q.dequantize(), jqi.dequantize()
    np.testing.assert_array_equal(back.u.numpy(), np.asarray(jback.u))
    np.testing.assert_array_equal(back.w.numpy(), np.asarray(jback.w))


def test_quantized_refresh_requantizes_and_guards_shapes():
    _, _, tf, _ = _indexes(30, 50, 8, seed=10)
    q = tq.quantize_index(tf)

    class FakeFit:
        def __init__(self, index):
            self._i = index

        def to_recommend_index(self):
            return self._i

    bad = tf._replace(w=torch.ones((51, 8)))
    with pytest.raises(ValueError) as ei:
        q.refresh(FakeFit(bad))
    assert "expected u(30, 8) x w(50, 8) (int8 layout)" in str(ei.value)
    assert "got u(30, 8) x w(51, 8)" in str(ei.value)
    with pytest.raises(ValueError, match="expected u\\(30, 8\\) x w\\(50, 8\\)"):
        tf.refresh(FakeFit(bad))
    _, _, tf2, _ = _indexes(30, 50, 8, seed=11)
    q2 = q.refresh(FakeFit(tf2))
    np.testing.assert_array_equal(q2.u_q.numpy(),
                                  tq.quantize_index(tf2).u_q.numpy())
    assert tf.refresh(FakeFit(tf2)) is tf2


# --------------------------------------------------------------------------
# scoring methods
# --------------------------------------------------------------------------


# the JAX package's kernel-parity shapes, and a top serving bucket against
# the MovieLens-1M catalog at the paper's rank; then the CUDA kernel's
# edges at the bucket B = 16 and 64: catalogs of n = 1 and 3 (mod 4), so
# output rows start at every misalignment, and r = 16 and 17 across its
# 16-byte staging
@pytest.mark.parametrize("seed,b,n,r", [(0, 8, 100, 16), (1, 32, 700, 32),
                                        (2, 5, 129, 50), (3, 64, 3706, 15),
                                        (4, 16, 333, 15), (5, 16, 335, 15),
                                        (6, 64, 700, 16), (7, 64, 700, 17)])
def test_fused_equals_pallas_kernel_and_xla_bitwise(seed, b, n, r):
    _, jqi, _, tqi = _indexes(max(b, 8), n, r, seed=seed)
    args_j = (jqi.u_q[:b], jqi.u_scale[:b], jqi.w_q, jqi.w_scale)
    args_t = (tqi.u_q[:b], tqi.u_scale[:b], tqi.w_q, tqi.w_scale)
    n0 = t_ops.dequant_score.launches
    got = t_ops.dequant_score(*args_t, method="fused").numpy()
    assert t_ops.dequant_score.launches == n0           # CPU: plain version
    kern = j_dequant_score(*args_j, method="fused", force_kernel=True,
                           interpret=True)
    assert got.shape == (b, n) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(kern))
    np.testing.assert_array_equal(got, np.asarray(fused_score_xla(*args_j)))
    np.testing.assert_array_equal(fused_score_ref(*args_t).numpy(), got)


@pytest.mark.parametrize("seed,b,n,r", [(1, 60, 300, 24), (3, 64, 3706, 15)])
def test_dequant_method_matches_jax_reference(seed, b, n, r):
    _, jqi, _, tqi = _indexes(b, n, r, seed=seed)
    got = t_ops.dequant_score(tqi.u_q, tqi.u_scale, tqi.w_q, tqi.w_scale,
                              method="dequant").numpy()
    want = np.asarray(j_dequant_ref(jqi.u_q, jqi.u_scale, jqi.w_q,
                                    jqi.w_scale))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(
        dequant_score_ref(tqi.u_q, tqi.u_scale, tqi.w_q, tqi.w_scale).numpy(),
        got)
    # None on CPU tensors resolves to the dequant method
    none = t_ops.dequant_score(tqi.u_q, tqi.u_scale, tqi.w_q, tqi.w_scale)
    np.testing.assert_array_equal(none.numpy(), got)


def test_resolve_method_validation_and_per_device_default():
    assert resolve_method("fused", "cpu") == "fused"
    assert resolve_method("dequant", "cuda") == "dequant"
    with pytest.raises(ValueError, match="unknown dequant-score method"):
        resolve_method("int4", "cpu")
    assert resolve_method(None, "cpu") == "dequant"
    assert resolve_method(None, torch.device("cuda", 0)) == "fused"
    assert resolve_method(None, "meta") == "dequant"
    assert FALLBACK_METHOD == {"cpu": "dequant", "cuda": "fused"}


@pytest.mark.parametrize("quant", [False, True])
def test_score_pairs_matches_jax(quant):
    jf, jqi, tf, tqi = _indexes(50, 200, 16, seed=4)
    rng = np.random.default_rng(0)
    uids = rng.integers(0, 50, 300)
    iids = rng.integers(0, 200, 300)
    j_idx, t_idx = (jqi, tqi) if quant else (jf, tf)
    want = np.asarray(jrec.score_pairs(j_idx, jnp.asarray(uids),
                                       jnp.asarray(iids)))
    got = trec.score_pairs(t_idx, uids, iids)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


# --------------------------------------------------------------------------
# top-k
# --------------------------------------------------------------------------


@pytest.mark.parametrize("layout,method", [("f32", None), ("int8", "fused"),
                                           ("int8", "dequant")])
@pytest.mark.parametrize("exclude", [True, False])
def test_recommend_topk_matches_jax(layout, method, exclude):
    jf, jqi, tf, tqi = _indexes(120, 400, 12, seed=5, seen_per_user=6)
    j_idx, t_idx = (jf, tf) if layout == "f32" else (jqi, tqi)
    users = np.arange(0, 120, 2).astype(np.int32)
    k = 20
    ji, js = jrec.recommend_topk(j_idx, jnp.asarray(users), k=k + 1,
                                 exclude_seen=exclude, method=method)
    ti, ts = trec.recommend_topk(t_idx, users, k=k, exclude_seen=exclude,
                                 method=method)
    ji, js = np.asarray(ji), np.asarray(js)
    assert ti.shape == ts.shape == (len(users), k)
    if method == "fused":
        np.testing.assert_array_equal(ts.numpy(), js[:, :k])
        tie_free = _tie_free(js, 0.0)
    else:
        np.testing.assert_allclose(ts.numpy(), js[:, :k], rtol=1e-5,
                                   atol=1e-5 * np.abs(js).max())
        tie_free = _tie_free(js, 1e-4)
    assert tie_free.sum() > len(users) // 2
    np.testing.assert_array_equal(ti.numpy()[tie_free], ji[tie_free, :k])
    if exclude:
        seen = t_idx.seen.numpy()
        for row, u in zip(ti.numpy(), users):
            assert not set(row.tolist()) & set(seen[u].tolist())


def test_recommend_topk_k_guard():
    _, _, _, tqi = _indexes(10, 30, 4, seed=6)
    with pytest.raises(ValueError, match="exceeds catalog size"):
        trec.recommend_topk(tqi, np.arange(4), k=31)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overlap_at_100_int8_vs_f32(seed):
    # the JAX package's gate on its randomized grids: m=300, n=2000, r=32
    _, _, tf, _ = _indexes(300, 2000, 32, seed=seed)
    q = tq.quantize_index(tf)
    uids = np.random.default_rng(seed + 10).integers(0, 300, 256)
    i_f, _ = trec.recommend_topk(tf, uids, k=K)
    for method in ("fused", "dequant"):
        i_q, _ = trec.recommend_topk(q, uids, k=K, method=method)
        overlap = np.mean([len(set(a) & set(b)) / K for a, b in
                           zip(i_f.numpy().tolist(), i_q.numpy().tolist())])
        assert overlap >= 0.99, (method, overlap)
