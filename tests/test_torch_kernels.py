"""The port's kernel modules against the JAX package's kernels, on the CPU.

Each of the three f-gradient functions of ``repro_torch.kernels`` gets the
same numpy inputs as its JAX twin.  On CPU tensors the port's wrapper runs
its plain PyTorch version; the JAX side runs its Pallas kernel in
interpret mode (``force_kernel=True``, as the JAX package's own tests do)
and its XLA reference.  Cases: a block with no entries, empty rows and
columns, padding slots, a store with no padding, and a batched stack
against per-block calls.

Tolerance: rtol=1e-5, atol=1e-5·max|ref| — float32 sums run in another
order on each side; at these sizes losses are in the hundreds and
gradients in the tens.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import sparse as jsparse  # noqa: E402
from repro.kernels.masked_factor_grad import ops as j_mfg  # noqa: E402
from repro.kernels.masked_factor_grad.ref import (  # noqa: E402
    masked_factor_grad_ref as j_mfg_ref,
)
from repro.kernels.sddmm import ops as j_sddmm  # noqa: E402
from repro.kernels.sddmm.ref import sddmm_factor_grad_ref as j_scatter_ref  # noqa: E402
from repro.kernels.sddmm.segment import (  # noqa: E402
    sddmm_segment_grad_ref as j_segment_ref,
)
from repro_torch.convert import sparse_problem_from_numpy  # noqa: E402
from repro_torch.kernels.masked_factor_grad import ops as t_mfg  # noqa: E402
from repro_torch.kernels.sddmm import ops as t_sddmm  # noqa: E402
from repro_torch.kernels.sddmm.segment import segment_reduce  # noqa: E402

torch.set_num_threads(2)

P, Q, MB, NB, R = 2, 2, 24, 30, 5
KINDS = ["random", "empty_block", "empty_lines", "no_padding"]


def _blocks(kind, seed=0, r=R):
    rng = np.random.default_rng(seed)
    density = 1.0 if kind == "no_padding" else 0.3
    mask = (rng.random((P, Q, MB, NB)) < density).astype(np.float32)
    if kind == "empty_block":
        mask[0, 1] = 0.0
    if kind == "empty_lines":
        mask[..., [1, 5, 23], :] = 0.0      # empty rows, the last one too
        mask[..., :, [0, 7, 29]] = 0.0      # empty columns, both ends
    x = (rng.normal(size=mask.shape) * 3.0 * mask).astype(np.float32)
    u = rng.normal(size=(P, Q, MB, r)).astype(np.float32)
    w = rng.normal(size=(P, Q, NB, r)).astype(np.float32)
    return x, mask, u, w


def _stores(x, mask, kind):
    """The JAX store and the same arrays as a port store (via convert)."""

    bucket = MB * NB if kind == "no_padding" else 64
    jsp = jsparse.from_blocks(x, mask, bucket=bucket)
    if kind == "no_padding":
        assert int(np.asarray(jsp.nnz).min()) == jsp.capacity
    else:
        assert int(np.asarray(jsp.nnz).max()) < jsp.capacity   # padding
    e = jsp.entries
    tsp = sparse_problem_from_numpy(
        *(np.asarray(f) for f in (e.rows, e.cols, e.vals, e.valid,
                                  e.col_perm, e.row_ptr, e.col_ptr)),
        np.asarray(jsp.nnz), device="cpu")
    return jsp, tsp


def _close(got, want):
    """Port output (torch) vs a JAX output, at the stated tolerance."""

    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-5,
                               atol=1e-5 * scale)


SPARSE = {
    "segment": (t_sddmm.sddmm_segment_grad,
                lambda e, u, w: j_sddmm.sddmm_segment_grad(
                    e, u, w, force_kernel=True),
                j_segment_ref),
    "scatter": (t_sddmm.sddmm_factor_grad,
                lambda e, u, w: j_sddmm.sddmm_factor_grad(
                    e, u, w, force_kernel=True),
                j_scatter_ref),
}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("method", sorted(SPARSE))
def test_sparse_kernel_module_matches_jax(method, kind):
    x, mask, u, w = _blocks(kind)
    jsp, tsp = _stores(x, mask, kind)
    port, pallas, xla = SPARSE[method]
    n0 = port.launches
    got = port(tsp.entries, torch.from_numpy(u), torch.from_numpy(w))
    assert port.launches == n0                 # CPU tensors: plain version
    for i in range(P):
        for j in range(Q):
            ent = jsp.entries.gather(i, j)
            for ref in (pallas, xla):
                want = ref(ent, u[i, j], w[i, j])
                for g, wv in zip(got, want):
                    _close(g[i, j], wv)
    if kind == "empty_block":
        assert float(got[0][0, 1]) == 0.0
        assert float(got[1][0, 1].abs().max()) == 0.0
        assert float(got[2][0, 1].abs().max()) == 0.0
    if kind == "empty_lines":
        assert float(got[1][..., [1, 5, 23], :].abs().max()) == 0.0
        assert float(got[2][..., [0, 7, 29], :].abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["random", "empty_block", "empty_lines"])
def test_masked_kernel_module_matches_jax(kind):
    x, mask, u, w = _blocks(kind)
    got = t_mfg.masked_factor_grad(*(torch.from_numpy(a)
                                     for a in (x, mask, u, w)))
    for i in range(P):
        for j in range(Q):
            args = (x[i, j], mask[i, j], u[i, j], w[i, j])
            for want in (j_mfg.masked_factor_grad(*args, force_kernel=True),
                         j_mfg_ref(*args)):
                for g, wv in zip(got, want):
                    _close(g[i, j], wv)
    if kind == "empty_block":
        assert float(got[0][0, 1]) == 0.0


@pytest.mark.parametrize("name", ["segment", "scatter", "masked"])
def test_batched_stack_equals_per_block_calls(name):
    x, mask, u, w = _blocks("random", seed=3)
    _, tsp = _stores(x, mask, "random")
    X, Mk, U, W = (torch.from_numpy(a) for a in (x, mask, u, w))

    def call(idx):
        if name == "masked":
            return t_mfg.masked_factor_grad(X[idx], Mk[idx], U[idx], W[idx])
        fn = SPARSE[name][0]
        return fn(tsp.entries.gather(*idx), U[idx], W[idx])

    stacked = call((slice(None), slice(None)))
    for i in range(P):
        for j in range(Q):
            for g, s in zip(call((i, j)), stacked):
                torch.testing.assert_close(g, s[i, j], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("chunk", [4, 32])
def test_segment_reduce_matches_numpy(chunk):
    rng = np.random.default_rng(chunk)
    E, S = 64, 9                       # E on a chunk edge: boundary at E
    contrib = rng.normal(size=(2, E, 3)).astype(np.float32)
    ptr = np.stack([np.concatenate([[0], np.sort(rng.integers(0, E + 1, S - 1)),
                                    [E]]) for _ in range(2)]).astype(np.int32)
    got = segment_reduce(torch.from_numpy(contrib), torch.from_numpy(ptr),
                         chunk=chunk)
    want = np.stack([[contrib[b, ptr[b, s]:ptr[b, s + 1]].sum(0)
                      for s in range(S)] for b in range(2)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
