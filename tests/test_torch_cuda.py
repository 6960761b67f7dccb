"""On-card tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same CUDA inputs, and a short fit on the card
against the same fit on the CPU.  They carry the ``cuda`` marker and skip
without a card (a CUDA kernel has no CPU mode); run them on a machine
with an H100 with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  This file imports no JAX, so it runs where
only PyTorch is installed."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import GossipMCConfig  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.data import lowrank_problem  # noqa: E402
from repro_torch.kernels.masked_factor_grad import ops as mfg_ops  # noqa: E402
from repro_torch.kernels.masked_factor_grad.ref import (  # noqa: E402
    masked_factor_grad_ref,
)
from repro_torch.kernels.sddmm import ops as sddmm_ops  # noqa: E402
from repro_torch.kernels.sddmm.ref import sddmm_factor_grad_ref  # noqa: E402
from repro_torch.kernels.sddmm.segment import (  # noqa: E402
    sddmm_segment_grad_ref,
)
from repro_torch.mc import CompletionProblem, FullGD, Trainer  # noqa: E402
from repro_torch.sparse.store import from_blocks  # noqa: E402

pytestmark = pytest.mark.cuda

# (p, q, mb, nb, r, density): small and odd stacks, ranks across the
# kernels' register templates (r <= 8, <= 16, <= 32, above 32), the
# largest rank
CASES = [(2, 3, 17, 23, 3, 0.3), (3, 2, 40, 16, 5, 0.3),
         (2, 2, 150, 70, 15, 0.3), (1, 2, 45, 100, 32, 0.4),
         (1, 1, 64, 64, 40, 0.5), (2, 2, 33, 70, 256, 0.2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _blocks(p, q, mb, nb, r, density, seed):
    """Random blocks with an empty block, an empty row and an empty column."""

    rng = np.random.default_rng(seed)
    mask = (rng.random((p, q, mb, nb)) < density).astype(np.float32)
    mask[0, 0] = 0.0
    mask[..., 1, :] = 0.0
    mask[..., :, 2] = 0.0
    x = (rng.normal(size=(p, q, mb, nb)) * mask).astype(np.float32)
    u = rng.normal(size=(p, q, mb, r)).astype(np.float32)
    w = rng.normal(size=(p, q, nb, r)).astype(np.float32)
    return x, mask, u, w


def _close(got, want):
    for g, ref in zip(got, want):
        ref = ref.double()
        scale = float(ref.abs().max()) if ref.numel() else 0.0
        torch.testing.assert_close(g.double(), ref, rtol=1e-5,
                                   atol=1e-5 * scale + 1e-30)


@pytest.mark.parametrize("case", CASES)
def test_segment_kernel_matches_plain(cuda, case):
    x, mask, u, w = _blocks(*case, seed=1)
    sp = from_blocks(x, mask, bucket=64, device=cuda)
    U, W = torch.from_numpy(u).to(cuda), torch.from_numpy(w).to(cuda)
    n0 = sddmm_ops.sddmm_segment_grad.launches
    got = sddmm_ops.sddmm_segment_grad(sp.entries, U, W)
    assert sddmm_ops.sddmm_segment_grad.launches == n0 + 1
    torch.cuda.synchronize()
    _close(got, sddmm_segment_grad_ref(sp.entries, U, W))
    assert float(got[0][0, 0]) == 0.0                 # the empty block
    assert float(got[1][0, 0].abs().max()) == 0.0


@pytest.mark.parametrize("case", CASES)
def test_scatter_kernel_matches_plain(cuda, case):
    x, mask, u, w = _blocks(*case, seed=2)
    sp = from_blocks(x, mask, bucket=64, device=cuda)
    U, W = torch.from_numpy(u).to(cuda), torch.from_numpy(w).to(cuda)
    got = sddmm_ops.sddmm_factor_grad(sp.entries, U, W)
    torch.cuda.synchronize()
    _close(got, sddmm_factor_grad_ref(sp.entries, U, W))


@pytest.mark.parametrize("case", CASES)
def test_masked_kernel_matches_plain(cuda, case):
    x, mask, u, w = _blocks(*case, seed=3)
    X, Mk, U, W = (torch.from_numpy(a).to(cuda) for a in (x, mask, u, w))
    got = mfg_ops.masked_factor_grad(X, Mk, U, W)
    torch.cuda.synchronize()
    _close(got, masked_factor_grad_ref(X, Mk, U, W))


def test_batched_launch_equals_per_block_launches(cuda):
    x, mask, u, w = _blocks(2, 3, 17, 23, 5, 0.3, seed=4)
    sp = from_blocks(x, mask, bucket=64, device=cuda)
    X, Mk, U, W = (torch.from_numpy(a).to(cuda) for a in (x, mask, u, w))
    stacked = {
        "segment": sddmm_ops.sddmm_segment_grad(sp.entries, U, W),
        "scatter": sddmm_ops.sddmm_factor_grad(sp.entries, U, W),
        "masked": mfg_ops.masked_factor_grad(X, Mk, U, W),
    }
    for i in range(2):
        for j in range(3):
            one = {
                "segment": sddmm_ops.sddmm_segment_grad(
                    sp.entries.gather(i, j), U[i, j], W[i, j]),
                "scatter": sddmm_ops.sddmm_factor_grad(
                    sp.entries.gather(i, j), U[i, j], W[i, j]),
                "masked": mfg_ops.masked_factor_grad(
                    X[i, j], Mk[i, j], U[i, j], W[i, j]),
            }
            for name, got in one.items():
                _close(got, [t[i, j] for t in stacked[name]])


def test_kernel_rejects_unsupported_rank(cuda):
    x, mask, u, w = _blocks(1, 1, 8, 8, 257, 0.5, seed=5)
    X, Mk, U, W = (torch.from_numpy(a).to(cuda) for a in (x, mask, u, w))
    with pytest.raises(ValueError, match="rank"):
        mfg_ops.masked_factor_grad(X, Mk, U, W)


@pytest.mark.parametrize("layout,method", [("dense", "segment"),
                                           ("sparse", "segment"),
                                           ("sparse", "scatter")])
def test_fit_on_card_matches_cpu(cuda, layout, method):
    ds = lowrank_problem(60, 48, 3, density=0.3, seed=0)
    cfg = GossipMCConfig(m=60, n=48, p=3, q=2, rank=3, rho=10.0, lam=1e-6,
                         a=2e-3, b=1e-6)
    rng = np.random.default_rng(0)
    u0 = (rng.normal(size=(3, 2, 20, 3)) / np.sqrt(3)).astype(np.float32)
    w0 = (rng.normal(size=(3, 2, 24, 3)) / np.sqrt(3)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        pr = CompletionProblem.from_dataset(ds, 3, 2, 3, layout=layout,
                                            device=dev).with_engine(
                                                method=method)
        res = Trainer(cfg).fit(pr, FullGD(num_rounds=20, eval_every=5),
                               state=state_from_numpy(u0, w0, 0, dev))
        out[str(dev)] = res
    cpu, card = out["cpu"], out[str(cuda)]
    assert card.t == cpu.t
    np.testing.assert_allclose([c for _, c in card.history],
                               [c for _, c in cpu.history], rtol=1e-4)
    for a, b in ((card.state.U, cpu.state.U), (card.state.W, cpu.state.W)):
        ref = b.double()
        torch.testing.assert_close(a.cpu().double(), ref, rtol=1e-4,
                                   atol=1e-5 * float(ref.abs().max()))
