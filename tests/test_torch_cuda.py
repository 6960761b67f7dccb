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
from repro_torch.convert import index_from_numpy, state_from_numpy  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.data import lowrank_problem  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.launch.lm_engine import ServeLoop  # noqa: E402
from repro_torch.kernels.masked_factor_grad import ops as mfg_ops  # noqa: E402
from repro_torch.kernels.masked_factor_grad.ref import (  # noqa: E402
    masked_factor_grad_ref,
)
from repro_torch.kernels.quant import ops as quant_ops  # noqa: E402
from repro_torch.kernels.quant.ref import fused_score_ref  # noqa: E402
from repro_torch.kernels.sddmm import ops as sddmm_ops  # noqa: E402
from repro_torch.kernels.sddmm.ref import sddmm_factor_grad_ref  # noqa: E402
from repro_torch.kernels.sddmm.segment import (  # noqa: E402
    sddmm_segment_grad_ref,
)
from repro_torch.mc import CompletionProblem, FullGD, Trainer  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.serve.quant import quantize_index, quantize_rows  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.sparse.entries import BlockEntries  # noqa: E402
from repro_torch.sparse.store import (  # noqa: E402
    MinibatchStream,
    append_entries,
    from_blocks,
    from_entries,
)

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


# (p, q, mb, nb, r): in every block one column holds all but 7 rows and one
# row all but 2 columns, segments far longer than a chunk of lanes or a
# group's share of its CTA's entries; ranks across the segment walk's
# templates (8 and 2 lanes a group, two components a lane; a warp a row)
SKEWED = [(2, 2, 700, 300, 15), (2, 1, 260, 530, 3), (1, 2, 400, 200, 40)]


def _skewed(p, q, mb, nb, r, seed):
    rng = np.random.default_rng(seed)
    mask = (rng.random((p, q, mb, nb)) < 0.05).astype(np.float32)
    mask[..., : mb - 7, 3] = 1.0        # a hot item
    mask[..., 5, 2:] = 1.0              # a heavy user
    mask[..., 1, :] = 0.0               # an empty row
    mask[..., :, 0] = 0.0               # an empty column
    x = (rng.normal(size=(p, q, mb, nb)) * mask).astype(np.float32)
    u = rng.normal(size=(p, q, mb, r)).astype(np.float32)
    w = rng.normal(size=(p, q, nb, r)).astype(np.float32)
    return x, mask, u, w


@pytest.mark.parametrize("case", SKEWED)
def test_segment_kernel_on_skewed_store(cuda, case):
    x, mask, u, w = _skewed(*case, seed=6)
    sp = from_blocks(x, mask, bucket=64, device=cuda)
    hot = sp.entries.col_ptr[..., 4] - sp.entries.col_ptr[..., 3]
    assert int(hot.min()) >= case[2] - 8        # all but 7 rows, less row 1
    U, W = torch.from_numpy(u).to(cuda), torch.from_numpy(w).to(cuda)
    got = sddmm_ops.sddmm_segment_grad(sp.entries, U, W)
    torch.cuda.synchronize()
    _close(got, sddmm_segment_grad_ref(sp.entries, U, W))
    assert float(got[1][..., 1, :].abs().max()) == 0.0      # the empty row
    assert float(got[2][..., 0, :].abs().max()) == 0.0      # the empty column


def test_segment_kernel_on_a_structure_trio(cuda):
    """A Sequential structure's three blocks, gathered as
    ``sgd_structure_step`` gathers them, against the plain version and
    against the same blocks of the whole-stack call."""

    x, mask, u, w = _skewed(2, 2, 700, 300, 15, seed=7)
    sp = from_blocks(x, mask, bucket=64, device=cuda)
    U, W = torch.from_numpy(u).to(cuda), torch.from_numpy(w).to(cuda)
    bi = torch.tensor([0, 1, 0], device=cuda)
    bj = torch.tensor([0, 0, 1], device=cuda)
    trio = sp.entries.gather(bi, bj)
    n0 = dict(sddmm_ops.sddmm_segment_grad.by_stack)
    got = sddmm_ops.sddmm_segment_grad(trio, U[bi, bj], W[bi, bj])
    assert sddmm_ops.sddmm_segment_grad.by_stack[(3,)] == n0.get((3,), 0) + 1
    torch.cuda.synchronize()
    assert got[1].shape == (3, 700, 15) and got[2].shape == (3, 300, 15)
    _close(got, sddmm_segment_grad_ref(trio, U[bi, bj], W[bi, bj]))
    whole = sddmm_ops.sddmm_segment_grad(sp.entries, U, W)
    _close(got, [t[bi, bj] for t in whole])


@pytest.mark.parametrize("case", [SKEWED[0], CASES[2]])
def test_segment_kernel_is_deterministic(cuda, case):
    make = _skewed if case in SKEWED else _blocks
    x, mask, u, w = make(*case, seed=8)
    sp = from_blocks(x, mask, bucket=64, device=cuda)
    U, W = torch.from_numpy(u).to(cuda), torch.from_numpy(w).to(cuda)
    first = sddmm_ops.sddmm_segment_grad(sp.entries, U, W)
    for _ in range(3):
        again = sddmm_ops.sddmm_segment_grad(sp.entries, U, W)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def _split_store(x, mask, cuda, frac=0.7, seed=0, headroom=0):
    """(base store on the card with ``headroom``, the global COO triplets,
    the streamed indices): ``frac`` of the entries in the base."""

    p, q, mb, nb = mask.shape
    bi, bj, rr, cc = np.nonzero(mask)
    rows, cols, vals = bi * mb + rr, bj * nb + cc, x[bi, bj, rr, cc]
    perm = np.random.default_rng(seed).permutation(len(rows))
    cut = int(frac * len(rows))
    base = perm[:cut]
    sp, _ = from_entries(rows[base], cols[base], vals[base], p * mb, q * nb,
                         p, q, bucket=64, headroom=headroom, device=cuda)
    return sp, (rows, cols, vals), perm[cut:]


@pytest.mark.parametrize("case", [SKEWED[0], CASES[2], CASES[5]])
def test_segment_kernel_on_appended_store(cuda, case):
    """A store grown by ``append_entries`` (CSR offsets and ``col_perm``
    patched by the splice, not built by a sort): the kernel against its
    plain version, and bitwise against the kernel on a fresh ingest of
    the union at the same capacity, whose arrays are the same."""

    make = _skewed if case in SKEWED else _blocks
    x, mask, u, w = make(*case, seed=9)
    p, q, mb, nb = mask.shape
    sp, (rows, cols, vals), stream = _split_store(x, mask, cuda,
                                                  headroom=int(mask.sum()))
    grown = append_entries(sp, rows[stream], cols[stream], vals[stream])
    assert grown.device == sp.device and grown.capacity == sp.capacity
    E = grown.capacity
    fresh, _ = from_entries(rows, cols, vals, p * mb, q * nb, p, q,
                            bucket=64, headroom=E - int(grown.nnz.max()),
                            device=cuda)
    for a, b in zip((*grown.entries, grown.nnz), (*fresh.entries, fresh.nnz)):
        assert torch.equal(a, b)
    U, W = torch.from_numpy(u).to(cuda), torch.from_numpy(w).to(cuda)
    got = sddmm_ops.sddmm_segment_grad(grown.entries, U, W)
    torch.cuda.synchronize()
    _close(got, sddmm_segment_grad_ref(grown.entries, U, W))
    again = sddmm_ops.sddmm_segment_grad(fresh.entries, U, W)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_segment_kernel_on_minibatch_store(cuda):
    """A sampled store: duplicate (row, col) pairs from sampling with
    replacement, rows with no entry and an empty block."""

    x, mask, u, w = _blocks(2, 2, 150, 70, 15, 0.05, seed=10)
    sp = from_blocks(x, mask, bucket=64, device=cuda)
    mbat = MinibatchStream(sp, batch=4096, seed=2).batch_at(0)
    rows, cols = mbat.entries.rows[1, 1], mbat.entries.cols[1, 1]
    keys = rows.long() * 70 + cols.long()
    assert len(keys.unique()) < len(keys)             # duplicates
    assert int(mbat.nnz[0, 0]) == 0                   # the empty block
    U, W = torch.from_numpy(u).to(cuda), torch.from_numpy(w).to(cuda)
    got = sddmm_ops.sddmm_segment_grad(mbat.entries, U, W)
    torch.cuda.synchronize()
    _close(got, sddmm_segment_grad_ref(mbat.entries, U, W))
    assert float(got[0][0, 0]) == 0.0
    assert float(got[1][0, 0].abs().max()) == 0.0


def test_minibatch_stream_on_card_equals_cpu(cuda):
    """The positions come from a CPU generator whatever the store's
    device (torch's CUDA and CPU generators draw different streams), so
    the card's minibatches equal the CPU's bit for bit."""

    x, mask, _, _ = _blocks(2, 3, 40, 30, 5, 0.3, seed=11)
    on_card = MinibatchStream(from_blocks(x, mask, bucket=64, device=cuda),
                              batch=300, seed=4)
    on_cpu = MinibatchStream(from_blocks(x, mask, bucket=64, device="cpu"),
                             batch=300, seed=4)
    for step in (0, 1, 50):
        a, b = on_card.batch_at(step), on_cpu.batch_at(step)
        assert a.nnz.device.type == "cuda"
        for fa, fb in zip((*a.entries, a.nnz), (*b.entries, b.nnz)):
            assert torch.equal(fa.cpu(), fb)


@pytest.mark.parametrize("case", CASES)
def test_scatter_kernel_matches_plain(cuda, case):
    x, mask, u, w = _blocks(*case, seed=2)
    sp = from_blocks(x, mask, bucket=64, device=cuda)
    U, W = torch.from_numpy(u).to(cuda), torch.from_numpy(w).to(cuda)
    got = sddmm_ops.sddmm_factor_grad(sp.entries, U, W)
    torch.cuda.synchronize()
    _close(got, sddmm_factor_grad_ref(sp.entries, U, W))


def _permuted(entries, seed):
    """The same entries in a seeded random order within each block, padding
    slots interleaved, without the sorted aux (the scatter kernel's "any
    order")."""

    lead, E = entries.rows.shape[:-1], entries.capacity
    rng = np.random.default_rng(seed)
    perm = np.stack([rng.permutation(E) for _ in range(int(np.prod(lead)))])
    idx = torch.from_numpy(perm.reshape(*lead, E)).to(entries.rows.device)
    fields = (entries.rows, entries.cols, entries.vals, entries.valid)
    return BlockEntries(*(torch.take_along_dim(f, idx, -1) for f in fields))


@pytest.mark.parametrize("case", CASES)
def test_scatter_kernel_on_permuted_store(cuda, case):
    x, mask, u, w = _blocks(*case, seed=12)
    sp = from_blocks(x, mask, bucket=64, device=cuda)
    ent = _permuted(sp.entries, seed=12)
    live = (ent.valid != 0).int()
    live_after = live.flip(-1).cummax(-1).values.flip(-1)
    if live.any():                     # padding slots among live entries
        assert bool(((live_after == 1) & (live == 0)).any())
    U, W = torch.from_numpy(u).to(cuda), torch.from_numpy(w).to(cuda)
    got = sddmm_ops.sddmm_factor_grad(ent, U, W)
    torch.cuda.synchronize()
    _close(got, sddmm_factor_grad_ref(ent, U, W))
    _close(got, sddmm_factor_grad_ref(sp.entries, U, W))
    assert float(got[0][0, 0]) == 0.0                 # the empty block
    assert float(got[1][0, 0].abs().max()) == 0.0


# the hot column's adds all go to one owner CTA of each cluster
@pytest.mark.parametrize("order", ["sorted", "permuted"])
@pytest.mark.parametrize("case", SKEWED)
def test_scatter_kernel_on_skewed_store(cuda, case, order):
    x, mask, u, w = _skewed(*case, seed=6)
    sp = from_blocks(x, mask, bucket=64, device=cuda)
    ent = sp.entries if order == "sorted" else _permuted(sp.entries, seed=6)
    U, W = torch.from_numpy(u).to(cuda), torch.from_numpy(w).to(cuda)
    got = sddmm_ops.sddmm_factor_grad(ent, U, W)
    torch.cuda.synchronize()
    _close(got, sddmm_factor_grad_ref(ent, U, W))
    assert float(got[1][..., 1, :].abs().max()) == 0.0      # the empty row
    assert float(got[2][..., 0, :].abs().max()) == 0.0      # the empty column


# (M, N, r) at B = 1 on each side of a CTA's copy budget, 220 KiB for a
# block's gU and gW: (120 + 100) * 256 * 4 bytes fit exactly, (121 + 100) *
# 256 * 4 do not, and the first design runs; only the first design writes
# the loss partials, so the C entry's partials tell which ran
@pytest.mark.parametrize("shape,K", [((120, 100, 256), 8),
                                     ((121, 100, 256), 0)])
def test_scatter_kernel_dispatch_by_shape(cuda, shape, K):
    M, N, r = shape
    lib = _build.load("sddmm")
    assert lib.sddmm_cluster_size(1, M, N, r) == K
    rng = np.random.default_rng(13)
    mask = (rng.random((1, 1, M, N)) < 0.3).astype(np.float32)
    x = (rng.normal(size=mask.shape) * mask).astype(np.float32)
    ent = _permuted(from_blocks(x, mask, bucket=64, device=cuda).entries,
                    seed=13)
    U = torch.from_numpy(rng.normal(size=(1, 1, M, r)).astype(np.float32))
    W = torch.from_numpy(rng.normal(size=(1, 1, N, r)).astype(np.float32))
    U, W = U.to(cuda), W.to(cuda)
    want = sddmm_factor_grad_ref(ent, U, W)
    _close(sddmm_ops.sddmm_factor_grad(ent, U, W), want)
    E = ent.capacity
    loss = torch.full((1, 1), float("nan"), device=cuda)
    gu, gw = torch.full_like(U, float("nan")), torch.full_like(W, float("nan"))
    partials = torch.full((1, lib.sddmm_num_partials(1, E, r)), float("nan"),
                          device=cuda)
    rc = lib.sddmm_factor_grad(
        *(t.data_ptr() for t in (ent.rows, ent.cols, ent.vals, ent.valid,
                                 U, W, loss, gu, gw, partials)),
        1, E, M, N, r, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    assert bool(partials.isnan().all()) == (K > 0)
    _close((loss, gu, gw), want)


# one block (a lone cluster) and a Sequential structure's three blocks,
# permuted, against the plain version and the whole stack's call
@pytest.mark.parametrize("B", [1, 3])
def test_scatter_kernel_on_small_stacks(cuda, B):
    x, mask, u, w = _skewed(2, 2, 700, 300, 15, seed=14)
    sp = from_blocks(x, mask, bucket=64, device=cuda)
    ent = _permuted(sp.entries, seed=14)
    U, W = torch.from_numpy(u).to(cuda), torch.from_numpy(w).to(cuda)
    if B == 1:
        idx = (1, 1)
    else:
        idx = (torch.tensor([0, 1, 0], device=cuda),
               torch.tensor([0, 0, 1], device=cuda))
    assert _build.load("sddmm").sddmm_cluster_size(B, 700, 300, 15) == 8
    n0 = sddmm_ops.sddmm_factor_grad.launches
    got = sddmm_ops.sddmm_factor_grad(ent.gather(*idx), U[idx], W[idx])
    assert sddmm_ops.sddmm_factor_grad.launches == n0 + 1
    torch.cuda.synchronize()
    assert got[1].shape == U[idx].shape and got[2].shape == W[idx].shape
    _close(got, sddmm_factor_grad_ref(ent.gather(*idx), U[idx], W[idx]))
    whole = sddmm_ops.sddmm_factor_grad(ent, U, W)
    _close(got, [t[idx] for t in whole])


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[5]])
def test_scatter_first_entry_matches_plain(cuda, case):
    """The first scatter design through its own C entry, at any shape."""

    lib = _build.load("sddmm")
    p, q, mb, nb, r, _ = case
    x, mask, u, w = _blocks(*case, seed=15)
    ent = _permuted(from_blocks(x, mask, bucket=64, device=cuda).entries,
                    seed=15)
    U, W = torch.from_numpy(u).to(cuda), torch.from_numpy(w).to(cuda)
    B, E = p * q, ent.capacity
    loss = torch.full((p, q), float("nan"), device=cuda)
    gu, gw = torch.full_like(U, float("nan")), torch.full_like(W, float("nan"))
    partials = torch.empty((B, lib.sddmm_num_partials(B, E, r)), device=cuda)
    rc = lib.sddmm_factor_grad_first(
        *(t.data_ptr() for t in (ent.rows, ent.cols, ent.vals, ent.valid,
                                 U, W, loss, gu, gw, partials)),
        B, E, mb, nb, r, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    _close((loss, gu, gw), sddmm_factor_grad_ref(ent, U, W))


@pytest.mark.parametrize("case", [SKEWED[0], CASES[2], CASES[4]])
def test_scatter_kernel_repeats(cuda, case):
    """Repeated calls: the loss bit for bit (a fixed-order sum), the
    gradients within the tolerance (shared-memory adds in arrival
    order)."""

    make = _skewed if case in SKEWED else _blocks
    x, mask, u, w = make(*case, seed=16)
    ent = _permuted(from_blocks(x, mask, bucket=64, device=cuda).entries,
                    seed=16)
    U, W = torch.from_numpy(u).to(cuda), torch.from_numpy(w).to(cuda)
    first = sddmm_ops.sddmm_factor_grad(ent, U, W)
    for _ in range(3):
        again = sddmm_ops.sddmm_factor_grad(ent, U, W)
        assert torch.equal(first[0], again[0])
        _close(again[1:], first[1:])


# (p, q, mb, nb, r, density): sides that are not multiples of 32, ranks at
# the edges of the register-blocked kernel's templates (RK = 4 ... 32) and
# the first rank of the shared-memory kernel
MASKED_EDGES = [(2, 1, 45, 70, 1, 0.3), (1, 2, 70, 45, 16, 0.3),
                (2, 1, 45, 70, 17, 0.3), (1, 2, 61, 37, 33, 0.3)]


@pytest.mark.parametrize("case", CASES + MASKED_EDGES)
def test_masked_kernel_matches_plain(cuda, case):
    x, mask, u, w = _blocks(*case, seed=3)
    X, Mk, U, W = (torch.from_numpy(a).to(cuda) for a in (x, mask, u, w))
    got = mfg_ops.masked_factor_grad(X, Mk, U, W)
    torch.cuda.synchronize()
    _close(got, masked_factor_grad_ref(X, Mk, U, W))


@pytest.mark.parametrize("case", [CASES[2], CASES[4]])
def test_masked_kernel_is_deterministic(cuda, case):
    """Bitwise-equal (loss, gU, gW) from repeated calls, for the
    register-blocked kernel (r <= 32) and the shared-memory one."""

    x, mask, u, w = _blocks(*case, seed=10)
    X, Mk, U, W = (torch.from_numpy(a).to(cuda) for a in (x, mask, u, w))
    first = mfg_ops.masked_factor_grad(X, Mk, U, W)
    for _ in range(3):
        again = mfg_ops.masked_factor_grad(X, Mk, U, W)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_masked_kernel_on_a_structure_trio(cuda):
    """A Sequential structure's three blocks, gathered as
    ``sgd_structure_step`` gathers them, against the plain version and
    against the same blocks of the whole-stack call."""

    x, mask, u, w = _blocks(2, 2, 150, 70, 15, 0.3, seed=11)
    X, Mk, U, W = (torch.from_numpy(a).to(cuda) for a in (x, mask, u, w))
    bi = torch.tensor([0, 1, 0], device=cuda)
    bj = torch.tensor([0, 0, 1], device=cuda)
    n0 = dict(mfg_ops.masked_factor_grad.by_stack)
    got = mfg_ops.masked_factor_grad(X[bi, bj], Mk[bi, bj], U[bi, bj],
                                     W[bi, bj])
    assert mfg_ops.masked_factor_grad.by_stack[(3,)] == n0.get((3,), 0) + 1
    torch.cuda.synchronize()
    assert got[1].shape == (3, 150, 15) and got[2].shape == (3, 70, 15)
    _close(got, masked_factor_grad_ref(X[bi, bj], Mk[bi, bj], U[bi, bj],
                                       W[bi, bj]))
    whole = mfg_ops.masked_factor_grad(X, Mk, U, W)
    _close(got, [t[bi, bj] for t in whole])


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


def _codes(B, n, r, seed, device):
    rng = np.random.default_rng(seed)
    u_q = rng.integers(-127, 128, size=(B, r)).astype(np.int8)
    w_q = rng.integers(-127, 128, size=(n, r)).astype(np.int8)
    u_s = rng.lognormal(-3.0, 1.0, size=B).astype(np.float32)
    w_s = rng.lognormal(-3.0, 1.0, size=n).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (u_q, u_s, w_q, w_s)]


# ragged batch and catalog (neither a multiple of the 32 x 128 tile), ranks
# below, at and across the 4-byte word and the 32-byte rank chunk
@pytest.mark.parametrize("r", [1, 4, 15, 33, 128, 300])
def test_dequant_score_kernel_equals_plain_bitwise(cuda, r):
    for B, n in ((1, 1), (45, 333), (16, 3706)):
        args = _codes(B, n, r, seed=r, device=cuda)
        n0 = quant_ops.dequant_score.launches
        got = quant_ops.dequant_score(*args, method="fused")
        assert quant_ops.dequant_score.launches == n0 + 1
        torch.cuda.synchronize()
        assert got.shape == (B, n) and got.dtype == torch.float32
        assert torch.equal(got, fused_score_ref(*args))
        assert torch.equal(got.cpu(), fused_score_ref(*(a.cpu() for a in args)))


def test_dequant_score_kernel_at_the_top_bucket(cuda):
    args = _codes(1024, 3706, 15, seed=0, device=cuda)
    got = quant_ops.dequant_score(*args)             # None -> fused on cuda
    torch.cuda.synchronize()
    assert torch.equal(got, fused_score_ref(*args))


# the staged kernel's edges (r <= 64): every serving bucket against the
# cell's catalog; rows starting at every misalignment (n = 1, 2, 3 mod 4);
# batches across the tile and the grid (1, 17, 1025); ranks across the
# 16-byte pieces and the rank split (15, 16, 17, 63, 64, 65); a catalog
# whose tiles outnumber the CTAs the card holds at once many times over
STAGED_CASES = ([(b, 3706, 15) for b in (16, 64, 256, 1024)]
                + [(45, n, 15) for n in (333, 334, 335)]
                + [(b, 1000, 15) for b in (1, 17, 1025)]
                + [(70, 333, r) for r in (15, 16, 17, 63, 64, 65)]
                + [(1024, 50_000, 15)])


@pytest.mark.parametrize("B,n,r", STAGED_CASES)
def test_dequant_score_staged_kernel_equals_plain_bitwise(cuda, B, n, r):
    args = _codes(B, n, r, seed=B + n + r, device=cuda)
    got = quant_ops.dequant_score(*args, method="fused")
    again = quant_ops.dequant_score(*args, method="fused")
    torch.cuda.synchronize()
    assert torch.equal(got, fused_score_ref(*args))
    assert torch.equal(again, got)


def _off_grid(t, elems):
    """A contiguous view equal to ``t`` whose data start ``elems``
    elements into a larger allocation (as ``big[1:]`` does)."""

    big = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    view = big[elems:].view(t.shape)
    view.copy_(t)
    return view


# contiguous views whose data start off the 16-byte grid: the codes' runs
# then have byte heads and tails, the scales' runs scalar ones
@pytest.mark.parametrize("r", [15, 16, 64])
def test_dequant_score_kernel_on_views_off_16_bytes(cuda, r):
    args = _codes(70, 333, r, seed=r, device=cuda)
    views = [_off_grid(a, e) for a, e in zip(args, (1, 1, 3, 2))]
    assert all(v.is_contiguous() for v in views)
    assert all(v.data_ptr() % 16 for v in views)
    got = quant_ops.dequant_score(*views, method="fused")
    torch.cuda.synchronize()
    assert torch.equal(got, fused_score_ref(*args))


# the staged kernel's tile shapes (BM, BN) and the kernel name each runs
STAGED_KERNELS = {(64, 128): "staged_score_kernel<8, 4, 4>",
                  (32, 128): "staged_score_kernel<4, 4, 4>",
                  (32, 64): "staged_score_kernel<4, 2, 2>"}


def _picked_tile(B, n, sms):
    """The shape the C entry picks: the largest that gives every SM a
    tile, else the smallest."""

    for bm, bn in STAGED_KERNELS:
        if -(-B // bm) * -(-n // bn) >= sms:
            return bm, bn
    return 32, 64


# every tile shape through the wrapper, at a (B, n) that picks it on a card
# of 132 SMs (the serving buckets 1024, 256 and 64 against the cell's
# catalog); the wrapper's launch record names the kernel that ran (the C
# entry reports it), where the profiler's kernel names came back empty
# after earlier tests of this file
@pytest.mark.parametrize("B,n,r", [(1024, 3706, 15), (256, 3706, 15),
                                   (64, 3706, 15), (20, 3000, 64)])
def test_dequant_score_picks_the_tile_shape(cuda, B, n, r):
    args = _codes(B, n, r, seed=B + r, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    quant_ops.dequant_score.by_kernel.clear()
    got = quant_ops.dequant_score(*args, method="fused")
    torch.cuda.synchronize()
    want = _picked_tile(B, n, sms)
    assert want in STAGED_KERNELS
    assert quant_ops.dequant_score.by_kernel == {want: 1}
    assert torch.equal(got, fused_score_ref(*args))


# the first kernel through its own entry, at staged and larger ranks
@pytest.mark.parametrize("B,n,r", [(1, 1, 1), (17, 335, 15), (64, 3706, 15),
                                   (100, 1000, 64), (33, 500, 65)])
def test_dequant_score_first_entry_equals_plain_bitwise(cuda, B, n, r):
    lib = _build.load("dequant_score")
    u_q, u_s, w_q, w_s = _codes(B, n, r, seed=7, device=cuda)
    out = torch.full((B, n), float("nan"), device=cuda)
    rc = lib.dequant_score_first(
        u_q.data_ptr(), u_s.data_ptr(), w_q.data_ptr(), w_s.data_ptr(),
        out.data_ptr(), B, n, r, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    assert torch.equal(out, fused_score_ref(u_q, u_s, w_q, w_s))


def test_dequant_score_counts_launches_by_batch(cuda):
    by_batch = quant_ops.dequant_score.by_batch
    before = dict(by_batch)
    n0 = quant_ops.dequant_score.launches
    for B in (16, 64, 16):
        quant_ops.dequant_score(*_codes(B, 100, 15, seed=B, device=cuda))
    assert quant_ops.dequant_score.launches == n0 + 3
    assert by_batch[16] == before.get(16, 0) + 2
    assert by_batch[64] == before.get(64, 0) + 1


def test_dequant_score_kernel_rejects_bad_inputs(cuda):
    u_q, u_s, w_q, w_s = _codes(8, 40, 6, seed=1, device=cuda)
    n0 = quant_ops.dequant_score.launches
    with pytest.raises(ValueError, match="u_q"):
        quant_ops.dequant_score(u_q.float(), u_s, w_q, w_s, method="fused")
    with pytest.raises(ValueError, match="w_scale"):
        quant_ops.dequant_score(u_q, u_s, w_q, w_s.double(), method="fused")
    with pytest.raises(ValueError, match="one device"):
        quant_ops.dequant_score(u_q.cpu(), u_s, w_q, w_s, method="fused")
    wide = torch.zeros((40, 12), dtype=torch.int8, device=cuda)
    wide[:, :6] = w_q
    with pytest.raises(ValueError, match="contiguous"):
        quant_ops.dequant_score(u_q, u_s, wide[:, :6], w_s, method="fused")
    assert quant_ops.dequant_score.launches == n0


def test_quantize_rows_on_card_equals_cpu(cuda):
    # the CPU codes and scales equal the JAX package's (test_torch_quant.py);
    # the card must give the same bits
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(6040, 15)) * rng.lognormal(size=(6040, 1))
         ).astype(np.float32)
    x[::7] = 0.0
    q_cpu, s_cpu = quantize_rows(torch.from_numpy(x))
    q_card, s_card = quantize_rows(torch.from_numpy(x).to(cuda))
    assert torch.equal(s_card.cpu(), s_cpu)
    assert torch.equal(q_card.cpu(), q_cpu)


def test_int8_engine_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(0)
    m, n, r, k = 300, 1000, 15, 10
    u = rng.normal(size=(m, r)).astype(np.float32)
    w = rng.normal(size=(n, r)).astype(np.float32)
    seen = np.full((m, 16), n, np.int32)
    seen[:, :5] = rng.integers(0, n, size=(m, 5))
    requests = [rng.integers(0, m, size).astype(np.int32)
                for size in (1, 16, 17, 64, 100, 300)]
    out = {}
    for dev in ("cpu", cuda):
        index = quantize_index(index_from_numpy(u, w, seen, dev))
        n0 = quant_ops.dequant_score.launches
        with ServingEngine(index, buckets=(16, 64), k=k,
                           quant_method="fused") as eng:
            out[str(dev)] = [eng.submit(x).result(timeout=60)
                             for x in requests]
        launched = quant_ops.dequant_score.launches - n0
        # startup: one run per bucket; then one per chunk (1+1+1+1+2+5)
        assert launched == (2 + 11 if dev == cuda else 0)
    for (ci, cs), (gi, gs) in zip(out["cpu"], out[str(cuda)]):
        np.testing.assert_array_equal(gs, cs)
        tie_free = (np.diff(cs, axis=1) != 0).all(axis=1)
        np.testing.assert_array_equal(gi[tie_free], ci[tie_free])


# the JAX kernel tests' CASES, the gemma2 shape at a smaller length, head
# dims that are not a multiple of 4 (the threads' loader), V with its own
# head dim (MLA), non-causal windows, and the tile edges: Lq and Lk off the
# 128-row q tile and the 32-key tile, D and Dv off the MMA's k-step of 8
FLASH_CASES = [
    dict(B=1, Hq=2, Hkv=2, Lq=128, Lk=128, D=64),
    dict(B=2, Hq=8, Hkv=2, Lq=256, Lk=256, D=64, causal=True),
    dict(B=1, Hq=4, Hkv=4, Lq=100, Lk=100, D=32, causal=False),
    dict(B=1, Hq=4, Hkv=2, Lq=300, Lk=300, D=64, causal=True, window=128),
    dict(B=1, Hq=2, Hkv=1, Lq=256, Lk=256, D=128, causal=True, softcap=50.0),
    dict(B=1, Hq=2, Hkv=2, Lq=17, Lk=450, D=64, causal=True, q_offset=433),
    dict(B=1, Hq=6, Hkv=3, Lq=64, Lk=64, D=80, causal=True),
    dict(B=2, Hq=8, Hkv=4, Lq=1000, Lk=1000, D=256, causal=True, window=300,
         softcap=50.0),
    dict(B=1, Hq=2, Hkv=1, Lq=70, Lk=70, D=30, causal=True),
    dict(B=1, Hq=2, Hkv=1, Lq=70, Lk=90, D=17, causal=False, window=20),
    dict(B=1, Hq=4, Hkv=4, Lq=64, Lk=64, D=192, Dv=128, causal=True),
    dict(B=1, Hq=3, Hkv=1, Lq=130, Lk=200, D=48, causal=False, window=50),
    dict(B=1, Hq=2, Hkv=1, Lq=333, Lk=333, D=20, causal=True),
    dict(B=1, Hq=4, Hkv=2, Lq=259, Lk=301, D=100, causal=False),
    dict(B=1, Hq=2, Hkv=2, Lq=161, Lk=161, D=100, causal=True, window=70,
         softcap=30.0),
    dict(B=2, Hq=2, Hkv=1, Lq=129, Lk=97, D=100, Dv=20, causal=False),
    dict(B=1, Hq=2, Hkv=1, Lq=31, Lk=290, D=36, Dv=44, causal=True,
         q_offset=259),
]


def _qkv(B, Hq, Hkv, Lq, Lk, D, Dv=None, seed=0, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(B, Hq, Lq, D, generator=g, device=device)
    k = torch.randn(B, Hkv, Lk, D, generator=g, device=device)
    v = torch.randn(B, Hkv, Lk, Dv or D, generator=g, device=device)
    return q, k, v


# the MoE family's prefill shapes: granite-moe (D = 64, GQA groups of 3:
# 24 q heads on 8 KV heads; the Dv <= 64 instantiation) and MLA (q.k over
# nope 128 + rope 64, V of 128; the Dv <= 128 instantiation), L off the tile
MOE_FLASH_CASES = [
    dict(B=2, Hq=24, Hkv=8, Lq=333, Lk=333, D=64, causal=True),
    dict(B=2, Hq=16, Hkv=16, Lq=301, Lk=301, D=192, Dv=128, causal=True),
]


# zamba2-2.7b's shared attention block: 32 heads of 80, no GQA, no window
# or softcap (the Dv <= 128 instantiation at a head dim that is not a power
# of two), L off the tile
SSM_FLASH_CASES = [
    dict(B=2, Hq=32, Hkv=32, Lq=301, Lk=301, D=80, causal=True),
]


# whisper-large-v3's encoder (non-causal, Lq = Lk = 1500: the last 32-key
# tile partial) and cross-attention (non-causal, 224 queries against 1500
# keys), 20 heads of 64 at B = 1; internvl2-76b's prefill (causal, GQA
# groups of 8: 64 q heads on 8 KV heads of 128), L off the tile
ENCDEC_VLM_FLASH_CASES = [
    dict(B=1, Hq=20, Hkv=20, Lq=1500, Lk=1500, D=64, causal=False),
    dict(B=1, Hq=20, Hkv=20, Lq=224, Lk=1500, D=64, causal=False),
    dict(B=1, Hq=64, Hkv=8, Lq=301, Lk=301, D=128, causal=True),
]


# granite-34b's prefill, rows 5o and 5p cut in length (L off the tile):
# MQA, 48 q heads on one KV head of 128 in one process and a rank's 12
MQA_FLASH_CASES = [
    dict(B=2, Hq=48, Hkv=1, Lq=301, Lk=301, D=128, causal=True),
    dict(B=2, Hq=12, Hkv=1, Lq=301, Lk=301, D=128, causal=True),
]


@pytest.mark.parametrize("case", FLASH_CASES + MOE_FLASH_CASES
                         + SSM_FLASH_CASES + ENCDEC_VLM_FLASH_CASES
                         + MQA_FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, case):
    case = dict(case)
    dims = [case.pop(n) for n in ("B", "Hq", "Hkv", "Lq", "Lk", "D")]
    q, k, v = _qkv(*dims, Dv=case.pop("Dv", None))
    n0 = flash_ops.flash_attention.launches
    got = flash_ops.flash_attention(q, k, v, **case)
    assert flash_ops.flash_attention.launches == n0 + 1
    torch.cuda.synchronize()
    # the JAX kernel tests' tolerance
    torch.testing.assert_close(got, attention_ref(q, k, v, **case),
                               rtol=2e-4, atol=2e-5)


def test_flash_kernel_is_f32_accurate(cuda):
    # against float64: within a small factor of the plain f32 version's own
    # error, which a single TF32 (10-bit) or bf16 pass would not be
    B, Hq, Hkv, L, D = 1, 2, 1, 1024, 256
    q, k, v = _qkv(B, Hq, Hkv, L, L, D, seed=7)
    got = flash_ops.flash_attention(q, k, v, causal=True, softcap=50.0)
    plain = attention_ref(q, k, v, causal=True, softcap=50.0)
    qd, kd, vd = (x.double() for x in (q, k, v))
    kd, vd = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (kd, vd))
    logits = qd @ kd.transpose(-1, -2) / D ** 0.5
    logits = 50.0 * torch.tanh(logits / 50.0)
    pos = torch.arange(L, device=cuda)
    logits = logits.masked_fill(pos[:, None] < pos[None, :], float("-inf"))
    want = torch.softmax(logits, dim=-1) @ vd
    torch.cuda.synchronize()
    err = float((got.double() - want).abs().max())
    err_plain = float((plain.double() - want).abs().max())
    assert err <= 4 * err_plain + 1e-7, (err, err_plain)


def test_flash_kernel_fully_masked_rows_give_zero(cuda):
    # queries past Lk + window - 1 see no key: the TPU kernel's _finalize
    # (and this kernel) write 0 there, where the plain version averages V
    q, k, v = _qkv(1, 3, 1, 200, 130, 48)
    got = flash_ops.flash_attention(q, k, v, causal=False, window=50)
    torch.cuda.synchronize()
    live = 130 + 50 - 1
    assert torch.equal(got[:, :, live:], torch.zeros_like(got[:, :, live:]))
    torch.testing.assert_close(
        got[:, :, :live],
        attention_ref(q, k, v, causal=False, window=50)[:, :, :live],
        rtol=2e-4, atol=2e-5)


def test_flash_kernel_bf16(cuda):
    q, k, v = (x.to(torch.bfloat16) for x in _qkv(1, 4, 2, 256, 256, 64))
    got = flash_ops.flash_attention(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    want = attention_ref(q, k, v, causal=True)
    assert float((got.float() - want.float()).abs().max()) < 5e-2


@pytest.mark.parametrize("case", MOE_FLASH_CASES)
def test_flash_kernel_bf16_at_the_moe_shapes(cuda, case):
    case = dict(case)
    dims = [case.pop(n) for n in ("B", "Hq", "Hkv", "Lq", "Lk", "D")]
    q, k, v = (x.to(torch.bfloat16)
               for x in _qkv(*dims, Dv=case.pop("Dv", None)))
    got = flash_ops.flash_attention(q, k, v, **case)
    want = attention_ref(q, k, v, **case)
    assert float((got.float() - want.float()).abs().max()) < 5e-2


@pytest.mark.parametrize("case", SSM_FLASH_CASES)
def test_flash_kernel_bf16_at_the_zamba2_shape(cuda, case):
    case = dict(case)
    dims = [case.pop(n) for n in ("B", "Hq", "Hkv", "Lq", "Lk", "D")]
    q, k, v = (x.to(torch.bfloat16) for x in _qkv(*dims))
    got = flash_ops.flash_attention(q, k, v, **case)
    want = attention_ref(q, k, v, **case)
    assert float((got.float() - want.float()).abs().max()) < 5e-2


@pytest.mark.parametrize("case", ENCDEC_VLM_FLASH_CASES)
def test_flash_kernel_bf16_at_the_encdec_and_vlm_shapes(cuda, case):
    case = dict(case)
    dims = [case.pop(n) for n in ("B", "Hq", "Hkv", "Lq", "Lk", "D")]
    q, k, v = (x.to(torch.bfloat16) for x in _qkv(*dims))
    got = flash_ops.flash_attention(q, k, v, **case)
    want = attention_ref(q, k, v, **case)
    assert float((got.float() - want.float()).abs().max()) < 5e-2


@pytest.mark.parametrize("case", MQA_FLASH_CASES)
def test_flash_kernel_bf16_at_the_mqa_shapes(cuda, case):
    case = dict(case)
    dims = [case.pop(n) for n in ("B", "Hq", "Hkv", "Lq", "Lk", "D")]
    q, k, v = (x.to(torch.bfloat16) for x in _qkv(*dims))
    got = flash_ops.flash_attention(q, k, v, **case)
    want = attention_ref(q, k, v, **case)
    assert float((got.float() - want.float()).abs().max()) < 5e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos,window", [(700, 0), (1000, 256)])
def test_masked_partial_softmax_on_card_matches_whole_cache_decode(
        cuda, dtype, pos, window):
    """One decode step of attention at granite-34b's heads (48 query heads
    on one KV head of 128) against a 1024-deep cache on the card: the
    cache cut into 4 sequence slices, stacked, and combined by the ranks'
    own code (``softmax_pv`` with a reduce over the slices' dim) against
    the whole-cache ``decode_attention`` on the same inputs (its ``wo``
    the identity, so the attention output is compared).  At 1e-5 x
    max|o| (float32 sums in another order); with a bfloat16 cache each p
    may round to the neighbouring bfloat16, so 2^-8 x sum p |v| is added.
    The first slices lie wholly past the window at pos 1000, the last
    wholly past pos at 700."""

    from repro_torch.models import attention as A
    from repro_torch.models import layers as L

    g = torch.Generator(device=cuda).manual_seed(pos)
    B, H, Hkv, D, Lmax, n, cap = 4, 48, 1, 128, 1024, 4, 30.0
    d = H * D
    p = A.init_attention(g, d, H, Hkv, D, False, torch.float32, cuda)
    p["wo"] = torch.eye(d, device=cuda)
    x = torch.randn((B, 1, d), generator=g, device=cuda)
    ck = torch.randn((B, Hkv, Lmax, D), generator=g, device=cuda).to(dtype)
    cv = torch.randn((B, Hkv, Lmax, D), generator=g, device=cuda).to(dtype)
    kw = dict(head_dim=D, window=window, attn_softcap=cap)
    want, _ = A.decode_attention(p, x, A.KVCache(ck.clone(), cv.clone()),
                                 pos, **kw)
    # the same step: q and the new k, v written as decode writes them
    q, k, v = A._project_qkv(p, x, D)
    posv = torch.full((1,), pos, dtype=torch.int32, device=cuda)
    q, k = L.apply_rope(q, posv), L.apply_rope(k, posv)
    ck[:, :, pos:pos + 1], cv[:, :, pos:pos + 1] = k, v
    m = Lmax // n

    def slices(t):
        return torch.stack(t.split(m, dim=2))

    def reduce(t, op):
        return (t.amax if op == "max" else t.sum)(dim=0, keepdim=True)

    kpos = torch.arange(Lmax, device=cuda).reshape(n, 1, 1, 1, m)
    got = A.softmax_pv(A.decode_logits(q, slices(ck), kpos, pos, **kw),
                       slices(cv), reduce)[0].reshape(B, 1, d)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    tol = 1e-5 * float(want.abs().max())
    if dtype == torch.bfloat16:
        logits = A.decode_logits(q, ck, torch.arange(Lmax, device=cuda), pos,
                                 **kw)
        tol = tol + 2.0 ** -8 * (torch.softmax(logits, dim=-1)
                                 @ cv.float().abs()).reshape(B, 1, d)
    assert torch.all((got - want).abs() <= tol)


def test_flash_kernel_rejects_bad_inputs(cuda):
    q, k, v = _qkv(1, 4, 2, 32, 32, 64)
    n0 = flash_ops.flash_attention.launches
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops.flash_attention(q.transpose(1, 2).contiguous()
                                  .transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="one device"):
        flash_ops.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="head dims"):
        flash_ops.flash_attention(*_qkv(1, 2, 2, 8, 8, 264))
    with pytest.raises(ValueError, match="k:"):
        flash_ops.flash_attention(q, k.double(), v)
    assert flash_ops.flash_attention.launches == n0


def test_flash_kernel_refuses_autograd(cuda):
    q, k, v = _qkv(1, 4, 2, 32, 32, 64)
    n0 = flash_ops.flash_attention.launches
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match='no backward.*attn_impl="ref"'):
        flash_ops.flash_attention(q, k, v)
    assert flash_ops.flash_attention.launches == n0
    with torch.no_grad():
        flash_ops.flash_attention(q, k, v)
    assert flash_ops.flash_attention.launches == n0 + 1


def test_gemma2_smoke_training_on_card_matches_cpu(cuda):
    """Loss, every gradient leaf (remat on) and one microbatched AdamW
    step of the smoke gemma2 on the card against the CPU."""

    from repro_torch.config import TrainConfig
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train import make_train_step
    from repro_torch.train.step import loss_and_grads

    cfg = get_smoke_config("gemma2-2b")
    card = build_model(cfg, Ctx(remat=True), device=cuda)
    params = card.init(torch.Generator(device=cuda).manual_seed(0))
    host = build_model(cfg, Ctx(remat=True), device="cpu")
    host_params = _tree_to(params, "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 40)),
             "targets": rng.integers(0, cfg.vocab_size, (4, 40))}
    lc, gc = loss_and_grads(card.loss, params, [batch])
    lh, gh = loss_and_grads(host.loss, host_params, [batch])
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(gc), tree_leaves(gh)):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=0, optimizer="sgd",
                     microbatch=2)
    states = []
    for model, p in ((card, params), (host, host_params)):
        opt = make_optimizer(tc)
        p, _, m = make_train_step(model, tc, opt)(p, opt.init(p), batch)
        states.append((p, m["loss"]))
    (pc, mc), (ph, mh) = states
    torch.testing.assert_close(mc.cpu(), mh, rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(pc), tree_leaves(ph)):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


def test_gemma2_smoke_model_on_card_matches_cpu(cuda):
    cfg = get_smoke_config("gemma2-2b")
    ctx = Ctx(attn_impl="kernel")
    card = build_model(cfg, ctx, device=cuda)
    params = card.init(torch.Generator(device=cuda).manual_seed(0))
    host = build_model(cfg, ctx, device="cpu")
    host_params = _tree_to(params, "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    n0 = flash_ops.flash_attention.launches
    lc, cc = card.prefill(params, {"tokens": tokens}, 48)
    assert flash_ops.flash_attention.launches == n0 + cfg.num_layers
    lh, ch = host.prefill(host_params, {"tokens": tokens}, 48)
    scale = float(lh.abs().max())
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-4, atol=1e-5 * scale)
    out_c = ServeLoop(card, params, 2, 48).generate({"tokens": tokens}, 6)
    out_h = ServeLoop(host, host_params, 2, 48).generate({"tokens": tokens},
                                                          6)
    assert flash_ops.flash_attention.launches == n0 + 2 * cfg.num_layers
    top2 = lh.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 1e-3
    assert torch.equal(out_c.cpu()[sure, 0], out_h[sure, 0])


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_fault_and_async_steps_are_bitwise_the_plain_step_on_card(cuda,
                                                                  layout):
    """On the card, through the kernels: the ``FaultPlan(p=0)`` gossip
    step and the async step with ``exchange_every=1, max_staleness=0`` on
    one (2, 2) tile are bitwise the ``faults=None`` step."""

    from repro_torch.core import gossip
    from repro_torch.core.state import init_state
    from repro_torch.faults import FaultPlan

    prob = CompletionProblem.from_dataset(
        lowrank_problem(300, 140, 15, density=0.3, seed=3), 2, 2, 15,
        layout=layout, device=cuda)
    cfg = GossipMCConfig(m=300, n=140, p=2, q=2, rank=15)
    state = init_state(torch.Generator(device=cuda).manual_seed(0),
                       prob.spec)
    wrapper = (sddmm_ops.sddmm_segment_grad if layout == "sparse"
               else mfg_ops.masked_factor_grad)
    before = wrapper.launches
    outs = []
    for kw in ({}, dict(faults=FaultPlan(key=0)),
               dict(async_rounds=True, max_staleness=0)):
        step = gossip.make_gossip_step((2, 2), cfg, layout=layout,
                                       steps_per_call=20, **kw)
        outs.append(step(prob.data, gossip.init_carry(state)).state)
    assert wrapper.launches - before == 60
    for got in outs[1:]:
        assert torch.equal(got.U, outs[0].U) and torch.equal(got.W,
                                                             outs[0].W)


def test_wave_resume_is_bitwise_on_card(cuda, tmp_path):
    """A Wave fit on the card stopped after its second checkpoint and
    resumed (the CUDA generator's state restored) equals the
    uninterrupted fit bitwise."""

    from repro_torch.launch.gossip import FitStopped, StopAt
    from repro_torch.mc import Checkpoint, Wave

    prob = CompletionProblem.from_dataset(
        lowrank_problem(300, 140, 15, density=0.3, seed=3), 3, 3, 15,
        layout="sparse", device=cuda)
    cfg = GossipMCConfig(m=300, n=140, p=3, q=3, rank=15)
    sched = Wave(num_rounds=9, eval_every=3)
    whole = Trainer(cfg).fit(prob, sched, seed=5)
    ck = Checkpoint(str(tmp_path))
    with pytest.raises(FitStopped):
        Trainer(cfg, callbacks=[ck, StopAt(6)]).fit(prob, sched, seed=5)
    resumed = Trainer(cfg).fit(prob, sched, seed=5,
                               resume_from=str(tmp_path))
    assert torch.equal(resumed.state.U, whole.state.U)
    assert torch.equal(resumed.state.W, whole.state.W)
    assert resumed.history == whole.history[2:]


def test_trace_on_card_holds_the_span_and_kernel_events(cuda, tmp_path):
    import json
    import os

    from repro_torch import obs

    prob = CompletionProblem.from_dataset(
        lowrank_problem(300, 140, 15, density=0.3, seed=3), 2, 2, 15,
        layout="sparse", device=cuda)
    with obs.trace(str(tmp_path)):
        Trainer(GossipMCConfig(m=300, n=140, p=2, q=2, rank=15)).fit(
            prob, FullGD(num_rounds=3))
    with open(os.path.join(str(tmp_path), obs.spans.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "fit.full" for e in events)
    assert any(e.get("cat") == "kernel" for e in events)


# ---------------------------------------------------------------------- #
# the sharded session on the card
# ---------------------------------------------------------------------- #


def _tie_oracle(x: np.ndarray, k: int) -> np.ndarray:
    """``jax.lax.top_k``'s positions by numpy: f32 bits made monotone as
    signed ints (NaN above +inf, +0 above -0), ties to the lower id."""

    b = x.view(np.int32).astype(np.int64)
    key = np.where(b < 0, b ^ 0x7FFFFFFF, b)
    ids = np.broadcast_to(np.arange(x.shape[1]), x.shape)
    return np.lexsort((ids, -key), axis=1)[:, :k]


def test_topk_ordered_on_card_breaks_ties_as_jax(cuda):
    from repro_torch.serve.recommend import recommend_topk, topk_ordered

    rng = np.random.default_rng(21)
    x = rng.integers(-3, 4, (1024, 3706)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = -np.inf
    x[rng.random(x.shape) < 0.1] = -0.0
    for k in (1, 10, 100):
        vals, pos = topk_ordered(torch.from_numpy(x).to(cuda), k)
        want = _tie_oracle(x, k)
        np.testing.assert_array_equal(pos.cpu().numpy(), want)
        np.testing.assert_array_equal(vals.cpu().numpy(),
                                      np.take_along_axis(x, want, 1))
    _, pos = topk_ordered(torch.zeros(2, 100_000, device=cuda), 5)
    assert pos.tolist() == [[0, 1, 2, 3, 4]] * 2
    # identical item rows tie: the engine path returns the lower ids first
    idx = index_from_numpy(np.ones((4, 3), np.float32),
                           np.ones((50, 3), np.float32),
                           np.full((4, 16), 50, np.int32), cuda)
    items, _ = recommend_topk(idx, [0, 3], k=6)
    assert items.tolist() == [list(range(6))] * 2


def test_topk_ordered_on_card_selects_again_only_the_tied_rows(cuda,
                                                               monkeypatch):
    """Distinct scores go through the float ``topk`` alone; a NaN, a tie
    at the k-th score and +0 beside -0 send only their rows through the
    int64 keys; all rows in ``jax.lax.top_k``'s order."""

    from repro_torch.serve import recommend as rec

    rng = np.random.default_rng(25)
    x = rng.normal(size=(1024, 3706)).astype(np.float32)
    x[3, 17] = np.nan
    top = -np.sort(-x[7])
    x[7, 0] = top[9]                      # the 10th score once more
    x[11] = -np.abs(x[11]) - 1.0
    x[11, 100:109] = 1.0
    x[11, 5], x[11, 6] = -0.0, 0.0
    seen = []
    keyed = rec._keyed_topk

    def spy(scores, k, ids):
        seen.append(scores.shape[0])
        return keyed(scores, k, ids)

    monkeypatch.setattr(rec, "_keyed_topk", spy)
    vals, pos = rec.topk_ordered(torch.from_numpy(x).to(cuda), 10)
    assert seen == [3]
    want = _tie_oracle(x, 10)
    np.testing.assert_array_equal(pos.cpu().numpy(), want)
    np.testing.assert_array_equal(
        vals.cpu().numpy().view(np.int32),
        np.take_along_axis(x, want, 1).view(np.int32))


def test_sharded_scores_on_card_are_slices_of_the_unsharded(cuda):
    """int8 shards score bitwise as the columns of the unsharded scores
    (per-row scales commute with slicing); a one-rank plan answers
    bitwise as ``recommend_topk``."""

    from repro_torch.mesh import MeshPlan
    from repro_torch.serve.recommend import (_batch_scores, recommend_topk,
                                            recommend_topk_sharded,
                                            shard_index)

    rng = np.random.default_rng(22)
    n, r = 3706, 64
    idx = index_from_numpy(
        rng.normal(size=(600, r)).astype(np.float32),
        rng.normal(size=(n, r)).astype(np.float32),
        rng.integers(0, n + 1, (600, 32)).astype(np.int32), cuda)
    q = quantize_index(idx)
    users = torch.arange(0, 600, 3, device=cuda)
    full = _batch_scores(q, users, "fused")
    plan = MeshPlan.for_world(4)
    for rank in range(4):
        sidx = shard_index(q, plan, rank)
        part = _batch_scores(sidx.index, users, "fused")
        real = min(sidx.shard_items, n - sidx.start)
        assert torch.equal(part[:, :real],
                           full[:, sidx.start:sidx.start + real])
    for index, method in ((idx, None), (q, "fused")):
        one = shard_index(index, MeshPlan.build(1, 1))
        got = recommend_topk_sharded(one, users, k=10, method=method)
        want = recommend_topk(index, users, k=10, method=method)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_routed_ingest_on_card_is_the_global_tile(cuda):
    from repro_torch.mesh import MeshPlan
    from repro_torch.sparse.sharded import ShardedEntries, f_grads_sharded

    rng = np.random.default_rng(23)
    m, n, r = 900, 500, 15
    lin = rng.choice(m * n, 40_000, replace=False)
    rows, cols = lin // n, lin % n
    vals = rng.normal(size=len(lin)).astype(np.float32)
    plan = MeshPlan.build(4, 4, grid=(2, 2))
    whole, _ = from_entries(rows, cols, vals, m, n, 4, 4, headroom=64,
                            device=cuda)
    U = torch.from_numpy(rng.normal(size=(4, 4, 225, r)).astype(
        np.float32)).to(cuda)
    W = torch.from_numpy(rng.normal(size=(4, 4, 125, r)).astype(
        np.float32)).to(cuda)
    for rank in range(4):
        sh, _ = ShardedEntries.from_coo(rows, cols, vals, m, n, plan,
                                        headroom=64, rank=rank, device=cuda)
        want = plan.local_slice(whole, rank)
        for a, b in zip((*sh.sp.entries, sh.sp.nnz),
                        (*want.entries, want.nnz)):
            assert a.is_cuda and torch.equal(a, b)
        n0 = sddmm_ops.sddmm_segment_grad.launches
        gu, gw = f_grads_sharded(sh, U, W)
        assert sddmm_ops.sddmm_segment_grad.launches == n0 + 1
        _, pu, pw = sddmm_segment_grad_ref(sh.sp.entries,
                                           *plan.local_slice((U, W), rank))
        _close((gu, gw), (pu, pw))


def test_grid_fit_serves_on_card_as_the_unsharded_engine(cuda):
    """Four ranks sharing the card (gloo, staged through the host): a
    grid fit's int8 engine answers bitwise as the unsharded one."""

    from repro_torch.launch.gossip import ProblemRecipe, run_on_grid
    from repro_torch.launch.serve_recommend import ServeJob, serve_fit_rank

    recipe = ProblemRecipe("lowrank_problem", dict(m=400, n=300, r=8,
                                                   density=0.2, seed=2),
                           p=4, q=4, rank=8, layout="sparse")
    cfg = GossipMCConfig(m=400, n=300, p=4, q=4, rank=8, rho=1e3,
                         lam=1e-6, a=5e-4, b=5e-7)
    rng = np.random.default_rng(24)
    reqs = tuple(rng.integers(0, 400, s).astype(np.int32)
                 for s in (1, 16, 17, 300, 64))
    for quant in ("int8", None):
        job = ServeJob(recipe, cfg, 40, 20, reqs[:3], reqs[3:], quant=quant,
                       buckets=(16, 64, 256), k=10)
        outs = run_on_grid(serve_fit_rank, (2, 2), job, (2, 2),
                           device="cuda", timeout=300)
        top = outs[0]
        assert top["items_equal"], top
        if quant:
            assert top["scores_bitwise"] and all(o["launches"] > 0
                                                 for o in outs)
        else:
            assert top["scores_max_rel"] <= 1e-5


@pytest.mark.parametrize("E,k,shared", [(40, 8, 0), (64, 6, 2)])
def test_moe_ffn_on_card_matches_cpu(cuda, E, k, shared):
    """The MoE FFN at small width on the card against the CPU: the same
    routing on every token, outputs within 1e-5 of their scale."""

    from repro_torch.config import MoEConfig
    from repro_torch.models import moe as MOE

    cfg = MoEConfig(num_experts=E, num_experts_per_tok=k, expert_d_ff=64,
                    num_shared_experts=shared)
    params = MOE.init_moe(torch.Generator(device=cuda).manual_seed(0), 96,
                          cfg, torch.float32, cuda)
    x = torch.randn(3, 200, 96, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    host = _tree_to(params, "cpu")
    idx_c, w_c, aux_c = MOE.route(params, x.reshape(-1, 96), cfg)
    idx_h, w_h, aux_h = MOE.route(host, x.cpu().reshape(-1, 96), cfg)
    assert torch.equal(idx_c.cpu(), idx_h)
    torch.testing.assert_close(w_c.cpu(), w_h, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(aux_c.cpu(), aux_h, rtol=1e-5, atol=0)
    y_c, _ = MOE.moe_ffn(params, x, cfg)
    y_h, _ = MOE.moe_ffn(host, x.cpu(), cfg)
    assert y_c.is_cuda
    torch.testing.assert_close(y_c.cpu(), y_h, rtol=0,
                               atol=1e-5 * float(y_h.abs().max()))
    ref, _ = MOE.moe_ffn_reference(params, x, cfg)
    torch.testing.assert_close(y_c, ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_moe_smoke_model_on_card_matches_cpu(cuda, arch):
    cfg = get_smoke_config(arch)
    ctx = Ctx(attn_impl="kernel")
    card = build_model(cfg, ctx, device=cuda)
    params = card.init(torch.Generator(device=cuda).manual_seed(0))
    host = build_model(cfg, ctx, device="cpu")
    host_params = _tree_to(params, "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    n0 = flash_ops.flash_attention.launches
    lc, _ = card.prefill(params, {"tokens": tokens}, 48)
    assert flash_ops.flash_attention.launches == n0 + cfg.num_layers
    lh, _ = host.prefill(host_params, {"tokens": tokens}, 48)
    scale = float(lh.abs().max())
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-4, atol=1e-5 * scale)
    out_c = ServeLoop(card, params, 2, 48).generate({"tokens": tokens}, 6)
    out_h = ServeLoop(host, host_params, 2, 48).generate({"tokens": tokens},
                                                          6)
    top2 = lh.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 1e-3
    assert torch.equal(out_c.cpu()[sure, 0], out_h[sure, 0])


def _ssm_case(cuda, d_model=64):
    cfg = get_smoke_config("mamba2-780m").ssm
    params = SSM.init_ssm(torch.Generator(device=cuda).manual_seed(0),
                          d_model, cfg, torch.float32, cuda)
    return cfg, params, _tree_to(params, "cpu")


@pytest.mark.parametrize("L", [48, 40])
def test_ssm_block_on_card_matches_cpu(cuda, L):
    """The Mamba2 block at the smoke size on the card against the CPU, on
    both dispatch branches (48 = 3 chunks of 16; 40 the sequential
    oracle): within 1e-5 of the output's scale."""

    cfg, params, host = _ssm_case(cuda)
    x = torch.randn(2, L, 64, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    y_c = SSM.ssm_block(params, x, cfg, 64)
    y_h = SSM.ssm_block(host, x.cpu(), cfg, 64)
    assert y_c.is_cuda
    torch.testing.assert_close(y_c.cpu(), y_h, rtol=0,
                               atol=1e-5 * float(y_h.abs().max()))
    y_s = SSM.ssm_block(params, x, cfg, 64, use_chunked=False)
    torch.testing.assert_close(y_c, y_s, rtol=0,
                               atol=1e-4 * float(y_s.abs().max()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssm_decode_on_card_matches_cpu(cuda, dtype):
    """Six decode steps after a 32-token prefill (float32 registers) and
    from ``init_ssm_state`` in ``dtype``: outputs within 1e-5 of scale,
    the state written in place in its dtypes."""

    cfg, params, host = _ssm_case(cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    x0 = torch.randn(2, 32, 64, generator=g, device=cuda)
    xs = torch.randn(2, 6, 64, generator=g, device=cuda)
    _, st_c = SSM.ssm_prefill(params, x0, cfg, 64)
    _, st_h = SSM.ssm_prefill(host, x0.cpu(), cfg, 64)
    for a, b in ((st_c, st_h),
                 (SSM.init_ssm_state(2, 64, cfg, dtype, cuda),
                  SSM.init_ssm_state(2, 64, cfg, dtype, "cpu"))):
        for i in range(6):
            y_c, out = SSM.ssm_decode(params, xs[:, i:i + 1], a, cfg, 64)
            y_h, _ = SSM.ssm_decode(host, xs[:, i:i + 1].cpu(), b, cfg, 64)
            assert out is a
            torch.testing.assert_close(y_c.cpu(), y_h, rtol=0,
                                       atol=1e-5 * float(y_h.abs().max()))
        for f_c, f_h in zip(a, b):
            # a bf16 register: one ulp where a last-bit f32 difference
            # flips its rounding
            assert f_c.dtype == f_h.dtype
            tol = 2.0 ** -7 if f_h.dtype == torch.bfloat16 else 1e-5
            torch.testing.assert_close(f_c.cpu().float(), f_h.float(), rtol=0,
                                       atol=tol * float(f_h.abs().max()))


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_ssm_smoke_model_on_card_matches_cpu(cuda, arch):
    """The smoke model on the card against the CPU: one flash launch a
    shared-block invocation in zamba2's prefill (none in mamba2's), the
    logits within 1e-5 of scale, the first greedy token where clear."""

    cfg = get_smoke_config(arch)
    ctx = Ctx(attn_impl="kernel")
    card = build_model(cfg, ctx, device=cuda)
    params = card.init(torch.Generator(device=cuda).manual_seed(0))
    host = build_model(cfg, ctx, device="cpu")
    host_params = _tree_to(params, "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 48))
    n0 = flash_ops.flash_attention.launches
    lc, _ = card.prefill(params, {"tokens": tokens}, 64)
    units = (cfg.num_layers // cfg.shared_attn_every
             if cfg.family == "hybrid" else 0)
    assert flash_ops.flash_attention.launches == n0 + units
    lh, _ = host.prefill(host_params, {"tokens": tokens}, 64)
    scale = float(lh.abs().max())
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-4, atol=1e-5 * scale)
    out_c = ServeLoop(card, params, 2, 64).generate({"tokens": tokens}, 6)
    out_h = ServeLoop(host, host_params, 2, 64).generate({"tokens": tokens},
                                                          6)
    top2 = lh.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 1e-3
    assert torch.equal(out_c.cpu()[sure, 0], out_h[sure, 0])


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-76b"])
def test_encdec_and_vlm_smoke_models_on_card_match_cpu(cuda, arch):
    """The smoke model's prefill on the card against the CPU: one flash
    launch a whisper encoder layer and two a decoder layer (self and
    cross), one a VLM layer; the logits within 1e-5 of scale, then a
    decode step from each side's cache, and the first greedy token where
    clear."""

    cfg = get_smoke_config(arch)
    ctx = Ctx(attn_impl="kernel", cache_dtype=torch.float32)
    card = build_model(cfg, ctx, device=cuda)
    params = card.init(torch.Generator(device=cuda).manual_seed(0))
    host = build_model(cfg, ctx, device="cpu")
    host_params = _tree_to(params, "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 20))}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(2, cfg.encoder_seq_len,
                                           cfg.d_model)).astype(np.float32)
        launches, pos = cfg.encoder_layers + 2 * cfg.num_layers, 20
    else:
        batch["patches"] = rng.normal(size=(2, cfg.num_patch_tokens,
                                            1024)).astype(np.float32)
        launches, pos = cfg.num_layers, cfg.num_patch_tokens + 20
    max_len = pos + 8
    n0 = flash_ops.flash_attention.launches
    lc, cc = card.prefill(params, batch, max_len)
    assert flash_ops.flash_attention.launches == n0 + launches
    lh, ch = host.prefill(host_params, batch, max_len)
    scale = float(lh.abs().max())
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-4, atol=1e-5 * scale)
    tok = lh.argmax(-1).to(torch.int32)
    dc, _ = card.decode(params, cc, tok.to(cuda), pos)
    dh, _ = host.decode(host_params, ch, tok, pos)
    assert flash_ops.flash_attention.launches == n0 + launches
    torch.testing.assert_close(dc.cpu(), dh, rtol=1e-4,
                               atol=1e-5 * float(dh.abs().max()))
    out_c = ServeLoop(card, params, 2, max_len).generate(batch, 6)
    out_h = ServeLoop(host, host_params, 2, max_len).generate(batch, 6)
    top2 = lh.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 1e-3
    assert torch.equal(out_c.cpu()[sure, 0], out_h[sure, 0])


def test_dequant_score_counts_launches_by_kernel(cuda):
    """``by_kernel`` records the staged kernel's tile, or the first kernel
    above the staged ranks, one entry a launch."""

    quant_ops.dequant_score.by_kernel.clear()
    quant_ops.dequant_score(*_codes(33, 500, 65, seed=1, device=cuda),
                            method="fused")
    quant_ops.dequant_score(*_codes(1024, 3706, 15, seed=2, device=cuda),
                            method="fused")
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert quant_ops.dequant_score.by_kernel == {
        "first": 1, _picked_tile(1024, 3706, sms): 1}


def _tp_card_rank(rank, device, cfg, batch, fed, max_len, tp):
    """A tensor-parallel rank of a smoke model on the card: its seeded
    shards, the prefill and decode steps fed ``fed`` (a float32 cache);
    the logits on the host and the flash launches of the rank."""

    import torch.distributed as dist

    from repro_torch.config import MeshConfig, ShapeConfig
    from repro_torch.launch import lm_engine
    from repro_torch.train.shard import init_shard

    mesh_cfg = MeshConfig(data=1, model=tp, fsdp=False)
    model = build_model(cfg, Ctx(attn_impl="kernel",
                                 cache_dtype=torch.float32), device=device)
    B, L = batch["tokens"].shape
    P = cfg.num_patch_tokens
    group = dist.group.WORLD if tp > 1 else None
    prefill, _ = lm_engine.make_prefill_step(
        model, group, mesh_cfg, ShapeConfig("p", L, B, "prefill"), max_len)
    decode, _ = lm_engine.make_serve_step(
        model, group, mesh_cfg, ShapeConfig("d", max_len - P, B, "decode"))
    params = init_shard(0, cfg, None, mesh_cfg, rank, device)
    n0 = flash_ops.flash_attention.launches
    logits, cache = prefill(params, batch)
    out = [logits.cpu().numpy()]
    for i, tok in enumerate(fed):
        logits, cache = decode(params, cache, tok.to(device), P + L + i)
        out.append(logits.cpu().numpy())
    # numpy: a tensor would cross the queue as shared storage
    return {"logits": out, "launches": flash_ops.flash_attention.launches - n0}


def test_tp_serving_on_one_card_runs_the_flash_kernel_on_each_rank(cuda):
    """tp = 2 ranks sharing the card (``gloo``, collectives staged through
    the host; ``nccl`` where the machine has a card a rank) against the
    unsharded plain-attention model on the same seeded weights: one flash
    launch a layer on each rank, logits within 1e-3 x max|logit| (the LM
    phases' gate, kernel against plain), greedy tokens equal where the
    plain model's top-2 margin exceeds that bound."""

    import dataclasses

    from repro_torch.config import MeshConfig
    from repro_torch.launch.gossip import run_on_grid
    from repro_torch.train.shard import init_shard

    cfg = dataclasses.replace(get_smoke_config("internvl2-76b"),
                              d_model=256, head_dim=64)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 40)),
             "patches": rng.normal(size=(2, cfg.num_patch_tokens, 1024))
             .astype(np.float32)}
    steps = 3
    max_len = cfg.num_patch_tokens + 40 + steps
    plain = build_model(cfg, Ctx(attn_impl="ref", cache_dtype=torch.float32),
                        device=cuda)
    params = init_shard(0, cfg, None, MeshConfig(data=1, model=1, fsdp=False),
                        0, cuda)
    with torch.inference_mode():
        want, cache = plain.prefill(params, batch, max_len)
        wants, fed = [want.cpu()], []
        for i in range(steps):
            tok = want.argmax(-1).to(torch.int32)
            fed.append(tok.cpu())
            want, cache = plain.decode(params, cache, tok,
                                       cfg.num_patch_tokens + 40 + i)
            wants.append(want.cpu())
    del params, cache
    ranks = run_on_grid(_tp_card_rank, (1, 2), cfg, batch, fed, max_len, 2,
                        device="cuda", timeout=300)
    for res in ranks:
        assert res["launches"] == cfg.num_layers
        for got, ref in zip(res["logits"], wants):
            got = torch.from_numpy(got)
            bound = 1e-3 * float(ref.abs().max())
            assert float((got - ref).abs().max()) <= bound
            top2 = ref.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > bound
            assert torch.equal(got.argmax(-1)[sure], ref.argmax(-1)[sure])


def _fsdp_card_rank(rank, device, cfg, batch, fed, max_len):
    """A rank of a 2 x 2 (data x model) FSDP grid of a smoke model on the
    card: its seeded shards, the prefill and decode steps fed ``fed`` (a
    float32 cache); the logits on the host, the flash launches, the
    decode's FSDP gathers and whether they read the peers' buffers on
    this card."""

    import torch.distributed as dist

    from repro_torch.config import MeshConfig, ShapeConfig
    from repro_torch.launch import lm_engine
    from repro_torch.train.shard import init_shard

    mesh_cfg = MeshConfig(data=2, model=2, fsdp=True)
    model = build_model(cfg, Ctx(attn_impl="kernel",
                                 cache_dtype=torch.float32), device=device)
    B, L = batch["tokens"].shape
    prefill, _ = lm_engine.make_prefill_step(
        model, dist.group.WORLD, mesh_cfg, ShapeConfig("p", L, B, "prefill"),
        max_len)
    decode, dinfo = lm_engine.make_serve_step(
        model, dist.group.WORLD, mesh_cfg,
        ShapeConfig("d", max_len, B, "decode"))
    fsdp = dinfo["model"].ctx.fsdp
    fsdp.timed = True
    params = init_shard(0, cfg, None, mesh_cfg, rank, device)
    n0 = flash_ops.flash_attention.launches
    logits, cache = prefill(params, batch)
    out = [logits.cpu().numpy()]
    for i, tok in enumerate(fed):
        logits, cache = decode(params, cache, tok.to(device), L + i)
        out.append(logits.cpu().numpy())
    # numpy: a tensor would cross the queue as shared storage
    return {"logits": out, "launches": flash_ops.flash_attention.launches - n0,
            "gathers": fsdp.stats["all_gather"][0],
            "peer_copies": fsdp.one_card is True and bool(fsdp.peers)}


def test_fsdp_serving_on_one_card_reads_the_peers_shards(cuda):
    """A 2 x 2 grid (data x model, FSDP on) of ranks sharing the card
    (``gloo``; a unit's FSDP gather copies the peers' shards device to
    device) against the unsharded plain-attention model on the same
    seeded weights: one flash launch a layer on each rank, one FSDP gather
    a unit and decode step, logits within 1e-3 x max|logit| (the LM
    phases' gate, kernel against plain), greedy tokens equal where the
    plain model's top-2 margin exceeds that bound."""

    from repro_torch.config import MeshConfig
    from repro_torch.launch.gossip import run_on_grid
    from repro_torch.train.shard import init_shard

    cfg = get_smoke_config("qwen1.5-32b")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 40))}
    steps = 3
    max_len = 40 + steps
    plain = build_model(cfg, Ctx(attn_impl="ref", cache_dtype=torch.float32),
                        device=cuda)
    params = init_shard(0, cfg, None, MeshConfig(data=1, model=1, fsdp=False),
                        0, cuda)
    with torch.inference_mode():
        want, cache = plain.prefill(params, batch, max_len)
        wants, fed = [want.cpu()], []
        for i in range(steps):
            tok = want.argmax(-1).to(torch.int32)
            fed.append(tok.cpu())
            want, cache = plain.decode(params, cache, tok, 40 + i)
            wants.append(want.cpu())
    del params, cache
    ranks = run_on_grid(_fsdp_card_rank, (2, 2), cfg, batch, fed, max_len,
                        device="cuda", timeout=300)
    for res in ranks:
        assert res["launches"] == cfg.num_layers
        if torch.cuda.device_count() < 4:
            assert res["peer_copies"]
        assert res["gathers"] == steps * cfg.num_layers
        for got, ref in zip(res["logits"], wants):
            got = torch.from_numpy(got)
            bound = 1e-3 * float(ref.abs().max())
            assert float((got - ref).abs().max()) <= bound
            top2 = ref.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > bound
            assert torch.equal(got.argmax(-1)[sure], ref.argmax(-1)[sure])


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b",
                                  "whisper-large-v3"])
def test_tp_serving_of_ssm_hybrid_encdec_on_one_card(cuda, arch):
    """tp = 2 ranks of the SSM, hybrid and encoder-decoder smoke models
    sharing the card against the one-process model on the same seeded
    weights, both through the flash kernel with a float32 cache (an SSM
    prompt of two 16-token chunks: the chunked scan): every rank's logits
    within 1e-5 x max|logit|, greedy tokens equal where the top-2 margin
    exceeds twice that, the flash launches of a prefill on each rank (one
    a zamba2 invocation, three a whisper layer pair, none for mamba2)."""

    from repro_torch.config import MeshConfig
    from repro_torch.launch.gossip import run_on_grid
    from repro_torch.train.shard import init_shard

    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(0)
    B, L, steps = 4, 32, 3
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, L))}
    if cfg.family == "encdec":
        batch = {"frames": rng.normal(size=(
            B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32),
            **batch}
    max_len = L + steps
    one = build_model(cfg, Ctx(attn_impl="kernel", cache_dtype=torch.float32),
                      device=cuda)
    params = init_shard(0, cfg, None, MeshConfig(data=1, model=1, fsdp=False),
                        0, cuda)
    with torch.inference_mode():
        want, cache = one.prefill(params, batch, max_len)
        wants, fed = [want.cpu()], []
        for i in range(steps):
            tok = want.argmax(-1).to(torch.int32)
            fed.append(tok.cpu())
            want, cache = one.decode(params, cache, tok, L + i)
            wants.append(want.cpu())
    del params, cache
    ranks = run_on_grid(_tp_card_rank, (1, 2), cfg, batch, fed, max_len, 2,
                        device="cuda", timeout=300)
    launches = (cfg.num_layers // cfg.shared_attn_every
                if cfg.family == "hybrid" else 0 if cfg.family == "ssm"
                else cfg.encoder_layers + 2 * cfg.num_layers)
    for res in ranks:
        assert res["launches"] == launches
        for got, ref in zip(res["logits"], wants):
            got = torch.from_numpy(got)
            bound = 1e-5 * float(ref.abs().max())
            assert float((got - ref).abs().max()) <= bound
            top2 = ref.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > 2 * bound
            assert torch.equal(got.argmax(-1)[sure], ref.argmax(-1)[sure])


def test_tp_serving_of_mqa_on_one_card(cuda):
    """granite-34b's smoke model (8 query heads over one KV head) on tp = 2
    ranks sharing the card, its KV cache cut on its sequence (36 positions,
    18 a rank: the decode steps write 16-19, across the boundary), against
    the one-process model on the same seeded weights, both through the
    flash kernel with a float32 cache: every rank's logits within 1e-5 x
    max|logit|, greedy tokens equal where the top-2 margin exceeds twice
    that, one flash launch a layer on each rank."""

    from repro_torch.config import MeshConfig
    from repro_torch.launch.gossip import run_on_grid
    from repro_torch.train.shard import init_shard

    cfg = get_smoke_config("granite-34b")
    rng = np.random.default_rng(0)
    B, L, steps, max_len = 4, 16, 4, 36
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, L))}
    one = build_model(cfg, Ctx(attn_impl="kernel", cache_dtype=torch.float32),
                      device=cuda)
    params = init_shard(0, cfg, None, MeshConfig(data=1, model=1, fsdp=False),
                        0, cuda)
    with torch.inference_mode():
        want, cache = one.prefill(params, batch, max_len)
        wants, fed = [want.cpu()], []
        for i in range(steps):
            tok = want.argmax(-1).to(torch.int32)
            fed.append(tok.cpu())
            want, cache = one.decode(params, cache, tok, L + i)
            wants.append(want.cpu())
    del params, cache
    ranks = run_on_grid(_tp_card_rank, (1, 2), cfg, batch, fed, max_len, 2,
                        device="cuda", timeout=300)
    for res in ranks:
        assert res["launches"] == cfg.num_layers
        for got, ref in zip(res["logits"], wants):
            got = torch.from_numpy(got)
            bound = 1e-5 * float(ref.abs().max())
            assert float((got - ref).abs().max()) <= bound
            top2 = ref.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > 2 * bound
            assert torch.equal(got.argmax(-1)[sure], ref.argmax(-1)[sure])


def test_committed_method_sweep_is_the_cards(cuda):
    """The sweep ``resolve_method(None, cuda)`` reads was written on a card
    by ``launch/serving_traffic.py --quant --json`` at the Table 3 cell."""

    import json
    import pathlib

    from repro_torch.kernels.quant import autotune

    data = json.loads(pathlib.Path(autotune.SWEEP_PATH).read_text())
    assert data["backend"] == "cuda"
    assert set(data["method_sweep_ms"]) == set(autotune.METHODS)
    assert set(data["method_sweep_spread_ms"]) == set(autotune.METHODS)
    assert data["machine"]["card"]["power_limit"]
    assert autotune.resolve_method(None, cuda) == min(
        data["method_sweep_ms"], key=data["method_sweep_ms"].get)


def test_serving_traffic_quant_gate_holds_on_the_card(cuda):
    from repro_torch.launch import serving_traffic

    quant_ops.dequant_score.launches = 0
    payload = serving_traffic.main([
        "--users", "600", "--items", "400", "--rank", "16", "--requests",
        "30", "--rate", "1000", "--buckets", "8,32", "--quant",
        "--quant-method", "fused"])
    assert payload["overlap_at_k"] >= serving_traffic.OVERLAP_GATE
    assert payload["quant"]["method"] == "fused"
    assert payload["quant"]["compiles"] == 2
    assert quant_ops.dequant_score.launches > 0
    assert all(ms > 0 for ms in payload["method_sweep_ms"].values())
