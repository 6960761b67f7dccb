"""2-D grid decomposition of the input matrix (paper §2).

The m×n matrix ``X`` is decomposed into a p×q grid of blocks ``X_ij`` of
size (m/p)×(n/q); each block carries its own factors ``U_ij`` ((m/p)×r) and
``W_ij`` ((n/q)×r).  Gossip happens over L-shaped three-block *structures*:

    S_upper(i,j) = {(i,j), (i+1,j), (i,j+1)}   valid for i<p-1, j<q-1
    S_lower(i,j) = {(i,j), (i-1,j), (i,j-1)}   valid for i>0,  j>0

Within a structure, U-consensus couples the horizontal pair and W-consensus
couples the vertical pair (paper eq. 2).

This module is pure bookkeeping: structure enumeration, Fig.-2 selection
counts and their inverse normalization coefficients, and the parity *wave*
schedule that partitions the structures into non-overlapping sets (the
paper's "non overlapping structures can be processed in parallel" note).
Everything returns plain numpy; ``core/state.py`` turns the tables into
tensors on the problem's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

UPPER = 0
LOWER = 1


@dataclasses.dataclass(frozen=True)
class GridSpec:
    m: int
    n: int
    p: int
    q: int
    r: int

    def __post_init__(self) -> None:
        # fail here, with the fix spelled out, instead of deep inside
        # blockify / init_state with a shape error
        if self.r <= 0:
            raise ValueError(f"rank must be positive, got r={self.r}")
        if self.p <= 0 or self.q <= 0:
            raise ValueError(
                f"grid must have positive dimensions, got {self.p}x{self.q}"
            )
        if self.m <= 0 or self.n <= 0:
            raise ValueError(
                f"matrix must have positive dimensions, got {self.m}x{self.n}"
            )
        if self.p > self.m or self.q > self.n:
            raise ValueError(
                f"grid {self.p}x{self.q} has more blocks than matrix rows/cols "
                f"({self.m}x{self.n}); every block needs at least one row and "
                "one column — shrink p/q or use a bigger matrix"
            )
        if self.m % self.p or self.n % self.q:
            pm = (self.p - self.m % self.p) % self.p
            pn = (self.q - self.n % self.q) % self.q
            raise ValueError(
                f"grid {self.p}x{self.q} must divide matrix {self.m}x{self.n}; "
                f"pad to {self.m + pm}x{self.n + pn} first — "
                "grid.pad_to_grid(x, mask, p, q) or "
                "repro_torch.mc.CompletionProblem.from_dense(...) do this for you"
            )

    @property
    def mb(self) -> int:  # block rows
        return self.m // self.p

    @property
    def nb(self) -> int:  # block cols
        return self.n // self.q

    @property
    def num_structures(self) -> int:
        return 2 * (self.p - 1) * (self.q - 1)


def enumerate_structures(p: int, q: int) -> np.ndarray:
    """All valid structures as an array of (kind, pivot_i, pivot_j).

    Returns int32 array of shape (num_structures, 3).
    """

    out = []
    for i in range(p - 1):
        for j in range(q - 1):
            out.append((UPPER, i, j))
    for i in range(1, p):
        for j in range(1, q):
            out.append((LOWER, i, j))
    return np.asarray(out, dtype=np.int32)


def structure_blocks(kind: int, i: int, j: int) -> tuple[tuple[int, int], ...]:
    """The three (row, col) blocks of a structure: (pivot, vert, horiz).

    ``vert`` is the W-consensus partner (shares a vertical edge), ``horiz``
    the U-consensus partner (shares a horizontal edge).
    """

    if kind == UPPER:
        return ((i, j), (i + 1, j), (i, j + 1))
    return ((i, j), (i - 1, j), (i, j - 1))


def selection_counts(p: int, q: int) -> dict[str, np.ndarray]:
    """Exact Fig.-2 selection counts by enumeration.

    For every block: how many structure-sampled gradient contributions it
    receives for each term type (f, dU, dW).  The paper normalizes each
    block's contribution by the inverse of these counts so all blocks get
    equal representation in eq. (3).
    """

    f_cnt = np.zeros((p, q), dtype=np.int64)
    du_cnt = np.zeros((p, q), dtype=np.int64)
    dw_cnt = np.zeros((p, q), dtype=np.int64)
    for kind, i, j in enumerate_structures(p, q):
        pivot, vert, horiz = structure_blocks(kind, i, j)
        for b in (pivot, vert, horiz):
            f_cnt[b] += 1
        # U-consensus pair: pivot <-> horiz ; W-consensus pair: pivot <-> vert
        du_cnt[pivot] += 1
        du_cnt[horiz] += 1
        dw_cnt[pivot] += 1
        dw_cnt[vert] += 1
    return {"f": f_cnt, "dU": du_cnt, "dW": dw_cnt}


def pair_counts(p: int, q: int) -> dict[str, np.ndarray]:
    """How many structures touch each consensus pair.

    ``dU`` has shape (p, q-1): horizontal pair (i,j)-(i,j+1).
    ``dW`` has shape (p-1, q): vertical pair (i,j)-(i+1,j).
    """

    du = np.zeros((p, q - 1), dtype=np.int64)
    dw = np.zeros((p - 1, q), dtype=np.int64)
    for kind, i, j in enumerate_structures(p, q):
        if kind == UPPER:
            du[i, j] += 1
            dw[i, j] += 1
        else:  # LOWER pivot (i,j): U pair (i,j-1)-(i,j); W pair (i-1,j)-(i,j)
            du[i, j - 1] += 1
            dw[i - 1, j] += 1
    return {"dU": du, "dW": dw}


def _inv(c: np.ndarray) -> np.ndarray:
    coef = np.zeros_like(c, dtype=np.float64)
    nz = c > 0
    coef[nz] = 1.0 / c[nz]
    return coef


def normalization_coefficients(p: int, q: int) -> dict[str, np.ndarray]:
    """Inverse selection counts (the paper's normalization coefficients).

    ``f`` is per-block (p,q); ``dU``/``dW`` are per-*pair* (see
    objective.full_objective for why pair-normalization is the
    conservative-field reading of Fig. 2).
    """

    pc = pair_counts(p, q)
    return {
        "f": _inv(selection_counts(p, q)["f"]),
        "dU": _inv(pc["dU"]),
        "dW": _inv(pc["dW"]),
    }


# ---------------------------------------------------------------------------
# Wave schedule
# ---------------------------------------------------------------------------


def wave_schedule(p: int, q: int) -> list[np.ndarray]:
    """Partition all structures into waves of pairwise non-overlapping ones.

    Structures of the same kind whose pivots agree on (i mod 2, j mod 2) are
    block-disjoint, giving ≤8 waves (4 parity classes × 2 kinds).  Proof
    sketch: an upper structure occupies rows {i,i+1} × cols {j,j+1} minus one
    corner; two pivots in the same parity class differ by ≥2 in any
    coordinate they differ in, so their 2×2 bounding boxes are disjoint.

    Returns a list of (k,3) int32 arrays (kind, i, j).
    """

    structures = enumerate_structures(p, q)
    waves = []
    for kind in (UPPER, LOWER):
        for pi in (0, 1):
            for pj in (0, 1):
                sel = (
                    (structures[:, 0] == kind)
                    & (structures[:, 1] % 2 == pi)
                    & (structures[:, 2] % 2 == pj)
                )
                if sel.any():
                    waves.append(structures[sel])
    return waves


def assert_waves_disjoint(waves: list[np.ndarray], p: int, q: int) -> None:
    """Sanity check used by tests: blocks within a wave never repeat."""

    for wave in waves:
        seen: set[tuple[int, int]] = set()
        for kind, i, j in wave:
            for b in structure_blocks(int(kind), int(i), int(j)):
                if b in seen:
                    raise AssertionError(f"wave overlap at block {b}")
                seen.add(b)


def blockify(x: np.ndarray, mask: np.ndarray, spec: GridSpec) -> tuple[np.ndarray, np.ndarray]:
    """Reshape (m,n) [+ mask] into (p, q, mb, nb) block tensors."""

    m, n, p, q = spec.m, spec.n, spec.p, spec.q
    xb = x.reshape(p, spec.mb, q, spec.nb).transpose(0, 2, 1, 3)
    mb = mask.reshape(p, spec.mb, q, spec.nb).transpose(0, 2, 1, 3)
    return np.ascontiguousarray(xb), np.ascontiguousarray(mb)


def unblockify(xb: np.ndarray, spec: GridSpec) -> np.ndarray:
    """Inverse of :func:`blockify` for (p,q,mb,nb) tensors."""

    return np.ascontiguousarray(
        xb.transpose(0, 2, 1, 3).reshape(spec.m, spec.n)
    )


def pad_to_grid(
    x: np.ndarray, mask: np.ndarray, p: int, q: int
) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Zero-pad (with mask=0) so p|m and q|n.  Returns padded arrays + new m,n."""

    m, n = x.shape
    mp = (p - m % p) % p
    np_ = (q - n % q) % q
    if mp or np_:
        x = np.pad(x, ((0, mp), (0, np_)))
        mask = np.pad(mask, ((0, mp), (0, np_)))
    return x, mask, m + mp, n + np_
