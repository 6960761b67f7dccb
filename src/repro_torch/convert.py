"""Carry state and data across from numpy arrays.

The port and the JAX package cannot share random streams (threefry and
torch's generators differ), so a comparison hands both the same arrays.
These helpers build the port's containers from numpy on an explicit
device and back; they never touch a JAX object (the caller converts with
``np.asarray``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.state import Problem, State
from repro_torch.sparse.entries import BlockEntries
from repro_torch.sparse.store import SparseProblem


def _tensor(a, dtype, device) -> torch.Tensor:
    # a copy: arrays exported by other frameworks may be read-only
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)


def state_from_numpy(U, W, t, device) -> State:
    """``State`` from (p,q,mb,r) / (p,q,nb,r) factors and a step count."""

    return State(_tensor(U, np.float32, device), _tensor(W, np.float32, device),
                 torch.tensor(int(t), dtype=torch.int32, device=device))


def state_to_numpy(state: State) -> tuple[np.ndarray, np.ndarray, int]:
    return (state.U.cpu().numpy(), state.W.cpu().numpy(), int(state.t))


def problem_from_numpy(xb, maskb, device) -> Problem:
    """Dense ``Problem`` from blockified (p,q,mb,nb) value/mask arrays."""

    return Problem(_tensor(xb, np.float32, device),
                   _tensor(maskb, np.float32, device))


def sparse_problem_from_numpy(rows, cols, vals, valid, col_perm, row_ptr,
                              col_ptr, nnz, device) -> SparseProblem:
    """``SparseProblem`` from the store's arrays, field for field."""

    i32, f32 = np.int32, np.float32
    entries = BlockEntries(
        _tensor(rows, i32, device), _tensor(cols, i32, device),
        _tensor(vals, f32, device), _tensor(valid, f32, device),
        _tensor(col_perm, i32, device), _tensor(row_ptr, i32, device),
        _tensor(col_ptr, i32, device),
    )
    return SparseProblem(entries, _tensor(nnz, i32, device))
