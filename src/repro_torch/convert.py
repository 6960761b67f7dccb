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
from repro_torch.models.attention import KVCache
from repro_torch.models.encdec import DecCache
from repro_torch.models.mla import MLACache
from repro_torch.models.ssm import SSMState
from repro_torch.optim import AdamWState, SGDState
from repro_torch.serve.quant import QuantizedRecommendIndex
from repro_torch.serve.recommend import RecommendIndex
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


def index_from_numpy(u, w, seen, device) -> RecommendIndex:
    """f32 ``RecommendIndex`` from (m, r) / (n, r) factors and the (m, S)
    seen table."""

    return RecommendIndex(_tensor(u, np.float32, device),
                          _tensor(w, np.float32, device),
                          _tensor(seen, np.int32, device))


def quantized_index_from_numpy(u_q, u_scale, w_q, w_scale, seen,
                               device) -> QuantizedRecommendIndex:
    """``QuantizedRecommendIndex`` from int8 codes, f32 scales and the
    seen table, field for field."""

    return QuantizedRecommendIndex(
        _tensor(u_q, np.int8, device), _tensor(u_scale, np.float32, device),
        _tensor(w_q, np.int8, device), _tensor(w_scale, np.float32, device),
        _tensor(seen, np.int32, device))


def _leaf(a, device) -> torch.Tensor:
    """A tensor from a numpy array of any dtype, bfloat16 included (numpy
    has no bfloat16 of its own: its bits go through uint16)."""

    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def lm_params_from_numpy(tree, device) -> dict:
    """The port's LM parameters from the JAX parameter tree as nested dicts
    of numpy arrays, field for field (same names, same stacked layout)."""

    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def opt_state_from_numpy(state, device):
    """The port's optimizer state (``AdamWState``/``SGDState``) from the
    JAX one with its leaves as numpy arrays, field for field: the step an
    int32 0-d tensor, the moments nested dicts of f32 tensors."""

    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=device)
    if hasattr(state, "mu"):
        return AdamWState(step, lm_params_from_numpy(state.mu, device),
                          lm_params_from_numpy(state.nu, device))
    mom = state.momentum
    return SGDState(step, lm_params_from_numpy(mom, device)
                    if isinstance(mom, dict) else ())


_CACHES = {cls._fields: cls for cls in (KVCache, MLACache, SSMState,
                                         DecCache)}


def kv_cache_from_numpy(tree, device):
    """The port's LM cache from the JAX cache tree: nested dicts and
    NamedTuples whose leaves are numpy arrays (an attention sublayer's
    ``KVCache`` (k, v), an MLA sublayer's ``MLACache`` (c_kv, k_rope), an
    SSM sublayer's ``SSMState`` (h, conv_x, conv_B, conv_C), the
    encoder-decoder's ``DecCache`` (self_kv, cross_k, cross_v) with a
    ``KVCache`` inside), each NamedTuple mapped by its field names to the
    port's class of the same fields (a pair with other names to a
    ``KVCache``); every leaf keeps its dtype."""

    if isinstance(tree, dict):
        return {k: kv_cache_from_numpy(v, device) for k, v in tree.items()}
    fields = getattr(tree, "_fields", None)
    if fields is None:
        return _leaf(tree, device)
    cls = _CACHES.get(fields, KVCache)
    return cls(*(kv_cache_from_numpy(a, device) for a in tree))
