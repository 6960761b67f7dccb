"""The port's flash attention against the JAX package's, on the CPU.

The same numpy inputs go to JAX ``flash_attention`` (the Pallas kernel in
interpret mode, as ``tests/test_kernel_flash_attention.py`` runs it), to
JAX ``attention_ref``, and to the port's ``flash_attention`` on CPU
tensors, which runs its plain version ``attention_ref``.

Tolerances are the JAX file's own: rtol 2e-4 and atol 2e-5 in float32
(the frameworks sum the logits and P.V in other orders, and the Pallas
kernel pads D to 128 and rescales q), and a max abs error of 5e-2 in
bfloat16 (the output is rounded to bf16, ~4e-3 relative, on O(1) values).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import attention_ref as j_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref,
    flash_attention,
)

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-5

# the seven CASES of tests/test_kernel_flash_attention.py
CASES = [
    dict(B=1, Hq=2, Hkv=2, Lq=128, Lk=128, D=64),
    dict(B=2, Hq=8, Hkv=2, Lq=256, Lk=256, D=64, causal=True),
    dict(B=1, Hq=4, Hkv=4, Lq=100, Lk=100, D=32, causal=False),
    dict(B=1, Hq=4, Hkv=2, Lq=300, Lk=300, D=64, causal=True, window=128),
    dict(B=1, Hq=2, Hkv=1, Lq=256, Lk=256, D=128, causal=True, softcap=50.0),
    dict(B=1, Hq=2, Hkv=2, Lq=17, Lk=450, D=64, causal=True, q_offset=433),
    dict(B=1, Hq=6, Hkv=3, Lq=64, Lk=64, D=80, causal=True),
]


def _rand(B, Hq, Hkv, Lq, Lk, D, Dv=None, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, Lq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Lk, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Lk, Dv or D)).astype(np.float32)
    return q, k, v


def _port(q, k, v, **kw):
    n0 = flash_attention.launches
    # copies: no buffer is shared between the port's tensors and JAX
    out = flash_attention(*(torch.from_numpy(a.copy()) for a in (q, k, v)),
                          **kw)
    assert flash_attention.launches == n0      # CPU: the plain version
    return out.numpy()


def _split(case):
    case = dict(case)
    dims = [case.pop(n) for n in ("B", "Hq", "Hkv", "Lq", "Lk", "D")]
    return dims, case


@pytest.mark.parametrize("case", CASES)
def test_matches_jax_kernel_and_reference(case):
    dims, kw = _split(case)
    q, k, v = _rand(*dims)
    got = _port(q, k, v, **kw)
    for name, fn in (("Pallas interpret", j_flash), ("attention_ref", j_ref)):
        want = fn(q.copy(), k.copy(), v.copy(), **kw)
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL,
                                   err_msg=f"port vs JAX {name}")


def _f64_attention(q, k, v, causal=True, **_):
    """The same attention in float64 numpy (global, no softcap)."""

    q, k, v = (a.astype(np.float64) for a in (q, k, v))
    group = q.shape[1] // k.shape[1]
    k, v = (np.repeat(a, group, axis=1) for a in (k, v))
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        Lq, Lk = logits.shape[-2:]
        keep = np.arange(Lq)[:, None] >= np.arange(Lk)[None, :]
        logits = np.where(keep, logits, -np.inf)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("side", ["port", "Pallas interpret",
                                  "attention_ref"])
def test_case0_each_side_against_float64(side):
    """Which side of ``test_matches_jax_kernel_and_reference[case0]``
    moved, should it fail again: each output against a float64 oracle, to
    the same tolerance."""

    dims, kw = _split(CASES[0])
    q, k, v = _rand(*dims)
    if side == "port":
        got = _port(q, k, v, **kw)
    else:
        fn = j_flash if side == "Pallas interpret" else j_ref
        got = np.asarray(fn(q.copy(), k.copy(), v.copy(), **kw))
    want = _f64_attention(q, k, v, **kw)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=f"JAX {side} vs float64"
                               if side != "port" else "port vs float64")


def test_separate_v_dim_mla():
    q, k, v = _rand(1, 4, 4, 64, 64, 192, Dv=128)
    got = _port(q, k, v, causal=True)
    assert got.shape == (1, 4, 64, 128)
    for want in (j_flash(q, k, v, causal=True), j_ref(q, k, v, causal=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_bf16():
    q, k, v = _rand(1, 4, 2, 256, 256, 64)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for want in (j_flash(jq, jk, jv, causal=True),
                 j_ref(jq, jk, jv, causal=True)):
        err = np.abs(got - np.asarray(want, np.float32)).max()
        assert err < 5e-2


# seeded draws over B, Hkv, group, Lq, Lk, D and causal, the ranges of the
# JAX file's property test (causal needs Lq <= Lk: no fully masked row)
_RNG = np.random.default_rng(2024)
PROPERTY = [
    (int(_RNG.integers(1, 4)), int(_RNG.integers(1, 5)),
     int(_RNG.integers(1, 5)), int(_RNG.integers(1, 97)),
     int(_RNG.integers(1, 97)), int(_RNG.choice([16, 32, 64])),
     bool(_RNG.integers(0, 2)))
    for _ in range(12)
]


@pytest.mark.parametrize("B,Hkv,group,Lq,Lk,D,causal", PROPERTY)
def test_property_random(B, Hkv, group, Lq, Lk, D, causal):
    if causal and Lq > Lk:
        Lq = Lk
    q, k, v = _rand(B, Hkv * group, Hkv, Lq, Lk, D, seed=Lq * 97 + Lk)
    got = _port(q, k, v, causal=causal)
    want = j_flash(q, k, v, causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=3e-5)
    np.testing.assert_allclose(
        got, attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                           causal=causal).numpy(), rtol=0, atol=0)


def test_rejects_heads_that_do_not_group():
    q, k, v = (torch.from_numpy(a) for a in _rand(1, 3, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="Hkv"):
        flash_attention(q, k, v)
