"""The port's multi-head latent attention against the JAX package's, on
the CPU.

Parameters come from JAX ``init_mla`` (through
``convert.lm_params_from_numpy``), activations are numpy draws.  Two MLA
shapes: deepseek-v2-lite-16b's smoke config (kv_lora 32, rope 8, nope 16,
v 16) and its published head dims (kv_lora 512, rope 64, nope 128, v 128:
q.k over D = 192, V of 128) with two heads.  Held: ``mla_attention`` (the
JAX side with ``impl="kernel"``, its Pallas kernel in interpret mode, and
``"ref"``; the port's ``"kernel"``, its plain version on CPU tensors),
``mla_prefill`` output and latent cache, and the absorbed ``mla_decode``
from the JAX cache handed across, with an f32 and a bf16 cache.

Tolerances, as ``tests/test_torch_lm.py`` states them: float32 values at
rtol 1e-4 with atol 1e-5 x max|JAX value|; bf16 cache entries and the
decode output from a bf16 cache at atol 2^-7 x max|JAX value| (a last-bit
f32 difference can move an entry's bf16 rounding by one ulp, 2^-8
relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import MLAConfig as JMLAConfig  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from repro_torch.config import MLAConfig  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    kv_cache_from_numpy,
    lm_params_from_numpy,
)
from repro_torch.models import mla as TMLA  # noqa: E402

torch.set_num_threads(2)

B, L, MAX_LEN = 2, 24, 40
# (d_model, heads, kv_lora, rope, nope, v)
SHAPES = {"smoke": (64, 4, 32, 8, 16, 16),
          "published_heads": (256, 2, 512, 64, 128, 128)}


def setup(shape):
    d, H, r, dr, dn, dv = SHAPES[shape]
    kw = dict(kv_lora_rank=r, qk_rope_head_dim=dr, qk_nope_head_dim=dn,
              v_head_dim=dv)
    jcfg, tcfg = JMLAConfig(**kw), MLAConfig(**kw)
    jp = jax.tree.map(np.asarray, JMLA.init_mla(
        jax.random.PRNGKey(0), d, H, jcfg, jnp.float32))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, L, d)).astype(np.float32)
    x1 = rng.normal(size=(B, 1, d)).astype(np.float32)
    return jcfg, tcfg, H, jp, lm_params_from_numpy(jp, "cpu"), x, x1


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, rtol=1e-4, atol_scale=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * float(np.abs(want).max()))


@pytest.mark.parametrize("j_impl", ["kernel", "ref"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_mla_attention_matches_jax(shape, j_impl):
    jcfg, tcfg, H, jp, tp, x, _ = setup(shape)
    want = JMLA.mla_attention(jp, x, num_heads=H, cfg=jcfg, impl=j_impl)
    got = TMLA.mla_attention(tp, t(x), num_heads=H, cfg=tcfg, impl="kernel")
    assert got.shape == want.shape
    close(got, want)
    close(TMLA.mla_attention(tp, t(x), num_heads=H, cfg=tcfg, impl="ref"),
          want)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_mla_prefill_and_absorbed_decode_match_jax(shape, cache_dtype):
    jcfg, tcfg, H, jp, tp, x, x1 = setup(shape)
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    c_atol = 2.0 ** -7 if cache_dtype == "bfloat16" else 1e-5

    jo, jc = JMLA.mla_prefill(jp, x, MAX_LEN, num_heads=H, cfg=jcfg,
                              cache_dtype=jdt, impl="ref")
    to, tc = TMLA.mla_prefill(tp, t(x), MAX_LEN, num_heads=H, cfg=tcfg,
                              cache_dtype=tdt, impl="kernel")
    close(to, jo)
    assert isinstance(tc, TMLA.MLACache)
    for got, want in zip(tc, jc):
        assert got.dtype == tdt and got.shape == want.shape
        close(got, want, atol_scale=c_atol)
        assert not got[:, L:].any()          # padded to max_len with zeros

    # decode from the JAX cache handed across, so both start equal
    tc = kv_cache_from_numpy({"c": jax.tree.map(np.asarray, jc)}, "cpu")["c"]
    assert isinstance(tc, TMLA.MLACache)
    jo1, jc1 = JMLA.mla_decode(jp, x1, jc, L, num_heads=H, cfg=jcfg)
    to1, tc1 = TMLA.mla_decode(tp, t(x1), tc, L, num_heads=H, cfg=tcfg)
    close(to1, jo1, atol_scale=c_atol)
    for got, want in zip(tc1, jc1):
        close(got, want, atol_scale=c_atol)
    # written in place: the cache handed in holds the new position
    assert tc1.c_kv.data_ptr() == tc.c_kv.data_ptr()


def test_absorbed_decode_equals_the_expanded_attention():
    """The absorbed decode at position L equals the last row of the
    expanded (prefill) attention over L + 1 tokens, with an f32 cache."""

    _, tcfg, H, _, tp, x, x1 = setup("smoke")
    full = np.concatenate([x, x1], axis=1)
    want = TMLA.mla_attention(tp, t(full), num_heads=H, cfg=tcfg)[:, -1:]
    _, cache = TMLA.mla_prefill(tp, t(x), MAX_LEN, num_heads=H, cfg=tcfg,
                                cache_dtype=torch.float32)
    got, _ = TMLA.mla_decode(tp, t(x1), cache, L, num_heads=H, cfg=tcfg)
    close(got, want)
