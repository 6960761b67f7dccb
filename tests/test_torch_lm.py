"""The port's dense LM against the JAX package's, on the CPU, for the smoke
configs of the four dense archs.

The parameters come from JAX ``init`` and go through
``convert.lm_params_from_numpy``; prompts and activations are numpy draws
handed to both sides.  Held: the layer functions, ``attention_prefill``
(output and cache) and ``decode_attention`` with an f32 and a bf16 cache,
``lm_prefill`` logits and cache and ``lm_decode_step`` against JAX with
``attn_impl="kernel"`` (the Pallas kernel in interpret mode) and
``"ref"``, and ``ServeLoop.generate`` tokens against JAX's ``ServeLoop``
with a prompt of 40 tokens, longer than gemma2's smoke window of 16.

Tolerances, and why:
* float32 values at rtol 1e-4 with atol 1e-5 x max|JAX value|: both sides
  compute in float32 but sum matmuls in another order, and the Pallas
  kernel pads D and rescales q, so values agree to ~1e-6 of their scale;
  the atol covers entries near zero.
* bf16 cache entries and the decode output from a bf16 cache: atol
  2^-7 x max|JAX value|.  A last-bit f32 difference can flip the rounding
  of one entry to bf16, which moves it by one bf16 ulp (2^-8 relative).
* tokens: equal on every step whose JAX top-2 logit margin exceeds 1e-3,
  up to the first step of that row where it does not (after a near tie
  the two sides may rightly continue with other tokens).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import get_smoke_config as j_smoke  # noqa: E402
from repro.launch.lm_engine import ServeLoop as JServeLoop  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.api import Ctx as JCtx  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    kv_cache_from_numpy,
    lm_params_from_numpy,
)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch.lm_engine import ServeLoop  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

torch.set_num_threads(2)

ARCHS = ["gemma2-2b", "internlm2-20b", "qwen1.5-32b", "granite-34b"]
B, PROMPT, MAX_LEN, NEW = 2, 40, 64, 12
MARGIN = 1e-3


def close(got, want, rtol=1e-4, atol_scale=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * scale)


def t(a):
    return lm_params_from_numpy(np.asarray(a), "cpu")


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    model = j_build(j_smoke(arch), JCtx())
    params = model.init(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def prompt(seed=0, length=PROMPT):
    return np.random.default_rng(seed).integers(
        0, 512, (B, length)).astype(np.int32)


def sublayer0(tree, i=0):
    """Unit ``i``'s first sublayer of a stacked tree."""

    return jax.tree.map(lambda a: a[i], tree["units"]["s0"])


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_functions(arch):
    cfg = j_smoke(arch)
    _, npp = jax_params(arch)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, 7, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(cfg.d_model,)).astype(np.float32)
    close(TL.rms_norm(t(x), t(w), cfg.norm_eps), JL.rms_norm(x, w,
                                                             cfg.norm_eps))
    hd = cfg.resolved_head_dim
    xh = rng.normal(size=(B, 3, 7, hd)).astype(np.float32)
    pos = np.arange(100, 107, dtype=np.int32)
    close(TL.apply_rope(t(xh), t(pos), cfg.rope_theta),
          JL.apply_rope(xh, pos, cfg.rope_theta))
    big = (x * 40).astype(np.float32)
    close(TL.softcap(t(big), 30.0), JL.softcap(big, 30.0))
    mlp = sublayer0(npp)["mlp"]
    close(TL.mlp_swiglu(lm_params_from_numpy(mlp, "cpu"), t(x)),
          JL.mlp_swiglu(mlp, x))
    close(TL.unembed(t(x), t(npp["embed"]), True, 30.0),
          JL.unembed(x, npp["embed"], True, 30.0))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_prefill_and_decode(arch, cache_dtype):
    cfg = j_smoke(arch)
    attn = sublayer0(jax_params(arch)[1])["attn"]
    tattn = lm_params_from_numpy(attn, "cpu")
    window = cfg.sliding_window
    kw = dict(head_dim=cfg.resolved_head_dim, window=window,
              attn_softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta)
    # the port reads its head counts from the weights
    jkw = dict(kw, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, PROMPT, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    bf16_atol = 2.0 ** -7 if cache_dtype == "bfloat16" else 1e-5

    jo, jc = JA.attention_prefill(attn, x, MAX_LEN, impl="ref",
                                  cache_dtype=jdt, **jkw)
    to, tc = TA.attention_prefill(tattn, t(x), MAX_LEN, impl="kernel",
                                  cache_dtype=tdt, **kw)
    close(to, jo)
    assert tc.k.dtype == tdt and tc.k.shape == jc.k.shape
    close(tc.k, jc.k, atol_scale=bf16_atol)
    close(tc.v, jc.v, atol_scale=bf16_atol)

    # decode from the JAX cache handed across, so both start equal
    tc = kv_cache_from_numpy({"c": jax.tree.map(np.asarray, jc)}, "cpu")["c"]
    jo1, jc1 = JA.decode_attention(attn, x1, jc, PROMPT, **jkw)
    to1, tc1 = TA.decode_attention(tattn, t(x1), tc, PROMPT, **kw)
    close(to1, jo1, atol_scale=bf16_atol)
    close(tc1.k, jc1.k, atol_scale=bf16_atol)
    close(tc1.v, jc1.v, atol_scale=bf16_atol)


@pytest.mark.parametrize("j_impl", ["kernel", "ref"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_and_decode_step(arch, j_impl):
    jp, npp = jax_params(arch)
    jm = j_build(j_smoke(arch), JCtx(attn_impl=j_impl,
                                     cache_dtype=jnp.float32))
    tm = build_model(get_smoke_config(arch),
                     Ctx(attn_impl="kernel", cache_dtype=torch.float32),
                     device="cpu")
    tp = lm_params_from_numpy(npp, "cpu")
    tokens = prompt(3)
    n0 = flash_attention.launches
    jl, jc = jm.prefill(jp, {"tokens": tokens}, MAX_LEN)
    tl, tc = tm.prefill(tp, {"tokens": tokens}, MAX_LEN)
    assert flash_attention.launches == n0
    assert tl.shape == (B, 512)
    close(tl, jl)
    jtree = jax.tree.map(np.asarray, jc)
    for name in tc["units"]:
        close(tc["units"][name].k, jtree["units"][name].k)
        close(tc["units"][name].v, jtree["units"][name].v)

    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl1, jc1 = jm.decode(jp, jc, tok, PROMPT)
    tl1, tc1 = tm.decode(tp, tc, torch.from_numpy(tok), PROMPT)
    close(tl1, jl1)
    for name in tc1["units"]:
        close(tc1["units"][name].k, jc1["units"][name].k)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_loop_tokens(arch):
    jp, npp = jax_params(arch)
    jm = j_build(j_smoke(arch), JCtx(attn_impl="kernel"))
    tm = build_model(get_smoke_config(arch), Ctx(attn_impl="kernel"),
                     device="cpu")
    tokens = prompt(4)
    jloop = JServeLoop(jm, jp, B, MAX_LEN)
    want = np.asarray(jloop.generate({"tokens": tokens}, NEW))
    got = ServeLoop(tm, lm_params_from_numpy(npp, "cpu"), B,
                    MAX_LEN).generate({"tokens": tokens}, NEW)
    assert got.shape == (B, NEW) and got.dtype == torch.int32
    got = got.numpy()

    # JAX's logits along its own tokens, for the top-2 margins
    logits, cache = jm.prefill(jp, {"tokens": tokens}, MAX_LEN)
    margins = []
    for i in range(NEW):
        if i:
            logits, cache = jloop._decode(jp, cache, want[:, i - 1],
                                          PROMPT + i - 1)
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
    margins = np.stack(margins, axis=1)
    compared = 0
    for row in range(B):
        for i in range(NEW):
            if margins[row, i] <= MARGIN:
                break
            assert got[row, i] == want[row, i], (row, i)
            compared += 1
    assert compared >= B * NEW // 2


def test_entry_points_reject_unported():
    """Every arch of ``ARCHS`` loads and builds on the CPU at its smoke
    config; an unknown arch or family, an unported attention and a prompt
    past ``max_len`` raise."""

    import dataclasses

    from repro_torch.config import ARCHS as ALL_ARCHS
    from repro_torch.config import get_model_config

    for arch in ALL_ARCHS:
        assert get_model_config(arch).name == arch
        model = build_model(get_smoke_config(arch), device="cpu")
        assert model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="unknown arch"):
        get_model_config("whisper-tiny")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(get_smoke_config("gemma2-2b"),
                                        family="diffusion"), device="cpu")
    with pytest.raises(ValueError, match="flashref"):
        Ctx(attn_impl="flashref")
    loop = ServeLoop(build_model(get_smoke_config("gemma2-2b"),
                                 device="cpu"), None, B, 16)
    with pytest.raises(ValueError, match="max_len"):
        loop.generate({"tokens": np.zeros((B, 10), np.int32)}, 8)
