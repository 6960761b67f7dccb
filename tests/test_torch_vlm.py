"""The port's VLM (internvl2-76b) against the JAX package's, on the CPU,
at the smoke config: 3 dense layers of d_model 128, 8 query heads of 16
over 2 KV heads, 8 stub patch tokens of width 1024 before the text.

Parameters come from JAX ``init`` through ``convert.lm_params_from_numpy``;
caches cross through ``convert.kv_cache_from_numpy``; patches and tokens
are numpy draws.  Held: the projector's ``_fuse`` (the tanh GELU);
``prefill`` logits and cache, against JAX with ``attn_impl="kernel"``
(the Pallas kernel in interpret mode) and ``"ref"``; decode steps at
absolute positions in the fused sequence, after each side's prefill and
from JAX's cache; ``ServeLoop.generate`` with the patch offset; ``loss``
(text positions only) and every gradient leaf against
``jax.value_and_grad`` with remat on and off; the port's own prefill +
decode against a full forward, as ``tests/test_models_consistency.py``
holds JAX's.

Tolerances, as ``tests/test_torch_lm.py`` and ``tests/test_torch_train.py``
state them: float32 values at rtol 1e-4 with atol 1e-5 x max|JAX value|;
bfloat16 cache entries and logits decoded from a bfloat16 cache at atol
2^-7 x max|JAX value|; the loss at rel 1e-5, each gradient leaf within
1e-4 x max|JAX leaf|; tokens equal on every step whose JAX top-2 logit
margin exceeds 1e-3, up to a row's first step where it does not.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import get_smoke_config as j_smoke  # noqa: E402
from repro.launch.lm_engine import ServeLoop as JServeLoop  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import vlm as JV  # noqa: E402
from repro.models.api import Ctx as JCtx  # noqa: E402
from repro_torch.config import get_model_config  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    kv_cache_from_numpy,
    lm_params_from_numpy,
)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch.lm_engine import ServeLoop  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.models import vlm as V  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402

torch.set_num_threads(2)

ARCH = "internvl2-76b"
B, PROMPT, NEW = 2, 12, 8
PATCHES = 8                           # the smoke config's num_patch_tokens
MAX_LEN = PATCHES + PROMPT + NEW - 1  # the generate's positions, exactly
TOKEN_MARGIN = 1e-3
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def close(got, want, rtol=1e-4, atol_scale=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * float(np.abs(want).max()))


def cfgs():
    return j_smoke(ARCH), get_smoke_config(ARCH)


@functools.lru_cache(maxsize=None)
def jax_params():
    npp = jax.tree.map(np.asarray, j_build(cfgs()[0], JCtx()).init(
        jax.random.PRNGKey(0)))
    return jax.tree.map(jnp.asarray, npp), npp


def batch(seed, length=PROMPT):
    rng = np.random.default_rng(seed)
    return {"patches": rng.normal(size=(B, PATCHES, 1024)).astype(
                np.float32),
            "tokens": rng.integers(0, 512, (B, length)).astype(np.int32)}


def held_caches(got, want, atol_scale=1e-5):
    """Every cache of the port's tree against JAX's, type and dtype
    included (bfloat16 leaves at the 2^-7 rule)."""

    if isinstance(got, dict):
        assert set(got) == set(want)
        for name in got:
            held_caches(got[name], want[name], atol_scale)
        return
    assert isinstance(got, KVCache) and type(got)._fields == want._fields
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert str(g.dtype).split(".")[-1] == w.dtype.name
        assert tuple(g.shape) == w.shape
        bf16 = g.dtype == torch.bfloat16
        close(g, w.astype(np.float32),
              atol_scale=2.0 ** -7 if bf16 else atol_scale)


def test_fuse_matches_jax():
    """The projected patches before the token embeddings; the projector's
    GELU is the tanh form (``jax.nn.gelu``'s default)."""

    jp, npp = jax_params()
    jcfg, tcfg = cfgs()
    b = batch(1)
    want = JV._fuse(jp, jnp.asarray(b["patches"]), jnp.asarray(b["tokens"]),
                    jcfg, JCtx())
    tp = lm_params_from_numpy(npp, "cpu")
    got = V._fuse(tp, torch.from_numpy(b["patches"]),
                  torch.from_numpy(b["tokens"]).long(), tcfg)
    assert got.shape == (B, PATCHES + PROMPT, tcfg.d_model)
    close(got, want)
    proj = tp["projector"]
    erf = torch.nn.functional.gelu(torch.from_numpy(b["patches"])
                                   @ proj["w1"]) @ proj["w2"]
    with pytest.raises(AssertionError):
        close(erf, np.asarray(want)[:, :PATCHES])


@pytest.mark.parametrize("j_impl", ["kernel", "ref"])
def test_prefill_and_decode_at_absolute_positions(j_impl):
    """prefill logits and cache (float32 on both sides), then three decode
    steps at positions P + L, P + L + 1, ..."""

    jp, npp = jax_params()
    jm = j_build(cfgs()[0], JCtx(attn_impl=j_impl, cache_dtype=jnp.float32))
    tm = build_model(cfgs()[1],
                     Ctx(attn_impl="kernel", cache_dtype=torch.float32),
                     device="cpu")
    tp = lm_params_from_numpy(npp, "cpu")
    b = batch(3)
    n0 = flash_attention.launches
    jl, jc = jm.prefill(jp, b, MAX_LEN)
    tl, tc = tm.prefill(tp, b, MAX_LEN)
    assert flash_attention.launches == n0          # CPU: the plain version
    assert tl.shape == (B, 512)
    close(tl, jl)
    held_caches(tc, jax.tree.map(np.asarray, jc))
    toks = np.random.default_rng(4).integers(0, 512, (3, B)).astype(np.int32)
    for i, tok in enumerate(toks):
        jl, jc = jm.decode(jp, jc, tok, PATCHES + PROMPT + i)
        tl, tc1 = tm.decode(tp, tc, torch.from_numpy(tok),
                            PATCHES + PROMPT + i)
        assert tc1 is tc                           # written in place
        close(tl, jl)
    held_caches(tc, jax.tree.map(np.asarray, jc))


def test_decode_from_the_jax_cache():
    """Decode steps from JAX's prefill cache (default bfloat16) handed
    across, at absolute positions."""

    jp, npp = jax_params()
    jm = j_build(cfgs()[0], JCtx())
    tm = build_model(cfgs()[1], device="cpu")
    b = batch(5)
    jl, jc = jm.prefill(jp, b, MAX_LEN)
    jtree = jax.tree.map(np.asarray, jc)
    tc = kv_cache_from_numpy(jtree, "cpu")
    assert tc["units"]["s0"].k.dtype == torch.bfloat16
    held_caches(tc, jtree)
    tp = lm_params_from_numpy(npp, "cpu")
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for i in range(3):
        jl, jc = jm.decode(jp, jc, tok, PATCHES + PROMPT + i)
        tl, tc = tm.decode(tp, tc, torch.from_numpy(tok),
                           PATCHES + PROMPT + i)
        close(tl, jl, atol_scale=2.0 ** -7)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


@pytest.mark.parametrize("j_impl", ["kernel", "ref"])
def test_serve_loop_tokens_with_the_patch_offset(j_impl):
    jp, npp = jax_params()
    jm = j_build(cfgs()[0], JCtx(attn_impl=j_impl))
    tm = build_model(cfgs()[1], Ctx(attn_impl="kernel"), device="cpu")
    b = batch(4)
    jloop = JServeLoop(jm, jp, B, MAX_LEN)
    want = np.asarray(jloop.generate(b, NEW))
    loop = ServeLoop(tm, lm_params_from_numpy(npp, "cpu"), B, MAX_LEN)
    got = loop.generate(b, NEW)
    assert got.shape == (B, NEW) and got.dtype == torch.int32
    got = got.numpy()

    # JAX's logits along its own tokens, for the top-2 margins
    logits, cache = jm.prefill(jp, b, MAX_LEN)
    margins = []
    for i in range(NEW):
        if i:
            logits, cache = jloop._decode(jp, cache, want[:, i - 1],
                                          PATCHES + PROMPT + i - 1)
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
    margins = np.stack(margins, axis=1)
    compared = 0
    for row in range(B):
        for i in range(NEW):
            if margins[row, i] <= TOKEN_MARGIN:
                break
            assert got[row, i] == want[row, i], (row, i)
            compared += 1
    assert compared >= B * NEW // 2

    # the guard counts the patch positions: one more token would not fit
    with pytest.raises(ValueError, match="max_len"):
        loop.generate(b, NEW + 1)


def jax_paths(tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield tuple(k.key for k in path), np.asarray(leaf)


def at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_every_gradient_match_jax(remat):
    """16 text tokens a row after the patches; the last row's last 4
    targets are padding."""

    jp, npp = jax_params()
    jm = j_build(cfgs()[0], JCtx())
    rng = np.random.default_rng(1)
    b = batch(2, 16)
    b["targets"] = rng.integers(0, 512, (B, 16)).astype(np.int32)
    b["targets"][-1, -4:] = -1
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, b)
    tm = build_model(cfgs()[1], Ctx(remat=remat), device="cpu")
    tp = lm_params_from_numpy(npp, "cpu")
    tl, tg = loss_and_grads(tm.loss, tp, [b])
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    n = 0
    for keys, g in jax_paths(jg):
        got = at(tg, keys).numpy()
        err = float(np.abs(got - g).max())
        assert err <= GRAD_TOL * float(np.abs(g).max()), (keys, err)
        n += 1
    assert n == len(tree_leaves(tg))
    assert float(np.abs(np.asarray(jg["projector"]["w1"])).max()) > 0


def test_prefill_and_decode_equal_a_full_forward():
    """prefill(patches + 12 tokens) + decode(token) at position P + 12
    equals a fresh prefill over patches + 13 tokens, in the port alone
    (f32 cache)."""

    _, npp = jax_params()
    tm = build_model(cfgs()[1], Ctx(cache_dtype=torch.float32),
                     device="cpu")
    tp = lm_params_from_numpy(npp, "cpu")
    b = batch(6)
    _, cache = tm.prefill(tp, b, MAX_LEN)
    nxt = np.random.default_rng(7).integers(0, 512, B).astype(np.int32)
    got, _ = tm.decode(tp, cache, torch.from_numpy(nxt), PATCHES + PROMPT)
    want, _ = tm.prefill(tp, dict(b, tokens=np.concatenate(
        [b["tokens"], nxt[:, None]], axis=1)), MAX_LEN)
    close(got, want.numpy())


def test_full_config_and_init_cache():
    cfg = get_model_config(ARCH)
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.num_patch_tokens) == ("vlm", 80, 8192, 64,
                                                        8, 256)
    jc = j_build(cfgs()[0], JCtx()).init_cache(B, MAX_LEN)
    tc = build_model(cfgs()[1], device="cpu").init_cache(B, MAX_LEN)
    held_caches(tc, jax.tree.map(np.asarray, jc))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(cfg)
