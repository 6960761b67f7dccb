"""The port's encoder-decoder (whisper-large-v3) against the JAX package's,
on the CPU, at the smoke config: 2 encoder layers over 30 stub frames, 3
decoder layers, d_model 128, 4 heads of 32.

Parameters come from JAX ``init`` through ``convert.lm_params_from_numpy``
with every bias and LayerNorm leaf (zeros and ones at init) redrawn from a
numpy seed first, so that each is exercised; caches cross through
``convert.kv_cache_from_numpy``; frames and tokens are numpy draws.  Held:
``layer_norm`` and the tanh ``mlp_gelu``; ``_sinusoid``; ``encode``;
``prefill`` logits and every ``DecCache`` field with its dtype, against
JAX with ``attn_impl="kernel"`` (the Pallas kernel in interpret mode) and
``"ref"``; a decode step after the port's own prefill and from JAX's
prefill cache, with bfloat16 and float32 caches; ``ServeLoop.generate``
tokens; ``loss`` and every gradient leaf against ``jax.value_and_grad``
with remat on and off; the port's own prefill + decode against a full
forward, as ``tests/test_models_consistency.py`` holds JAX's.

Tolerances, as ``tests/test_torch_lm.py`` and ``tests/test_torch_train.py``
state them: float32 values at rtol 1e-4 with atol 1e-5 x max|JAX value|;
bfloat16 cache entries, and logits decoded from a bfloat16 cache the port
filled itself, at atol 2^-7 x max|JAX value|; logits decoded from JAX's own
bfloat16 cache at the float32 rule, since both sides then round the same
query and probabilities to bfloat16 from the same cache; the loss at rel
1e-5, each gradient leaf within 1e-4 x max|JAX leaf|; tokens equal on
every step whose JAX top-2 logit margin exceeds 1e-3, up to a row's first
step where it does not.
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
from repro.models import encdec as JED  # noqa: E402
from repro.models import layers as JL  # noqa: E402
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
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402

torch.set_num_threads(2)

ARCH = "whisper-large-v3"
B, PROMPT, MAX_LEN, NEW = 2, 12, 24, 8
TOKEN_MARGIN = 1e-3
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
BIAS_STD = 0.2      # biases and LayerNorm offsets, redrawn from zero
CACHES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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
    """JAX ``init``'s parameters, biases and LayerNorm leaves redrawn from
    a numpy seed, as a JAX tree and as numpy."""

    npp = jax.tree.map(np.asarray, j_build(cfgs()[0], JCtx()).init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)

    def redraw(tree):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                redraw(leaf)
            elif name in ("bq", "bk", "bv", "bi", "bo", "b"):
                tree[name] = (rng.normal(size=leaf.shape)
                              * BIAS_STD).astype(np.float32)
            elif name == "w":                          # LayerNorm scales
                tree[name] = (1.0 + rng.normal(size=leaf.shape)
                              * BIAS_STD).astype(np.float32)

    redraw(npp)
    return jax.tree.map(jnp.asarray, npp), npp


def batch(seed, length=PROMPT):
    rng = np.random.default_rng(seed)
    cfg = cfgs()[1]
    return {"frames": rng.normal(size=(B, cfg.encoder_seq_len,
                                       cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size,
                                   (B, length)).astype(np.int32)}


def held_caches(got, want, atol_scale=1e-5):
    """The port's cache tree against JAX's, recursing into NamedTuples,
    type and dtype included (bfloat16 leaves at the 2^-7 rule)."""

    if hasattr(want, "_fields"):
        assert type(got)._fields == want._fields
        for g, w in zip(got, want):
            held_caches(g, w, atol_scale)
        return
    w = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == w.dtype.name
    assert tuple(got.shape) == w.shape
    bf16 = got.dtype == torch.bfloat16
    close(got, w.astype(np.float32),
          atol_scale=2.0 ** -7 if bf16 else atol_scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_mlp_gelu_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3 + 1
    w = (1 + 0.3 * rng.normal(size=64)).astype(np.float32)
    b = (0.3 * rng.normal(size=64)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = JL.layer_norm(jx, jnp.asarray(w), jnp.asarray(b))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = L.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == tx.dtype
    if dtype == "float32":
        close(got, want)
    else:
        close(got, np.asarray(want.astype(jnp.float32)), rtol=0,
              atol_scale=2.0 ** -7)

    # pre-activations of unit scale, where the two GELU forms differ most
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    mlp = {"wi": rng.normal(size=(64, 96)) / 8, "bi": rng.normal(size=96),
           "wo": rng.normal(size=(96, 64)) / 8, "bo": rng.normal(size=64)}
    mlp = {k: v.astype(np.float32) for k, v in mlp.items()}
    want = JL.mlp_gelu({k: jnp.asarray(v) for k, v in mlp.items()},
                       jnp.asarray(x))
    tm = lm_params_from_numpy(mlp, "cpu")
    close(L.mlp_gelu(tm, torch.from_numpy(x)), want)
    # the exact erf GELU, torch's default, would not hold
    erf = torch.nn.functional.gelu(torch.from_numpy(x) @ tm["wi"] + tm["bi"])
    with pytest.raises(AssertionError):
        close(erf @ tm["wo"] + tm["bo"], want)


def test_sinusoid_and_encode_match_jax():
    jp, npp = jax_params()
    jcfg, tcfg = cfgs()
    close(ED._sinusoid(37, 128), JED._sinusoid(37, 128), atol_scale=1e-6)
    frames = batch(1)["frames"]
    tp = lm_params_from_numpy(npp, "cpu")
    n0 = flash_attention.launches
    with torch.no_grad():
        got = ED.encode(tp, torch.from_numpy(frames), tcfg,
                        Ctx(attn_impl="kernel"))
    assert flash_attention.launches == n0          # CPU: the plain version
    for impl in ("kernel", "ref"):
        want = JED.encode(jp, jnp.asarray(frames), jcfg,
                          JCtx(attn_impl=impl))
        close(got, want)


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("j_impl", ["kernel", "ref"])
def test_prefill_and_decode_step(j_impl, cache):
    """prefill logits and every ``DecCache`` field with its dtype, then a
    decode step after each side's own prefill."""

    jdt, tdt = CACHES[cache]
    jp, npp = jax_params()
    jm = j_build(cfgs()[0], JCtx(attn_impl=j_impl, cache_dtype=jdt))
    tm = build_model(cfgs()[1], Ctx(attn_impl="kernel", cache_dtype=tdt),
                     device="cpu")
    tp = lm_params_from_numpy(npp, "cpu")
    b = batch(3)
    jl, jc = jm.prefill(jp, b, MAX_LEN)
    tl, tc = tm.prefill(tp, b, MAX_LEN)
    assert isinstance(tc, ED.DecCache) and isinstance(tc.self_kv, KVCache)
    assert tl.shape == (B, 512)
    close(tl, jl)
    held_caches(tc, jax.tree.map(np.asarray, jc))

    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl1, jc1 = jm.decode(jp, jc, tok, PROMPT)
    tl1, tc1 = tm.decode(tp, tc, torch.from_numpy(tok), PROMPT)
    assert tc1 is tc                               # written in place
    close(tl1, jl1, atol_scale=2.0 ** -7 if cache == "bfloat16" else 1e-5)
    held_caches(tc1, jax.tree.map(np.asarray, jc1))


@pytest.mark.parametrize("cache", list(CACHES))
def test_decode_from_the_jax_cache(cache):
    """Three decode steps from JAX's prefill cache handed across: a
    ``DecCache`` with a ``KVCache`` inside, every leaf in its dtype."""

    jdt, tdt = CACHES[cache]
    jp, npp = jax_params()
    jm = j_build(cfgs()[0], JCtx(cache_dtype=jdt))
    tm = build_model(cfgs()[1], Ctx(cache_dtype=tdt), device="cpu")
    tp = lm_params_from_numpy(npp, "cpu")
    b = batch(5)
    jl, jc = jm.prefill(jp, b, MAX_LEN)
    jtree = jax.tree.map(np.asarray, jc)
    tc = kv_cache_from_numpy(jtree, "cpu")
    assert isinstance(tc, ED.DecCache) and isinstance(tc.self_kv, KVCache)
    assert all(t.dtype == tdt for t in (*tc.self_kv, tc.cross_k,
                                        tc.cross_v))
    for g, w in zip(tree_leaves(tc), jax.tree.leaves(jtree)):
        assert np.array_equal(g.float().numpy(), w.astype(np.float32))
    toks = np.random.default_rng(6).integers(0, 512, (3, B)).astype(np.int32)
    for i, tok in enumerate(toks):
        jl, jc = jm.decode(jp, jc, tok, PROMPT + i)
        tl, tc = tm.decode(tp, tc, torch.from_numpy(tok), PROMPT + i)
        close(tl, jl)
    held_caches(tc, jax.tree.map(np.asarray, jc))


@pytest.mark.parametrize("j_impl", ["kernel", "ref"])
def test_serve_loop_tokens(j_impl):
    jp, npp = jax_params()
    jm = j_build(cfgs()[0], JCtx(attn_impl=j_impl))
    tm = build_model(cfgs()[1], Ctx(attn_impl="kernel"), device="cpu")
    b = batch(4)
    jloop = JServeLoop(jm, jp, B, MAX_LEN)
    want = np.asarray(jloop.generate(b, NEW))
    got = ServeLoop(tm, lm_params_from_numpy(npp, "cpu"), B,
                    MAX_LEN).generate(b, NEW)
    assert got.shape == (B, NEW) and got.dtype == torch.int32
    got = got.numpy()

    # JAX's logits along its own tokens, for the top-2 margins
    logits, cache = jm.prefill(jp, b, MAX_LEN)
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
            if margins[row, i] <= TOKEN_MARGIN:
                break
            assert got[row, i] == want[row, i], (row, i)
            compared += 1
    assert compared >= B * NEW // 2


def jax_paths(tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield tuple(k.key for k in path), np.asarray(leaf)


def at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_every_gradient_match_jax(remat):
    """16 tokens a row; the last row's last 4 targets are padding.  The
    gradient of every k bias is 0 in exact arithmetic (see below)."""

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
        # q . bk is one constant over a query's keys, which the softmax
        # cancels: bk's gradient is 0 up to rounding on both sides, so it
        # is held at the scale of the same sublayer's bq gradient
        ref = at(jg, keys[:-1] + ("bq",)) if keys[-1] == "bk" else g
        assert err <= GRAD_TOL * float(np.abs(ref).max()), (keys, err)
        n += 1
    assert n == len(tree_leaves(tg))


def test_prefill_and_decode_equal_a_full_forward():
    """prefill(12 tokens) + decode(token) equals a fresh prefill over the
    13 tokens, in the port alone (f32 cache)."""

    _, npp = jax_params()
    tm = build_model(cfgs()[1], Ctx(cache_dtype=torch.float32),
                     device="cpu")
    tp = lm_params_from_numpy(npp, "cpu")
    b = batch(6)
    _, cache = tm.prefill(tp, b, PROMPT + 4)
    nxt = np.random.default_rng(7).integers(0, 512, B).astype(np.int32)
    got, _ = tm.decode(tp, cache, torch.from_numpy(nxt), PROMPT)
    want, _ = tm.prefill(tp, dict(b, tokens=np.concatenate(
        [b["tokens"], nxt[:, None]], axis=1)), PROMPT + 5)
    close(got, want.numpy())


def test_full_config_and_init_cache_shapes():
    """The published widths, and ``init_cache`` as the reference sizes it
    (cross K/V at the config's 1500 frames)."""

    cfg = get_model_config(ARCH)
    assert (cfg.family, cfg.encoder_layers, cfg.num_layers, cfg.d_model,
            cfg.num_heads, cfg.encoder_seq_len) == ("encdec", 32, 32, 1280,
                                                    20, 1500)
    jc = j_build(cfgs()[0], JCtx()).init_cache(B, MAX_LEN)
    tc = build_model(cfgs()[1], device="cpu").init_cache(B, MAX_LEN)
    held_caches(tc, jax.tree.map(np.asarray, jc))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(cfg)
