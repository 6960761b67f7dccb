"""The port's MoE-family LMs against the JAX package's, on the CPU: the
smoke configs of granite-moe-3b-a800m (routed experts) and
deepseek-v2-lite-16b (an MLA + dense head sublayer, then MLA + MoE with a
shared expert).

Parameters come from JAX ``init`` through ``convert.lm_params_from_numpy``
and prompts are numpy draws.  Held: ``lm_prefill`` logits and cache and
``lm_decode_step`` against JAX with ``attn_impl="kernel"`` (the Pallas
kernel in interpret mode) and ``"ref"``; ``ServeLoop.generate`` tokens;
``lm_loss`` (the MoE aux included) and every gradient leaf against
``jax.value_and_grad``; and the port's own prefill + decode against a full
forward, as ``tests/test_models_consistency.py`` holds JAX's.

Routing is compared first.  Both sides' routers are wrapped to record
each call's expert choices (JAX's with its gap between the k-th and
(k+1)-th probability).  A flip changes its token's hidden state and,
through attention, the rest of its row, so a row is held only while its
routing agrees: at a row's first flip every flipped token's JAX gap must
be at most ``MARGIN``, and from there on the row is not compared.

Tolerances, as ``tests/test_torch_lm.py`` and ``tests/test_torch_train.py``
state them: float32 values at rtol 1e-4 with atol 1e-5 x max|JAX value|;
the loss at rel ``LOSS_RTOL``, each gradient leaf within ``GRAD_TOL`` x
max|JAX leaf|; tokens equal on every step whose JAX top-2 logit margin
exceeds 1e-3, up to a row's first step where it does not.
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
from repro.models import moe as JMOE  # noqa: E402
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
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.mla import MLACache  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402

torch.set_num_threads(2)

ARCHS = ["granite-moe-3b-a800m", "deepseek-v2-lite-16b"]
B, PROMPT, MAX_LEN, NEW = 2, 40, 64, 12
MARGIN = 1e-5          # router probabilities
TOKEN_MARGIN = 1e-3    # top-2 logits
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def close(got, want, rtol=1e-4, atol_scale=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * float(np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    params = j_build(j_smoke(arch), JCtx()).init(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def prompt(seed, batch=B, length=PROMPT):
    return np.random.default_rng(seed).integers(
        0, 512, (batch, length)).astype(np.int32)


@pytest.fixture
def routes(monkeypatch):
    """Each side's router calls, in order: JAX's (top_idx, gap) and the
    port's top_idx, as numpy.  Traced JAX calls (under ``jax.grad``,
    ``jit`` or a layer scan) are not recorded: the JAX models here are
    built with ``scan_layers=False``."""

    log = {"jax": [], "torch": []}
    j_route, t_route = JMOE.route, TMOE.route

    def j_rec(params, xt, cfg):
        out = j_route(params, xt, cfg)
        if not isinstance(xt, jax.core.Tracer):
            probs = np.asarray(jax.nn.softmax(
                xt.astype(jnp.float32) @ params["router"], axis=-1))
            top = -np.sort(-probs, axis=-1)
            k = cfg.num_experts_per_tok
            log["jax"].append((np.asarray(out[0]),
                               top[:, k - 1] - top[:, k]))
        return out

    def t_rec(params, xt, cfg):
        out = t_route(params, xt, cfg)
        log["torch"].append(out[0].detach().cpu().numpy())
        return out

    monkeypatch.setattr(JMOE, "route", j_rec)
    monkeypatch.setattr(TMOE, "route", t_rec)
    return log


def agreed_rows(log, batch=B):
    """Rows whose routing agreed in every router call of ``log`` (which is
    then emptied); fails where a row's first flip lies on a token whose
    JAX gap exceeds MARGIN."""

    assert len(log["jax"]) == len(log["torch"]) > 0
    alive = np.ones(batch, bool)
    for (j_idx, gap), t_idx in zip(log["jax"], log["torch"]):
        same = (np.sort(j_idx, -1) == np.sort(t_idx, -1)).all(-1)
        same, gap = same.reshape(batch, -1), gap.reshape(batch, -1)
        first = alive & ~same.all(1)
        clear = ~same & (gap > MARGIN)
        assert not clear[first].any(), "routing flipped clear of a near-tie"
        alive &= same.all(1)
    log["jax"].clear()
    log["torch"].clear()
    return alive


def held_caches(got, want, rows, stacked=False):
    """Every cache of the port's tree (a ``KVCache`` or an ``MLACache``,
    stacked under ``units``, unstacked under a head sublayer) against
    JAX's, on ``rows``."""

    for name, sub in got.items():
        if isinstance(sub, dict):
            held_caches(sub, want[name], rows, stacked=name == "units")
            continue
        assert isinstance(sub, MLACache) == hasattr(want[name], "c_kv")
        lead = (slice(None),) * stacked              # the (n_scan,) axis
        for g, w in zip(sub, want[name]):
            close(g[lead + (torch.from_numpy(rows),)],
                  np.asarray(w)[lead + (rows,)])


@pytest.mark.parametrize("j_impl", ["kernel", "ref"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_and_decode_step(arch, j_impl, routes):
    jp, npp = jax_params(arch)
    jm = j_build(j_smoke(arch), JCtx(attn_impl=j_impl, scan_layers=False,
                                     cache_dtype=jnp.float32))
    tm = build_model(get_smoke_config(arch),
                     Ctx(attn_impl="kernel", cache_dtype=torch.float32),
                     device="cpu")
    tp = lm_params_from_numpy(npp, "cpu")
    tokens = prompt(3)
    n0 = flash_attention.launches
    jl, jc = jm.prefill(jp, {"tokens": tokens}, MAX_LEN)
    tl, tc = tm.prefill(tp, {"tokens": tokens}, MAX_LEN)
    assert flash_attention.launches == n0          # CPU: the plain version
    assert tl.shape == (B, 512)
    rows = agreed_rows(routes)
    assert rows.any()
    close(tl[torch.from_numpy(rows)], np.asarray(jl)[rows])
    jtree = jax.tree.map(np.asarray, jc)
    held_caches(tc, jtree, rows)

    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl1, jc1 = jm.decode(jp, jc, tok, PROMPT)
    tl1, tc1 = tm.decode(tp, tc, torch.from_numpy(tok), PROMPT)
    rows &= agreed_rows(routes)
    assert rows.any()
    close(tl1[torch.from_numpy(rows)], np.asarray(jl1)[rows])
    held_caches(tc1, jax.tree.map(np.asarray, jc1), rows)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_the_jax_cache(arch, routes):
    """``lm_decode_step`` from JAX's bf16 cache handed across
    (``kv_cache_from_numpy`` builds an ``MLACache`` for MLA sublayers)."""

    jp, npp = jax_params(arch)
    jm = j_build(j_smoke(arch), JCtx(scan_layers=False))
    tm = build_model(get_smoke_config(arch), device="cpu")
    tokens = prompt(5)
    jl, jc = jm.prefill(jp, {"tokens": tokens}, MAX_LEN)
    tc = kv_cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    if arch.startswith("deepseek"):
        assert isinstance(tc["head0"], MLACache)
        assert isinstance(tc["units"]["s0"], MLACache)
    routes["jax"].clear()
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl1, _ = jm.decode(jp, jc, tok, PROMPT)
    tl1, _ = tm.decode(lm_params_from_numpy(npp, "cpu"), tc,
                       torch.from_numpy(tok), PROMPT)
    rows = agreed_rows(routes)
    assert rows.any()
    # the decode output from a bf16 cache: test_torch_lm.py's 2^-7 rule
    close(tl1[torch.from_numpy(rows)], np.asarray(jl1)[rows],
          atol_scale=2.0 ** -7)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch, routes):
    jp, npp = jax_params(arch)
    jm = j_build(j_smoke(arch), JCtx(scan_layers=False))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, 512, (B, 24)).astype(np.int32),
             "targets": rng.integers(0, 512, (B, 24)).astype(np.int32)}
    batch["targets"][-1, -4:] = -1
    jloss = jm.loss(jp, batch)                 # eager: its routing recorded
    tm = build_model(get_smoke_config(arch), Ctx(remat=True), device="cpu")
    tp = lm_params_from_numpy(npp, "cpu")
    tl, tg = loss_and_grads(tm.loss, tp, [batch])
    # remat recomputes each unit in the backward, last unit first, with
    # the forward's routing
    n_scan = len(routes["torch"]) // 2
    recomputed = routes["torch"][n_scan:][::-1]
    del routes["torch"][n_scan:]
    for a, b in zip(routes["torch"], recomputed):
        assert np.array_equal(a, b)
    # the loss sums every row, and a gradient jumps where routing flips:
    # these inputs route every token of both sides alike
    assert agreed_rows(routes).all()
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, batch)
    np.testing.assert_allclose(float(jl), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    n = 0
    for keys, g in jax_paths(jg):
        got = at(tg, keys).numpy()
        err = float(np.abs(got - g).max())
        assert err <= GRAD_TOL * float(np.abs(g).max()), (keys, err)
        n += 1
    assert n == len(tree_leaves(tg))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_a_full_forward(arch):
    """prefill(prompt) + decode(token) equals a fresh prefill over
    prompt + token, in the port alone (f32 cache)."""

    _, npp = jax_params(arch)
    tm = build_model(get_smoke_config(arch),
                     Ctx(cache_dtype=torch.float32), device="cpu")
    tp = lm_params_from_numpy(npp, "cpu")
    toks = prompt(6, length=16)
    _, cache = tm.prefill(tp, {"tokens": toks}, 24)
    nxt = prompt(7, length=1)[:, 0]
    got, _ = tm.decode(tp, cache, torch.from_numpy(nxt), 16)
    want, _ = tm.prefill(tp, {"tokens": np.concatenate(
        [toks, nxt[:, None]], axis=1)}, 24)
    close(got, want.numpy())


def test_moe_archs_are_ported_and_others_raise():
    for arch in ARCHS:
        cfg = get_model_config(arch)
        assert cfg.family == "moe" and cfg.moe is not None
    assert get_model_config("deepseek-v2-lite-16b").mla.kv_lora_rank == 512
    assert get_model_config("granite-moe-3b-a800m").moe.num_experts == 40
    with pytest.raises(ValueError, match="unknown arch"):
        get_model_config("mixtral-8x7b")
    for arch in ("whisper-large-v3", "internvl2-76b"):
        assert build_model(get_smoke_config(arch), device="cpu").init(
            torch.Generator().manual_seed(0))
