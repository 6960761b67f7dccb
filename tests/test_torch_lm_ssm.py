"""The port's SSM and hybrid LMs against the JAX package's, on the CPU:
the smoke configs of mamba2-780m (48 -> 3 Mamba2 layers, no attention)
and zamba2-2.7b (4 Mamba2 layers, a shared attention block before every
2 of them).

Parameters come from JAX ``init`` through ``convert.lm_params_from_numpy``
(zamba2's ``lora_b``, zero at init, drawn from a numpy seed first, so
every test runs nonzero LoRA deltas); caches cross through
``convert.kv_cache_from_numpy``; prompts are numpy draws.  Held:
``prefill`` logits and cache against JAX with ``attn_impl="kernel"`` (the
Pallas kernel in interpret mode) and ``"ref"``; a ``decode`` step after
the port's own prefill (float32 conv registers), from JAX's prefill cache,
and from ``init_cache`` (bfloat16 registers); ``ServeLoop.generate``
tokens; ``loss`` and every gradient leaf against ``jax.value_and_grad``
with remat on and off; the port's own prefill + decode against a full
forward, as ``tests/test_models_consistency.py`` holds JAX's.

Prompts of 48 tokens (3 chunks of 16) take the chunked SSD; the
full-forward check's 33 tokens take the sequential oracle.

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
from repro.models.api import Ctx as JCtx  # noqa: E402
from repro_torch.config import ARCHS as ALL_ARCHS  # noqa: E402
from repro_torch.config import ShapeConfig  # noqa: E402
from repro_torch.config import get_model_config  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    kv_cache_from_numpy,
    lm_params_from_numpy,
)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.launch.lm_engine import ServeLoop  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.ssm import SSMState  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402

torch.set_num_threads(2)

ARCHS = ["mamba2-780m", "zamba2-2.7b"]
B, PROMPT, MAX_LEN, NEW = 2, 48, 64, 12
TOKEN_MARGIN = 1e-3
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
LORA_B_STD = 1.0   # the smoke's delta ~0.03 against wq's entries ~0.125


def close(got, want, rtol=1e-4, atol_scale=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * float(np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    """JAX ``init``'s parameters (zamba2's ``lora_b`` redrawn from a numpy
    seed) as a JAX tree and as numpy."""

    npp = jax.tree.map(np.asarray,
                       j_build(j_smoke(arch), JCtx()).init(
                           jax.random.PRNGKey(0)))
    if "units" in npp and "lora_b" in npp["units"]:
        shape = npp["units"]["lora_b"].shape
        npp["units"]["lora_b"] = (np.random.default_rng(11).normal(
            size=shape) * LORA_B_STD).astype(np.float32)
    return jax.tree.map(jnp.asarray, npp), npp


def prompt(seed, length=PROMPT):
    return np.random.default_rng(seed).integers(
        0, 512, (B, length)).astype(np.int32)


def held_caches(got, want, atol_scale=1e-5):
    """Every cache of the port's tree against JAX's, type and dtype
    included (bfloat16 leaves at the 2^-7 rule)."""

    if isinstance(got, dict):
        assert set(got) == set(want)
        for name in got:
            held_caches(got[name], want[name], atol_scale)
        return
    assert type(got)._fields == want._fields
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert str(g.dtype).split(".")[-1] == w.dtype.name
        assert tuple(g.shape) == w.shape
        bf16 = g.dtype == torch.bfloat16
        close(g, w.astype(np.float32),
              atol_scale=2.0 ** -7 if bf16 else atol_scale)


MODELS = [("mamba2-780m", "ref"), ("zamba2-2.7b", "kernel"),
          ("zamba2-2.7b", "ref")]


@pytest.mark.parametrize("arch,j_impl", MODELS)
def test_prefill_and_decode_step(arch, j_impl):
    """The prefill's cache holds float32 conv registers on both sides (the
    activations' dtype); the decode step after it runs on them."""

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
    assert flash_attention.launches == n0          # CPU: the plain version
    assert tl.shape == (B, 512)
    close(tl, jl)
    held_caches(tc, jax.tree.map(np.asarray, jc))

    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl1, jc1 = jm.decode(jp, jc, tok, PROMPT)
    tl1, tc1 = tm.decode(tp, tc, torch.from_numpy(tok), PROMPT)
    assert tc1 is tc                               # written in place
    close(tl1, jl1)
    held_caches(tc1, jax.tree.map(np.asarray, jc1))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_the_jax_cache(arch):
    """A decode step from JAX's prefill cache handed across (default cache
    dtype: zamba2's (k, v) in bfloat16; the SSM registers float32, the
    prefill's own)."""

    jp, npp = jax_params(arch)
    jm = j_build(j_smoke(arch), JCtx())
    tm = build_model(get_smoke_config(arch), device="cpu")
    tokens = prompt(5)
    jl, jc = jm.prefill(jp, {"tokens": tokens}, MAX_LEN)
    jtree = jax.tree.map(np.asarray, jc)
    tc = kv_cache_from_numpy(jtree, "cpu")
    states = tc["units"]["s0"] if arch.startswith("mamba") else tc["ssm"]
    assert isinstance(states, SSMState)
    assert states.conv_x.dtype == torch.float32
    if arch.startswith("zamba"):
        assert isinstance(tc["kv"], KVCache)
        assert tc["kv"].k.dtype == torch.bfloat16
    held_caches(tc, jtree)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl1, _ = jm.decode(jp, jc, tok, PROMPT)
    tl1, _ = tm.decode(lm_params_from_numpy(npp, "cpu"), tc,
                       torch.from_numpy(tok), PROMPT)
    close(tl1, jl1, atol_scale=2.0 ** -7)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_init_cache(arch):
    """Three decode steps from ``init_cache``: bfloat16 conv registers and
    (k, v) on both sides; each step's logits and the final cache."""

    jp, npp = jax_params(arch)
    jm = j_build(j_smoke(arch), JCtx())
    tm = build_model(get_smoke_config(arch), device="cpu")
    tp = lm_params_from_numpy(npp, "cpu")
    jc = jm.init_cache(B, MAX_LEN)
    tc = tm.init_cache(B, MAX_LEN)
    held_caches(tc, jax.tree.map(np.asarray, jc))
    for pos, tok in enumerate(prompt(8, 3).T):
        jl, jc = jm.decode(jp, jc, tok, pos)
        tl, tc = tm.decode(tp, tc, torch.from_numpy(tok), pos)
        close(tl, jl, atol_scale=2.0 ** -7)
    held_caches(tc, jax.tree.map(np.asarray, jc))


@pytest.mark.parametrize("arch,j_impl", MODELS)
def test_serve_loop_tokens(arch, j_impl):
    jp, npp = jax_params(arch)
    jm = j_build(j_smoke(arch), JCtx(attn_impl=j_impl))
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


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch, remat):
    """32 tokens a row (2 chunks of 16: the chunked SSD under autograd);
    the last row's last 4 targets are padding."""

    jp, npp = jax_params(arch)
    jm = j_build(j_smoke(arch), JCtx())
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, 512, (B, 32)).astype(np.int32),
             "targets": rng.integers(0, 512, (B, 32)).astype(np.int32)}
    batch["targets"][-1, -4:] = -1
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, batch)
    tm = build_model(get_smoke_config(arch), Ctx(remat=remat), device="cpu")
    tp = lm_params_from_numpy(npp, "cpu")
    tl, tg = loss_and_grads(tm.loss, tp, [batch])
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
    """prefill(32 tokens, chunked) + decode(token) equals a fresh prefill
    over the 33 tokens (sequential oracle), in the port alone (f32
    cache)."""

    _, npp = jax_params(arch)
    tm = build_model(get_smoke_config(arch),
                     Ctx(cache_dtype=torch.float32), device="cpu")
    tp = lm_params_from_numpy(npp, "cpu")
    toks = prompt(6, length=32)
    _, cache = tm.prefill(tp, {"tokens": toks}, 40)
    nxt = prompt(7, length=1)[:, 0]
    got, _ = tm.decode(tp, cache, torch.from_numpy(nxt), 32)
    want, _ = tm.prefill(tp, {"tokens": np.concatenate(
        [toks, nxt[:, None]], axis=1)}, 40)
    close(got, want.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_takes_a_step(arch, monkeypatch, tmp_path):
    """``launch/train.py --arch`` trains the smoke config (32-token rows,
    the chunked SSD under remat) on the CPU: two AdamW steps move every
    parameter leaf the loss reaches and leave them finite."""

    monkeypatch.setattr(tlaunch, "get_model_config",
                        lambda a: get_smoke_config(a))
    monkeypatch.setattr(tlaunch, "get_shape",
                        lambda name: ShapeConfig(name, 32, 2, "train"))
    params, opt = tlaunch.main(["--arch", arch, "--steps", "2",
                                "--microbatch", "1", "--ckpt",
                                str(tmp_path), "--device", "cpu"])
    assert int(opt.step) == 2
    init = build_model(get_smoke_config(arch), device="cpu").init(
        torch.Generator().manual_seed(0))
    for a, b in zip(tree_leaves(params), tree_leaves(init)):
        assert torch.isfinite(a).all()
    moved = sum(not torch.equal(a, b) for a, b in
                zip(tree_leaves(params), tree_leaves(init)))
    assert moved == len(tree_leaves(params))


def test_zamba2_lora_deltas_are_live():
    """With ``lora_b`` drawn nonzero the port still agrees with JAX, and
    the deltas move the logits far beyond that agreement: zeroing them
    changes the prefill's logits."""

    arch = "zamba2-2.7b"
    jp, npp = jax_params(arch)
    assert np.abs(npp["units"]["lora_b"]).max() > 0.5
    tm = build_model(get_smoke_config(arch), device="cpu")
    tokens = prompt(9)
    jl, _ = j_build(j_smoke(arch), JCtx()).prefill(jp, {"tokens": tokens},
                                                   MAX_LEN)
    tl, _ = tm.prefill(lm_params_from_numpy(npp, "cpu"), {"tokens": tokens},
                       MAX_LEN)
    close(tl, jl)
    zero = dict(npp, units=dict(npp["units"],
                                lora_b=np.zeros_like(npp["units"]["lora_b"])))
    t0, _ = tm.prefill(lm_params_from_numpy(zero, "cpu"), {"tokens": tokens},
                       MAX_LEN)
    moved = float((tl - t0).abs().max())
    assert moved > 1e-2 * float(np.abs(np.asarray(jl)).max()), moved


def test_ssm_archs_are_ported_and_default_to_the_card():
    assert {"mamba2-780m", "zamba2-2.7b"} <= set(ALL_ARCHS)
    mamba, zamba = (get_model_config(a) for a in ARCHS)
    assert mamba.family == "ssm" and mamba.ssm.d_state == 128
    assert mamba.ssm.n_heads(mamba.d_model) == 48
    assert zamba.family == "hybrid" and zamba.shared_attn_every == 6
    assert zamba.resolved_head_dim == 80 and zamba.ssm.n_heads(2560) == 80
    if not torch.cuda.is_available():
        for cfg in (mamba, zamba):
            with pytest.raises(RuntimeError, match="CUDA"):
                build_model(cfg)
    for arch in ("whisper-large-v3", "internvl2-76b"):
        assert get_model_config(arch).family in ("encdec", "vlm")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                build_model(get_model_config(arch))
