"""The port's LM training against the JAX package's, on the CPU.

The same numpy inputs go to both sides: parameters from JAX ``init``
through ``convert.lm_params_from_numpy``, optimizer states through
``convert.opt_state_from_numpy``, gradients and batches as numpy draws.
Held:

* ``lm_loss`` and every gradient leaf against ``jax.grad`` of JAX's
  ``lm_loss`` on the four dense smoke configs (one case with -1 padded
  targets), remat on: the loss within rel ``LOSS_RTOL``, each leaf within
  ``GRAD_TOL`` x max|JAX leaf|.  Both sides compute in float32 and sum in
  other orders; the measured worst leaf is ~2.5e-6 of its max.
* ``remat`` on and off: the same loss and gradients, bitwise (the CPU's
  recompute is the same arithmetic in the same order).
* ``cross_entropy`` with and without ``n_valid``: rel 1e-6.
* ``adamw``, ``sgd`` and ``paper_sgd`` over 3 updates from the same
  numpy gradients: updates, states and parameters within ``OPT_RTOL`` of
  max|JAX value| (XLA and torch round pow, sqrt and the fused
  multiply-adds differently by an ulp); ``clip_by_global_norm`` and
  ``cosine_warmup`` values.
* ``make_train_step`` with microbatch 0 and 4 against JAX's on a
  one-device mesh, two steps: losses at rel ``LOSS_RTOL``.  With ``sgd``
  (updates linear in the gradients) every parameter leaf within
  ``SGD_TOL`` x max|JAX leaf|.  With ``adamw``, whose first updates are
  ±lr-sized on every coordinate whatever the gradient's size (so an ulp
  of gradient on a coordinate whose gradient is near ``eps`` moves its
  update by a fraction of lr), every coordinate within ``ADAM_MAX`` x lr
  and all but ``ADAM_FRAC`` of them within 1e-3 x lr (measured: max
  0.05 lr, 8e-5 of them beyond 1e-3 lr).
* ``LMTokenPipeline``: bitwise.
* ``launch.train.main``: 4 steps straight equal 2 steps, a resume and 2
  more, bitwise; its unported flags raise with the reason.
* A float64 evaluation stays float64: <grad L, d> against the central
  difference (rel 1e-6).
* The flash kernel's wrapper refuses to run under autograd.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compat import make_mesh  # noqa: E402
from repro.config import ShapeConfig as JShape  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_smoke_config as j_smoke  # noqa: E402
from repro.data import LMTokenPipeline as JPipeline  # noqa: E402
from repro.launch.mesh import mesh_config_for  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.api import Ctx as JCtx  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro.train.step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.config import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_params_from_numpy,
    opt_state_from_numpy,
)
from repro_torch.data import LMTokenPipeline  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.optim import optimizers as TO  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.train import make_eval_step, make_train_step  # noqa: E402
from repro_torch.train.step import loss_and_grads, split_batch  # noqa: E402

torch.set_num_threads(2)

ARCHS = ["gemma2-2b", "internlm2-20b", "qwen1.5-32b", "granite-34b"]
B, L = 4, 24
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
OPT_RTOL = 1e-6
SGD_TOL = 1e-5
ADAM_MAX = 0.25
ADAM_FRAC = 1e-3


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    model = j_build(j_smoke(arch), JCtx())
    params = model.init(jax.random.PRNGKey(0))
    return model, params, jax.tree.map(np.asarray, params)


def tokens(vocab, seed=0, batch=B, length=L, pad=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (batch, length)).astype(np.int32)
    tgt = rng.integers(0, vocab, (batch, length)).astype(np.int32)
    if pad:
        tgt[-1, -pad:] = -1
        tgt[0, :pad // 2] = -1
    return {"tokens": tok, "targets": tgt}


def jax_paths(tree):
    """(path keys, numpy leaf) of a JAX dict tree."""

    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield tuple(k.key for k in path), np.asarray(leaf)


def at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def leaf_close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


# ---------------------------------------------------------------------- #
# loss and gradients
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("arch,pad", [(a, 0) for a in ARCHS]
                         + [("gemma2-2b", 6)])
def test_loss_and_every_gradient_match_jax(arch, pad):
    jm, jp, npp = jax_params(arch)
    batch = tokens(j_smoke(arch).vocab_size, seed=1, pad=pad)
    jl, jg = jax.value_and_grad(jm.loss)(jp, batch)
    tm = build_model(get_smoke_config(arch), Ctx(remat=True), device="cpu")
    tp = lm_params_from_numpy(npp, "cpu")
    tl, tg = loss_and_grads(tm.loss, tp, [batch])
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    n = 0
    for keys, g in jax_paths(jg):
        leaf_close(at(tg, keys), g, GRAD_TOL, keys)
        n += 1
    assert n == len(tree_leaves(tg))
    # the parameters are handed back as they came: no grad, no .grad
    assert not any(p.requires_grad or p.grad is not None
                   for p in tree_leaves(tp))


def test_remat_on_and_off_are_bitwise_equal():
    arch = "gemma2-2b"
    _, _, npp = jax_params(arch)
    batch = tokens(512, seed=2)
    out = []
    for remat in (False, True):
        tm = build_model(get_smoke_config(arch), Ctx(remat=remat),
                         device="cpu")
        out.append(loss_and_grads(tm.loss, lm_params_from_numpy(npp, "cpu"),
                                  [batch]))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_valid", [None, 37])
def test_cross_entropy_matches_jax(n_valid):
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(3, 9, 50)) * 4).astype(np.float32)
    targets = rng.integers(0, 50, (3, 9)).astype(np.int32)
    targets[0, :4] = -1
    targets[2, :] = -1
    want = JL.cross_entropy(logits, targets, n_valid)
    got = TL.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(targets), n_valid)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # every target padding: the mean over max(0, 1) positions is 0
    none = -np.ones_like(targets)
    assert float(TL.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(none))) == 0.0


def test_model_loss_and_eval_step():
    arch = "internlm2-20b"
    jm, jp, npp = jax_params(arch)
    batch = tokens(512, seed=4)
    tm = build_model(get_smoke_config(arch), device="cpu")
    tp = lm_params_from_numpy(npp, "cpu")
    got = make_eval_step(tm)(tp, batch)
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), float(jm.loss(jp, batch)),
                               rtol=LOSS_RTOL)
    with pytest.raises(ValueError, match="into 3 equal parts"):
        split_batch(batch, 3)


def test_float64_gradient_matches_central_difference():
    """The model stays float64 when its parameters are (its f32 upcasts
    keep float64), so <grad L, d> meets the central difference along a
    seeded unit direction to ~1e-9 (held at 1e-6, as on the card)."""

    arch = "gemma2-2b"
    _, _, npp = jax_params(arch)
    tm = build_model(get_smoke_config(arch), device="cpu")
    p64 = TO.tree_map(lambda p: p.double(), lm_params_from_numpy(npp, "cpu"))
    gen = torch.Generator().manual_seed(0)
    d = TO.tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                          dtype=torch.float64), p64)
    norm = torch.sqrt(sum(torch.sum(x * x) for x in tree_leaves(d)))
    d = TO.tree_map(lambda x: x / norm, d)
    batch = tokens(512, seed=7, batch=2, length=16, pad=4)
    loss, g = loss_and_grads(tm.loss, p64, [batch])
    assert loss.dtype == torch.float64
    dd = float(sum(torch.sum(a * b) for a, b in
                   zip(tree_leaves(g), tree_leaves(d))))
    eps = 1e-3
    with torch.no_grad():
        up = float(tm.loss(TO.tree_map(lambda p, x: p + eps * x, p64, d),
                           batch))
        dn = float(tm.loss(TO.tree_map(lambda p, x: p - eps * x, p64, d),
                           batch))
    assert abs(dd - (up - dn) / (2 * eps)) < 1e-6 * abs(dd)


# ---------------------------------------------------------------------- #
# optimizers
# ---------------------------------------------------------------------- #


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": {"w": rng.normal(size=(7,)).astype(np.float32) * 1e-3,
                  "z": np.zeros((2, 2), np.float32)}}


def _t(tree):
    return lm_params_from_numpy(tree, "cpu")


OPTS = {
    "adamw": lambda m: m.adamw(m.cosine_warmup(1e-2, 2, 10), 0.9, 0.95, 1e-8,
                               0.1, 1.0),
    "adamw_noclip": lambda m: m.adamw(m.cosine_warmup(1e-2, 0, 10)),
    "sgd": lambda m: m.sgd(m.cosine_warmup(1e-2, 1, 10), 0.9, 0.5),
    "paper_sgd": lambda m: m.paper_sgd(5e-4, 5e-7),
}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_updates_and_states_match_jax(name):
    jopt, topt = OPTS[name](JO), OPTS[name](TO)
    params = _opt_tree(0)
    jp, jstate = params, jopt.init(params)
    tp = _t(params)
    tstate = topt.init(tp)
    assert type(tstate).__name__ == type(jstate).__name__
    for i in range(3):
        g = jax.tree.map(lambda a: a * (i + 1) * 3.0, _opt_tree(10 + i))
        jupd, jstate = jopt.update(g, jstate, jp)
        jp = JO.apply_updates(jp, jupd)
        tupd, tstate = topt.update(_t(g), tstate, tp)
        for keys, want in jax_paths(jupd):
            leaf_close(at(tupd, keys), want, OPT_RTOL, ("update", i, keys))
        tp = TO.apply_updates(tp, tupd)
        assert int(tstate.step) == int(jstate.step) == i + 1
        assert tstate.step.dtype == torch.int32
        for jtree, ttree in zip(jstate[1:], tstate[1:]):
            if jtree == ():
                assert ttree == ()
                continue
            for keys, want in jax_paths(jtree):
                leaf_close(at(ttree, keys), want, OPT_RTOL, ("state", keys))
        for keys, want in jax_paths(jp):
            leaf_close(at(tp, keys), want, OPT_RTOL, ("param", keys))


def test_clip_and_schedule_match_jax():
    g = jax.tree.map(lambda a: a * 40.0, _opt_tree(5))
    jclip, jnorm = JO.clip_by_global_norm(g, 1.0)
    tclip, tnorm = TO.clip_by_global_norm(_t(g), 1.0)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    for keys, want in jax_paths(jclip):
        leaf_close(at(tclip, keys), want, 1e-6, keys)
    js, ts = JO.cosine_warmup(3e-4, 10, 100), TO.cosine_warmup(3e-4, 10, 100)
    for step in (0, 1, 5, 10, 11, 55, 100, 150):
        want = float(js(jnp.int32(step)))
        got = float(ts(torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_opt_state_from_numpy_keeps_types():
    params = _opt_tree(1)
    for name in ("adamw", "sgd", "paper_sgd"):
        jstate = OPTS[name](JO).init(params)
        tstate = opt_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
        assert type(tstate).__name__ == type(jstate).__name__
        assert tstate.step.dtype == torch.int32


# ---------------------------------------------------------------------- #
# the train step
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
@pytest.mark.parametrize("microbatch", [0, 4])
def test_train_step_matches_jax(microbatch, optimizer):
    arch = "internlm2-20b"
    cfg = j_smoke(arch)
    jm = j_build(cfg, JCtx(cache_dtype=jnp.float32))
    mesh = make_mesh((1, 1), ("data", "model"))
    tc = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
              microbatch=microbatch, optimizer=optimizer)
    jstep, info = j_make_train_step(jm, mesh, mesh_config_for(mesh, False),
                                    JShape("t", 16, 8, "train"),
                                    JTrainConfig(**tc))
    jp = jm.init(jax.random.PRNGKey(0))
    npp = jax.tree.map(np.asarray, jp)
    jo = info["optimizer"].init(jp)
    tm = build_model(get_smoke_config(arch), Ctx(remat=True), device="cpu")
    tstep = make_train_step(tm, TrainConfig(**tc))
    tp = lm_params_from_numpy(npp, "cpu")
    to = opt_state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    pipe = JPipeline(cfg.vocab_size, 16, 8)
    for i in range(2):
        tok, tgt = pipe.batch_at(i)
        jp, jo, jmet = jstep(jp, jo, {"tokens": tok, "targets": tgt})
        tp2, to, tmet = tstep(tp, to, {"tokens": tok, "targets": tgt})
        # updated in place, as JAX donates
        assert all(a is b for a, b in zip(tree_leaves(tp2), tree_leaves(tp)))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=LOSS_RTOL)
    assert int(to.step) == int(jo.step) == 2
    if optimizer == "sgd":
        for keys, want in jax_paths(jp):
            leaf_close(at(tp, keys), want, SGD_TOL, keys)
        return
    lr = tc["learning_rate"]
    d = np.concatenate([np.abs(at(tp, keys).numpy() - want).ravel()
                        for keys, want in jax_paths(jp)])
    assert float(d.max()) <= ADAM_MAX * lr
    assert float(np.mean(d > 1e-3 * lr)) <= ADAM_FRAC


def test_microbatches_equal_one_pass_within_rounding():
    """microbatch=4 against one pass over the same 8 sequences."""

    arch = "gemma2-2b"
    _, _, npp = jax_params(arch)
    tm = build_model(get_smoke_config(arch), device="cpu")
    batch = tokens(512, seed=6, batch=8)
    (l1, g1), (l4, g4) = (
        loss_and_grads(tm.loss, lm_params_from_numpy(npp, "cpu"),
                       split_batch(batch, n)) for n in (1, 4))
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-6)
    for a, b in zip(tree_leaves(g4), tree_leaves(g1)):
        leaf_close(a, b.numpy(), 1e-5)


# ---------------------------------------------------------------------- #
# data pipeline and the launcher
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", [0, 3])
def test_token_pipeline_is_bitwise_jax(seed):
    jp, tp = JPipeline(1000, 33, 5, seed), LMTokenPipeline(1000, 33, 5, seed)
    for step in (0, 1, 17):
        for a, b in zip(tp.batch_at(step), jp.batch_at(step)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture
def smoke_launcher(monkeypatch):
    monkeypatch.setattr(tlaunch, "get_model_config",
                        lambda arch: get_smoke_config(arch))
    monkeypatch.setattr(tlaunch, "get_shape",
                        lambda name: ShapeConfig(name, 16, 4, "train"))
    return tlaunch.main


def test_launch_train_resume_is_bitwise(smoke_launcher, tmp_path, capsys):
    def run(steps, ckpt):
        return smoke_launcher(["--arch", "gemma2-2b", "--steps", str(steps),
                               "--microbatch", "2", "--ckpt", str(ckpt),
                               "--ckpt-every", "100", "--device", "cpu"])

    pa, oa = run(4, tmp_path / "a")
    run(2, tmp_path / "b")
    pb, ob = run(4, tmp_path / "b")
    assert "[launch] resumed at step 2" in capsys.readouterr().out
    assert type(ob).__name__ == "AdamWState" and int(ob.step) == 4
    for a, b in zip(tree_leaves((pa, oa)), tree_leaves((pb, ob))):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("flags,why", [
    # --multi-pod trains on two pods now (tests/test_torch_dp_train.py);
    # with --distributed it still raises
    (["--multi-pod", "--distributed"], "launch/mesh.py has no twin"),
    (["--distributed"], "launch/mesh.py has no twin"),
    (["--sync", "gossip"], "never reads it"),
])
def test_launch_train_unported_flags_raise(smoke_launcher, tmp_path, capsys,
                                           flags, why):
    with pytest.raises(SystemExit):
        smoke_launcher(["--arch", "gemma2-2b", "--steps", "1", "--ckpt",
                        str(tmp_path), "--device", "cpu"] + flags)
    assert why in capsys.readouterr().err


# ---------------------------------------------------------------------- #
# the flash kernel has no backward
# ---------------------------------------------------------------------- #


def test_flash_attention_refuses_autograd():
    q = torch.randn(1, 4, 6, 16, requires_grad=True)
    kv = torch.randn(1, 2, 6, 16)
    with pytest.raises(RuntimeError, match='no backward.*attn_impl="ref"'):
        flash_attention(q, kv, kv)
    with torch.no_grad():
        assert flash_attention(q, kv, kv).shape == (1, 4, 6, 16)
    with torch.inference_mode():
        flash_attention(q.detach(), kv, kv)
    # a loss under grad through the kernel model raises, not silently
    # training without attention's gradients
    _, _, npp = jax_params("gemma2-2b")
    tm = build_model(get_smoke_config("gemma2-2b"), Ctx(attn_impl="kernel"),
                     device="cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        loss_and_grads(tm.loss, lm_params_from_numpy(npp, "cpu"),
                       [tokens(512)])
    with pytest.raises(ValueError, match="flashref"):
        Ctx(attn_impl="flashref")
