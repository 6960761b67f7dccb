"""Tensor-parallel LM serving of the port against the JAX package, on the
CPU: ranks of ``gloo`` processes (``launch/gossip.py::run_on_grid(...,
device="cpu")``), at smoke sizes.

Cases: internvl2-76b's smoke config (8 query heads over 2 KV heads, 8
stub patch tokens) at tp = 2, and with 4 KV heads (a rank's KV heads its
own; its 2 over 4 ranks, gathered whole and the cache cut on its
sequence, are ``tests/test_torch_mqa_tp_serve.py``'s) at tp = 4; qwen1.5-32b's (QKV biases, 8 KV heads) at tp = 2 and 4;
gemma2-2b's (tied embeddings, logit and attention softcaps, a sliding
window) at tp = 2; qwen's with a vocab and an FFN width that do not
split at tp = 2 (the rules keep those leaves whole).  Parameters come from JAX ``init`` through
``convert.lm_params_from_numpy`` and ``train.shard.shard_params``.

Held:

* **Steps.** The port's ``make_prefill_step`` and three
  ``make_serve_step`` steps on each rank against JAX's, which runs on a
  one-device CPU mesh with ``attn_impl="flashref"``, both with a float32
  cache; the port is fed JAX's greedy tokens, so every step compares.
  Every rank's logits are within 1e-5 x max|JAX logit| (the repo's f32
  pin), and its greedy tokens equal JAX's.
* **Cache.** With the default bfloat16 cache, each rank's cache shard
  equals the slice, by ``cspecs``, of the unsharded port's cache within
  one unit in bfloat16's last place: the all-reduced sums round the
  later layers' k, v inputs differently in float32, which moves a value
  across a bfloat16 rounding boundary at most.  A value below 1e-5 x
  the leaf's max|value| (a float32 rounding's absolute size there) is
  held at that floor instead: gemma2's caches hold a few near 1.7e-5
  whose float32 values differ by 4.8e-7, 4 bfloat16 units at that scale.
  The positions the decode steps write are computed from the bfloat16
  cache, whose one-unit differences they read back, so they are held at
  2^-7 x max|value|, as ``tests/test_torch_lm.py`` holds values decoded
  from a bfloat16 cache (qwen's differ by up to 2 units, 1.2e-4 at 0.0135).
* **Shards.** ``init_shard`` at tp = 2 and 4 is, rank by rank, the slice
  of ``init_shard`` at tp = 1, bit for bit, and its draws follow
  ``init``'s distributions.
* **Launcher.** ``launch.serve.main`` at ``--tp 1`` and ``--tp 2`` prints
  the same greedy tokens.
* **Refusals.** Every family and shape outside the slice raises
  ``NotImplementedError`` naming its ROADMAP item.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import MeshConfig as JMesh  # noqa: E402
from repro.config import ShapeConfig as JShape  # noqa: E402
from repro.config import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import lm_engine as JE  # noqa: E402
from repro.launch.mesh import make_mesh_from_config  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.api import Ctx as JCtx  # noqa: E402
from repro_torch.config import MeshConfig, ShapeConfig  # noqa: E402
from repro_torch.config import get_model_config  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import gossip as tlaunch  # noqa: E402
from repro_torch.launch import lm_engine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.layers import TP  # noqa: E402
from repro_torch.optim.optimizers import tree_map_with_path  # noqa: E402
from repro_torch.train import sharding as S  # noqa: E402
from repro_torch.train.shard import (  # noqa: E402
    GRID_ITEM,
    init_shard,
    model_split,
    shard_cache,
    shard_params,
)

torch.set_num_threads(2)

B, PROMPT, STEPS = 4, 20, 3
LOGIT_TOL = 1e-5      # x max|JAX logit|: the repo's f32 pin
CASES = {             # name -> (arch, tp, config overrides)
    "internvl2-tp2": ("internvl2-76b", 2, {}),
    "internvl2-kv4-tp4": ("internvl2-76b", 4, {"num_kv_heads": 4}),
    "qwen-tp2": ("qwen1.5-32b", 2, {}),
    "qwen-tp4": ("qwen1.5-32b", 4, {}),
    "gemma2-tp2": ("gemma2-2b", 2, {}),
    # a vocab and an FFN width that do not split: the rules keep embed,
    # lm_head and the MLP whole, so the ranks make no collective for them
    "qwen-whole-vocab-mlp-tp2": ("qwen1.5-32b", 2,
                                 {"vocab_size": 511, "d_ff": 255}),
}


def _cfgs(name):
    arch, tp, over = CASES[name]
    return (dataclasses.replace(j_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over), tp)


def _patches(cfg):
    return cfg.num_patch_tokens if cfg.family == "vlm" else 0


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT))
             .astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_patch_tokens, 1024)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """JAX's prefill + STEPS greedy decode steps on a one-device mesh
    (float32 cache): (numpy params, batch, logits per step, tokens fed)."""

    jcfg, _, _ = _cfgs(name)
    mcfg = JMesh(pod=1, data=1, model=1, fsdp=False)
    mesh = make_mesh_from_config(mcfg)
    model = j_build(jcfg, JCtx(attn_impl="flashref",
                               cache_dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0))
    npp = jax.tree.map(np.asarray, params)
    P = _patches(jcfg)
    max_len = P + PROMPT + STEPS
    batch = _batch(jcfg)
    prefill, _ = JE.make_prefill_step(
        model, mesh, mcfg, JShape("p", PROMPT, B, "prefill"), max_len)
    decode, _ = JE.make_serve_step(
        model, mesh, mcfg, JShape("d", max_len - P, B, "decode"))
    logits, cache = prefill(params, batch)
    out, fed = [np.asarray(logits)], []
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        fed.append(np.asarray(tok))
        logits, cache = decode(params, cache, tok, P + PROMPT + i)
        out.append(np.asarray(logits))
    return npp, batch, out, fed


def _serve(model, group, mesh_cfg, cfg, params_np, batch, fed, rank):
    """Prefill + decode steps fed ``fed`` on one rank: logits (numpy) of
    every step and the cache shard after the prefill and at the end."""

    P = _patches(cfg)
    max_len = P + PROMPT + STEPS
    shape = ShapeConfig("p", PROMPT, B, "prefill")
    prefill, info = lm_engine.make_prefill_step(model, group, mesh_cfg,
                                                shape, max_len)
    decode, _ = lm_engine.make_serve_step(
        model, group, mesh_cfg, ShapeConfig("d", max_len - P, B, "decode"))
    full = lm_params_from_numpy(params_np, "cpu")
    params = shard_params(full, info["pspecs"], mesh_cfg, rank)
    logits, cache = prefill(params, batch)
    after_prefill = _np(cache)
    out = [logits.float().numpy()]
    for i, tok in enumerate(fed):
        logits, cache = decode(params, cache, tok, P + PROMPT + i)
        out.append(logits.float().numpy())
    return {"logits": out, "prefill_cache": after_prefill,
            "cache": _np(cache), "cspecs": info["cspecs"]}


def _np(cache):
    return tree_map_with_path(lambda _, x: x.float().numpy().copy(), cache)


def _tp_rank(rank, device, jobs):
    import torch.distributed as dist
    out = []
    for cfg, cache_dtype, params_np, batch, fed, tp in jobs:
        model = build_model(cfg, Ctx(attn_impl="kernel",
                                     cache_dtype=cache_dtype), device=device)
        mesh_cfg = MeshConfig(data=1, model=tp, fsdp=False)
        out.append(_serve(model, dist.group.WORLD, mesh_cfg, cfg, params_np,
                          batch, fed, rank))
    return out


def _jobs(tp):
    jobs, names = [], []
    for name in CASES:
        _, cfg, case_tp = _cfgs(name)
        if case_tp != tp:
            continue
        npp, batch, _, fed = jax_run(name)
        for dtype in (torch.float32, torch.bfloat16):
            jobs.append((cfg, dtype, npp, batch, fed, tp))
            names.append((name, str(dtype)[6:]))
    return names, jobs


@functools.lru_cache(maxsize=None)
def grid_run(tp):
    """Every case of ``tp`` ranks, both cache dtypes, in one grid:
    {(case, dtype): [rank results]}."""

    names, jobs = _jobs(tp)
    ranks = tlaunch.run_on_grid(_tp_rank, (1, tp), jobs, device="cpu",
                                timeout=300)
    return {key: [r[i] for r in ranks] for i, key in enumerate(names)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_steps_match_jax(name):
    _, cfg, tp = _cfgs(name)
    _, _, want, fed = jax_run(name)
    ranks = grid_run(tp)[(name, "float32")]
    assert len(ranks) == tp
    for r, res in enumerate(ranks):
        assert len(res["logits"]) == STEPS + 1
        for step, (got, ref) in enumerate(zip(res["logits"], want)):
            assert got.shape == (B, cfg.vocab_size)
            bound = LOGIT_TOL * float(np.abs(ref).max())
            err = float(np.abs(got - ref).max())
            assert err <= bound, (name, r, step, err, bound)
            # every rank holds the full logits and picks JAX's tokens
            want_tok = fed[step] if step < STEPS else ref.argmax(-1)
            np.testing.assert_array_equal(got.argmax(-1), want_tok)


def _ulp_bf16(x):
    """One unit in bfloat16's last place at each value of ``x``."""

    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_cache_shards_are_slices_of_the_unsharded_cache(name):
    _, cfg, tp = _cfgs(name)
    npp, batch, _, fed = jax_run(name)
    mesh_cfg = MeshConfig(data=1, model=tp, fsdp=False)
    one = _serve(build_model(cfg, Ctx(attn_impl="kernel"), device="cpu"),
                 None, MeshConfig(data=1, model=1, fsdp=False), cfg, npp,
                 batch, fed, 0)
    ranks = grid_run(tp)[(name, "bfloat16")]
    P = _patches(cfg)
    for key in ("prefill_cache", "cache"):
        full = tree_map_with_path(lambda _, x: torch.from_numpy(x),
                                  one[key])
        for r, res in enumerate(ranks):
            want = shard_cache(full, res["cspecs"], mesh_cfg, r)
            got = []
            tree_map_with_path(lambda _, g, w: got.append((g, w.numpy())),
                               res[key], want)
            assert got
            for g, w in got:
                assert g.shape == w.shape
                scale = float(np.abs(w).max())
                tol = np.maximum(_ulp_bf16(w), LOGIT_TOL * scale)
                # positions the decode steps wrote: computed from the
                # bfloat16 cache, held at the repo's rule for such values
                tol[..., P + PROMPT:, :] = 2.0 ** -7 * scale
                assert np.all(np.abs(g - w) <= tol), (name, key, r)
    # the KV shards are the rank's KV heads
    k = ranks[0]["cache"]["units"]["s0"].k
    assert k.shape[-3] == cfg.num_kv_heads // tp


@pytest.mark.parametrize("tp", [2, 4])
def test_init_shard_concatenates_to_one_rank(tp):
    cfg = get_smoke_config("internvl2-76b")
    if cfg.num_kv_heads % tp:
        cfg = dataclasses.replace(cfg, num_kv_heads=tp)
    one = MeshConfig(data=1, model=1, fsdp=False)
    mesh_cfg = MeshConfig(data=1, model=tp, fsdp=False)
    full = init_shard(7, cfg, None, one, 0, "cpu")
    shapes = api.param_specs(build_model(cfg, device="cpu"))
    specs = S.param_pspecs(cfg, shapes, mesh_cfg)
    sharded = 0
    for r in range(tp):
        got = init_shard(7, cfg, None, mesh_cfg, r, "cpu")
        want = shard_params(full, specs, mesh_cfg, r)
        pairs = []
        tree_map_with_path(lambda p, g, w, s: pairs.append((p, g, w, s)),
                           got, want, specs)
        for path, g, w, spec in pairs:
            assert g.dtype == w.dtype and torch.equal(g, w), path
            sharded += "model" in spec
    assert sharded > 0
    # another seed, other values
    assert not torch.equal(init_shard(8, cfg, None, one, 0, "cpu")["embed"],
                           full["embed"])


def test_init_shard_follows_init_distributions():
    cfg = get_smoke_config("internvl2-76b")
    model = build_model(cfg, device="cpu")
    ref = model.init(torch.Generator().manual_seed(0))
    got = init_shard(0, cfg, None, MeshConfig(data=1, model=1, fsdp=False),
                     0, "cpu")
    pairs = []
    tree_map_with_path(lambda p, g, w: pairs.append((p, g, w)), got, ref)
    assert len(pairs) > 10
    for path, g, w in pairs:
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if not w.any():
            assert not g.any(), path
            continue
        ratio = float(g.std()) / float(w.std())
        assert 0.9 < ratio < 1.1, (path, ratio)
        assert abs(float(g.mean())) < 0.1 * float(w.std()), path


def test_launcher_tp2_prints_the_tp1_tokens(monkeypatch, capsys):
    monkeypatch.setattr(serve, "get_model_config", get_smoke_config)
    argv = ["--arch", "internvl2-76b", "--batch", "2", "--seq-len", "16",
            "--steps", "3", "--device", "cpu"]
    one = serve.main(argv + ["--tp", "1"])
    two = serve.main(argv + ["--tp", "2"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "greedy tokens" in ln]
    assert len(lines) == 2 and lines[0] == lines[1]
    assert one["ranks"][0]["tokens"] == two["ranks"][1]["tokens"]
    assert len(two["ranks"]) == 2 and two["backend"] == "gloo"
    assert "tok/s" in out and "batch 128 -> 2" in out
    assert "seq_len 32768 -> 16" in out
    # two pods of one data rank each serve the batch's halves: the same
    # tokens; a batch that does not split over them runs whole on every
    # rank, with the one process's tokens too
    pods = serve.main(argv + ["--multi-pod", "--tp", "2"])
    assert pods["ranks"][3]["tokens"] == one["ranks"][0]["tokens"]
    odd = argv[:2] + ["--batch", "3"] + argv[4:]
    odd_one = serve.main(odd + ["--tp", "1"])
    odd_pods = serve.main(odd + ["--multi-pod", "--tp", "2"])
    assert all(r["tokens"] == odd_one["ranks"][0]["tokens"]
               for r in odd_pods["ranks"])


def _fake_tp(size, split=frozenset()):
    return TP(group=None, rank=0, size=size, staged=False, split=split)


ATTN = {"attn.wq", "attn.wk", "attn.wv", "attn.wo"}
MLP = {"mlp.wi_gate", "mlp.wi_up", "mlp.wo"}


@pytest.mark.parametrize("name,want", [
    ("internvl2-tp2", ATTN | MLP | {"embed", "lm_head", "projector.w2"}),
    ("qwen-tp4", ATTN | MLP | {"embed", "lm_head", "attn.bq", "attn.bk",
                               "attn.bv"}),
    ("gemma2-tp2", ATTN | MLP | {"embed"}),
    ("qwen-whole-vocab-mlp-tp2", ATTN | {"attn.bq", "attn.bk", "attn.bv"}),
])
def test_model_split_names_the_leaves_the_rules_split(name, want):
    _, cfg, tp = _cfgs(name)
    shapes = api.param_specs(build_model(cfg, device="meta"))
    mesh_cfg = MeshConfig(data=1, model=tp, fsdp=False)
    pspecs = S.param_pspecs(cfg, shapes, mesh_cfg)
    assert model_split(shapes, pspecs) == want


def _respec(pspecs, keys, spec):
    """``pspecs`` with the leaf at ``keys`` given ``spec``."""

    if len(keys) == 1:
        return {**pspecs, keys[0]: spec}
    return {**pspecs, keys[0]: _respec(pspecs[keys[0]], keys[1:], spec)}


@pytest.mark.parametrize("arch,keys,spec,words", [
    # attention's wo whole after a split wq/wk/wv
    ("internvl2-76b", ("units", "s0", "attn", "wo"), S.P(None, None, None),
     "attn.wo"),
    # the projector's w1 split: the port runs it whole
    ("internvl2-76b", ("projector", "w1"), S.P(None, "model"),
     "projector.w1"),
    # gemma2's global sublayers' MLP whole, its local ones' split
    ("gemma2-2b", ("units", "s1", "mlp", "wo"), S.P(None, None, None),
     "mlp.wo"),
])
def test_model_split_refuses_what_the_collectives_do_not_follow(
        arch, keys, spec, words):
    cfg = get_smoke_config(arch)
    shapes = api.param_specs(build_model(cfg, device="meta"))
    pspecs = S.param_pspecs(cfg, shapes,
                            MeshConfig(data=1, model=2, fsdp=False))
    assert model_split(shapes, pspecs)
    with pytest.raises(NotImplementedError, match=words) as err:
        model_split(shapes, _respec(pspecs, keys, spec))
    assert "item 6.8" in str(err.value)


@pytest.mark.parametrize("arch,tp,over,keys", [
    # the rules keep granite-34b's 16 k/v columns whole over 3 ranks
    ("granite-34b", 3, {"num_heads": 6}, None),
    # the attention's wk whole under its split wo, by hand
    ("internvl2-76b", 2, {}, ("units", "s0", "attn", "wk")),
])
def test_model_split_accepts_whole_kv_under_a_split_wo(arch, tp, over,
                                                       keys):
    """A rank whose k/v leaves are whole computes k and v whole: whole
    ``attn.wk``/``attn.wv`` under a split ``attn.wo`` are accepted."""

    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    shapes = api.param_specs(build_model(cfg, device="meta"))
    pspecs = S.param_pspecs(cfg, shapes,
                            MeshConfig(data=1, model=tp, fsdp=False))
    if keys is not None:
        pspecs = _respec(pspecs, keys, S.P(None, None, None))
    split = model_split(shapes, pspecs)
    assert {"attn.wq", "attn.wo"} <= split
    assert "attn.wk" not in split


# a refused case's config changes: zamba2 with 2 KV heads under its 4
# query heads (lora_b's width is cut by max(H, Hkv) heads)
REFUSAL_OVERRIDES = {("zamba2-2.7b", 2): {"num_kv_heads": 2}}


@pytest.mark.parametrize("arch,tp,words", [
    # the MoE family serves on the rank grid (tests/test_torch_ep_serve.py):
    # its query heads must still split into whole heads a rank: the smoke
    # config's 4 over 3 ranks do not (the full config's 24 do, its 8 KV
    # heads gathered whole on each rank)
    ("granite-moe-3b-a800m", 3, "heads do not split"),
    ("deepseek-v2-lite-16b", 3, "query heads"),
    # the SSM, hybrid and encoder-decoder families serve on the rank grid
    # (tests/test_torch_ssm_encdec_tp_serve.py): their smoke configs' 8
    # Mamba2 heads and whisper's 4 heads do not split over 3 ranks
    ("mamba2-780m", 3, "Mamba2 heads"),
    ("zamba2-2.7b", 3, "Mamba2 heads"),
    ("whisper-large-v3", 3, "query heads"),
    # the hybrid with H != Hkv: lora_b's rank slice is not its k/v columns
    ("zamba2-2.7b", 2, "lora_b"),
    # granite-34b's one KV head serves on the rank grid
    # (tests/test_torch_mqa_tp_serve.py); its smoke config's 8 query heads
    # do not split over 3 ranks
    ("granite-34b", 3, "query heads"),
    ("qwen1.5-32b", 3, "query heads"),
])
def test_refusals_name_their_item(arch, tp, words, monkeypatch):
    cfg = dataclasses.replace(get_smoke_config(arch),
                              **REFUSAL_OVERRIDES.get((arch, tp), {}))
    with pytest.raises(NotImplementedError, match=words) as err:
        build_model(cfg, Ctx(tp=_fake_tp(tp)), device="cpu")
    assert "item 6.8" in str(err.value)
    if api.tp_refusal(get_model_config(arch), tp) is None:
        # the full config serves here (mamba2's 48 heads over 3 ranks,
        # zamba2's 32 over 32 KV heads): the launcher gets the case's
        monkeypatch.setattr(serve, "get_model_config", lambda _: cfg)
    with pytest.raises(NotImplementedError, match=words):
        serve.main(["--arch", arch, "--tp", str(tp), "--device", "cpu"])


def test_cache_layout_the_rules_misplace_is_refused():
    """gemma2's smoke config stacks 2 units: at a batch of 2 the cache
    rule takes the units' dim for the batch and puts ``"model"`` on the
    batch, not on the KV heads a rank holds."""

    cfg = get_smoke_config("gemma2-2b")
    model = build_model(cfg, device="cpu")
    mesh_cfg = MeshConfig(data=1, model=2, fsdp=False)
    cspecs = S.cache_pspecs_tree(cfg, ShapeConfig("d", 16, 2, "decode"),
                                 mesh_cfg, api.cache_specs(model, 2, 16))
    assert tuple(cspecs["units"]["s0"].k) == ("data", "model", None, None,
                                              None)
    shapes = api.param_specs(model)
    split = model_split(shapes, S.param_pspecs(cfg, shapes, mesh_cfg))
    tp_model = build_model(cfg, Ctx(tp=_fake_tp(2, split)), device="cpu")
    with pytest.raises(NotImplementedError, match="stacking dim"):
        lm_engine._check_cache(tp_model, api.cache_specs(model, 2, 16),
                               cspecs, mesh_cfg, 2, 16)


def test_refusals_of_the_mesh_and_of_training():
    cfg = get_smoke_config("internvl2-76b")
    model = build_model(cfg, device="cpu")
    # data parallel and FSDP serve (tests/test_torch_fsdp_serve.py), and so
    # do a batch that does not split over pod x data and the SSM and
    # hybrid families (tests/test_torch_long_context_serve.py): past the
    # mesh check, their steps ask for the grid's process group.  What
    # stays refused on those meshes names its item: the encoder-decoder
    # family (c), experts split on their width (d)
    odd = ShapeConfig("d", 16, 3, "decode")
    for mesh_cfg in (MeshConfig(data=2, model=2, fsdp=True),
                     MeshConfig(multi_pod=True, pod=2, data=1, model=2)):
        with pytest.raises(ValueError, match="needs its process group"):
            lm_engine.make_serve_step(model, None, mesh_cfg, odd)
        for arch in ("mamba2-780m", "zamba2-2.7b"):
            with pytest.raises(ValueError, match="needs its process group"):
                lm_engine.make_serve_step(
                    build_model(get_smoke_config(arch), device="cpu"),
                    None, mesh_cfg, ShapeConfig("d", 16, B, "decode"))
        with pytest.raises(NotImplementedError, match=f"{GRID_ITEM}c"):
            lm_engine.make_serve_step(
                build_model(get_smoke_config("whisper-large-v3"),
                            device="cpu"),
                None, mesh_cfg, ShapeConfig("d", 16, B, "decode"))
        # the shards themselves are cut on these meshes
        assert init_shard(0, cfg, None, mesh_cfg, 0, "cpu")
    moe = get_smoke_config("granite-moe-3b-a800m")
    moe = dataclasses.replace(moe, moe=dataclasses.replace(moe.moe,
                                                          num_experts=6))
    shapes = api.param_specs(build_model(moe, device="meta"))
    with pytest.raises(NotImplementedError, match=f"{GRID_ITEM}d"):
        model_split(shapes, S.param_pspecs(
            moe, shapes, MeshConfig(data=2, model=4, fsdp=True)))
    shape = ShapeConfig("d", 16, B, "decode")
    tp_model = build_model(cfg, Ctx(tp=_fake_tp(2)), device="cpu")
    with pytest.raises(NotImplementedError, match="training"):
        tp_model.loss({}, {"tokens": np.zeros((1, 2)),
                           "targets": np.zeros((1, 2)),
                           "patches": np.zeros((1, 8, 1024), np.float32)})
    # init_shard draws every family: the SSM, hybrid and encoder-decoder
    # trees at tp = 2 are the slices of tp = 1
    one_rank = MeshConfig(data=1, model=1, fsdp=False)
    two = MeshConfig(data=1, model=2, fsdp=False)
    for arch in ("mamba2-780m", "zamba2-2.7b", "whisper-large-v3"):
        smoke = get_smoke_config(arch)
        full = init_shard(0, smoke, None, one_rank, 0, "cpu")
        specs = S.param_pspecs(smoke, api.param_specs(
            build_model(smoke, device="meta")), two)
        for r in range(2):
            pairs = []
            tree_map_with_path(lambda p, g, w: pairs.append((p, g, w)),
                               init_shard(0, smoke, None, two, r, "cpu"),
                               shard_params(full, specs, two, r))
            assert pairs and all(torch.equal(g, w) for _, g, w in pairs)
    with pytest.raises(ValueError, match="process group"):
        lm_engine.make_serve_step(model, None,
                                  MeshConfig(data=1, model=2, fsdp=False),
                                  shape)


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve.main(["--arch", "internvl2-76b", "--tp", "2"])
