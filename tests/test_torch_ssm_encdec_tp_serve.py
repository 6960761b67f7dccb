"""Tensor-parallel serving of the SSM, hybrid and encoder-decoder families
(mamba2-780m, zamba2-2.7b, whisper-large-v3) against the JAX package, on
the CPU: ranks of ``gloo`` processes
(``launch/gossip.py::run_on_grid(..., device="cpu")``), at smoke sizes.

Cases: mamba2's and zamba2's smoke configs (8 Mamba2 heads of 16, d_state
16, chunks of 16; zamba2's shared block 4 heads of 16 over 4 KV heads) at
tp = 2 and 4, each with a chunked prompt (32 tokens: the chunked SSD) and
a ragged one (20: the sequential oracle); whisper's (4 heads of 32, 2
encoder layers over 30 frames) at tp = 2, where its 512-row ``tok_embed``
is vocab-parallel, and with 51,866 rows at tp = 4, where the rules keep
it whole (51,866 = 2 x 25,933).  Parameters come from JAX ``init``
through ``convert.lm_params_from_numpy`` and ``train.shard.shard_params``,
every leaf ``init`` fills with zeros or ones redrawn from a numpy seed
first (the RMSNorm offsets, the gated norm's, the biases, LayerNorm
scales, ``D``, zamba2's ``lora_b``), so a wrong slice of any of them shows.

Held:

* **Steps.** The port's ``make_prefill_step`` and three
  ``make_serve_step`` steps on each rank against JAX's, which runs on a
  one-device CPU mesh with ``attn_impl="flashref"``, both with a float32
  cache; the port is fed JAX's greedy tokens, so every step compares.
  Every rank's logits are within 1e-5 x max|JAX logit| (the repo's f32
  pin), and its greedy tokens equal JAX's.
* **Cache.** Each rank's cache after the prefill and after the steps is
  the slice, by the step's ``cspecs`` (``conv_B``/``conv_C`` whole), of
  the one-process port's, within 1e-5 x the leaf's max|value|.
* **Norm.** ``layers.rms_norm(..., tp=)`` on a rank's slice of the width
  is the slice of the whole norm at rtol 1e-6, at tp = 2 and 4.
* **Shards.** ``init_shard`` at tp = 2 and 4 is, rank by rank, the slice
  of ``init_shard`` at tp = 1, bit for bit, for the three trees; its
  draws follow ``init``'s: LayerNorm scales and ``D`` are ones, ``A_log``
  is JAX's log(linspace(1, 16, heads)), ``dt_bias`` the inverse softplus
  of a dt in [1e-3, 1e-1], the normal draws at ``init``'s std.
* **Specs.** The steps' param and cache specs equal JAX's for the three
  full configs at model = 2 and 4, but for Mamba2's ``conv_B``/``conv_C``
  caches, which the rules split on d_state and the port holds whole.
* **Launcher.** ``launch.serve.main`` at ``--tp 1`` and ``--tp 2`` prints
  the same greedy tokens for mamba2 and whisper.
* **Refusal.** A batch equal to a stacking dim of zamba2's cache is
  refused by the steps' cache check; one that is not passes.
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
from repro.config import get_model_config as j_full  # noqa: E402
from repro.config import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import lm_engine as JE  # noqa: E402
from repro.launch.mesh import make_mesh_from_config  # noqa: E402
from repro.models import api as JA  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.api import Ctx as JCtx  # noqa: E402
from repro.train import sharding as JS  # noqa: E402
from repro_torch.config import MeshConfig, ShapeConfig  # noqa: E402
from repro_torch.config import get_model_config  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import gossip as tlaunch  # noqa: E402
from repro_torch.launch import lm_engine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.optim.optimizers import tree_map_with_path  # noqa: E402
from repro_torch.train import sharding as S  # noqa: E402
from repro_torch.train.shard import (  # noqa: E402
    WHOLE_CACHE,
    init_shard,
    model_split,
    rank_cache_pspecs,
    shard_cache,
    shard_params,
)

torch.set_num_threads(2)

B, STEPS = 4, 3
LOGIT_TOL = 1e-5      # x max|JAX logit|: the repo's f32 pin
CACHE_TOL = 1e-5      # x the leaf's max|value|
NORM_RTOL = 1e-6
BIAS_STD = 0.2        # zero/one leaves redrawn: 0 + N, 1 + N
LORA_B_STD = 1.0      # tests/test_torch_lm_ssm.py's draw of zamba2's lora_b
ARCHS = ("mamba2-780m", "zamba2-2.7b", "whisper-large-v3")
CASES = {             # name -> (arch, tp, config overrides, prompt length)
    "mamba2-tp2": ("mamba2-780m", 2, {}, 32),
    "mamba2-tp4": ("mamba2-780m", 4, {}, 32),
    "mamba2-ragged-tp2": ("mamba2-780m", 2, {}, 20),
    "mamba2-ragged-tp4": ("mamba2-780m", 4, {}, 20),
    "zamba2-tp2": ("zamba2-2.7b", 2, {}, 32),
    "zamba2-tp4": ("zamba2-2.7b", 4, {}, 32),
    "zamba2-ragged-tp2": ("zamba2-2.7b", 2, {}, 20),
    "zamba2-ragged-tp4": ("zamba2-2.7b", 4, {}, 20),
    # 512 rows: tok_embed vocab-parallel at 2 ranks
    "whisper-tp2": ("whisper-large-v3", 2, {}, 20),
    # whisper's 51,866 rows: whole at 4 ranks, so no gather
    "whisper-v51866-tp4": ("whisper-large-v3", 4, {"vocab_size": 51866}, 20),
}
NORM_SHAPE = (3, 5, 96)   # (B, L, width): the width split 2 and 4 ways


def _cfgs(name):
    arch, tp, over, prompt = CASES[name]
    return (dataclasses.replace(j_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over), tp, prompt)


def _redraw(npp, seed=11):
    """JAX ``init``'s tree with every leaf it fills with a constant
    redrawn: zeros as N(0, BIAS_STD^2) (lora_b N(0, LORA_B_STD^2)), ones as
    1 + N(0, BIAS_STD^2)."""

    rng = np.random.default_rng(seed)

    def visit(tree):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                visit(leaf)
                continue
            if leaf.size < 2 or np.ptp(leaf) > 0:
                continue
            std = LORA_B_STD if name == "lora_b" else BIAS_STD
            tree[name] = (leaf + rng.normal(size=leaf.shape) * std).astype(
                leaf.dtype)

    visit(npp)
    return npp


def _batch(cfg, prompt, seed=3):
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    batch["tokens"] = rng.integers(0, cfg.vocab_size,
                                   (B, prompt)).astype(np.int32)
    return batch


def jax_run(name):
    """JAX's prefill + STEPS greedy decode steps on a one-device mesh
    (float32 cache): (numpy params, batch, logits per step, tokens fed),
    run once for the cases that differ only in their ranks."""

    arch, _, over, prompt = CASES[name]
    return _jax_run(arch, tuple(sorted(over.items())), prompt)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, over, prompt):
    jcfg = dataclasses.replace(j_smoke(arch), **dict(over))
    mcfg = JMesh(pod=1, data=1, model=1, fsdp=False)
    mesh = make_mesh_from_config(mcfg)
    model = j_build(jcfg, JCtx(attn_impl="flashref",
                               cache_dtype=jnp.float32))
    npp = _redraw(jax.tree.map(np.asarray,
                               model.init(jax.random.PRNGKey(0))))
    params = jax.tree.map(jnp.asarray, npp)
    max_len = prompt + STEPS
    batch = _batch(jcfg, prompt)
    prefill, _ = JE.make_prefill_step(
        model, mesh, mcfg, JShape("p", prompt, B, "prefill"), max_len)
    decode, _ = JE.make_serve_step(model, mesh, mcfg,
                                   JShape("d", max_len, B, "decode"))
    logits, cache = prefill(params, batch)
    out, fed = [np.asarray(logits)], []
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        fed.append(np.asarray(tok))
        logits, cache = decode(params, cache, tok, prompt + i)
        out.append(np.asarray(logits))
    return npp, batch, out, fed


def _np(cache):
    return tree_map_with_path(lambda _, x: x.float().numpy().copy(), cache)


def _serve(cfg, group, mesh_cfg, params_np, batch, fed, rank):
    """Prefill + decode steps fed ``fed`` on one rank (float32 cache):
    logits (numpy) of every step, the cache shard after the prefill and at
    the end, and the steps' specs."""

    prompt = batch["tokens"].shape[1]
    max_len = prompt + STEPS
    model = build_model(cfg, Ctx(attn_impl="kernel",
                                 cache_dtype=torch.float32), device="cpu")
    prefill, info = lm_engine.make_prefill_step(
        model, group, mesh_cfg, ShapeConfig("p", prompt, B, "prefill"),
        max_len)
    decode, dinfo = lm_engine.make_serve_step(
        model, group, mesh_cfg, ShapeConfig("d", max_len, B, "decode"))
    full = lm_params_from_numpy(params_np, "cpu")
    params = shard_params(full, info["pspecs"], mesh_cfg, rank)
    logits, cache = prefill(params, batch)
    after_prefill = _np(cache)
    out = [logits.float().numpy()]
    for i, tok in enumerate(fed):
        logits, cache = decode(params, cache, torch.tensor(tok),
                               prompt + i)
        out.append(logits.float().numpy())
    split = info["model"].ctx.tp.split if info["model"].ctx.tp else None
    return {"logits": out, "prefill_cache": after_prefill,
            "cache": _np(cache), "cspecs": info["cspecs"],
            "decode_cspecs": dinfo["cspecs"], "split": split}


def _norm_inputs(seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(NORM_SHAPE).astype(np.float32),
            (rng.standard_normal(NORM_SHAPE[-1]) * BIAS_STD).astype(
                np.float32))


def _norm_job(rank, device, tp_size):
    """The sharded norm on this rank's slice of the width."""

    import torch.distributed as dist
    x, w = _norm_inputs()
    n = x.shape[-1] // tp_size
    tp = TL.TP.of(dist.group.WORLD, device)
    cut = slice(rank * n, (rank + 1) * n)
    got = TL.rms_norm(torch.from_numpy(x[..., cut]),
                      torch.from_numpy(w[cut]), tp=tp)
    return got.numpy()


def _rank(rank, device, jobs):
    import torch.distributed as dist
    tp = dist.get_world_size()
    out = []
    for job in jobs:
        if job is None:
            out.append(_norm_job(rank, device, tp))
            continue
        cfg, params_np, batch, fed = job
        mesh_cfg = MeshConfig(data=1, model=tp, fsdp=False)
        out.append(_serve(cfg, dist.group.WORLD, mesh_cfg, params_np, batch,
                          fed, rank))
    return out


@functools.lru_cache(maxsize=None)
def grid_run(tp):
    """Every step case of ``tp`` ranks and the norm job, in one grid:
    {case or "norm": [rank results]}."""

    names, jobs = ["norm"], [None]
    for name in CASES:
        _, cfg, case_tp, _ = _cfgs(name)
        if case_tp != tp:
            continue
        npp, batch, _, fed = jax_run(name)
        names.append(name)
        jobs.append((cfg, npp, batch, fed))
    ranks = tlaunch.run_on_grid(_rank, (1, tp), jobs, device="cpu",
                                timeout=300)
    return {key: [r[i] for r in ranks] for i, key in enumerate(names)}


@pytest.mark.parametrize("name", list(CASES))
def test_tp_steps_match_jax(name):
    _, cfg, tp, _ = _cfgs(name)
    _, _, want, fed = jax_run(name)
    ranks = grid_run(tp)[name]
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


@pytest.mark.parametrize("name", list(CASES))
def test_tp_cache_shards_are_slices_of_the_one_process_cache(name):
    _, cfg, tp, _ = _cfgs(name)
    npp, batch, _, fed = jax_run(name)
    mesh_cfg = MeshConfig(data=1, model=tp, fsdp=False)
    one = _serve(cfg, None, MeshConfig(data=1, model=1, fsdp=False), npp,
                 batch, fed, 0)
    ranks = grid_run(tp)[name]
    for key in ("prefill_cache", "cache"):
        full = tree_map_with_path(lambda _, x: torch.tensor(x), one[key])
        for r, res in enumerate(ranks):
            want = shard_cache(full, res["cspecs"], mesh_cfg, r)
            pairs = []
            tree_map_with_path(lambda p, g, w: pairs.append((p, g, w.numpy())),
                               res[key], want)
            assert pairs
            for path, g, w in pairs:
                assert g.shape == w.shape, path
                tol = CACHE_TOL * max(float(np.abs(w).max()), 1e-30)
                assert float(np.abs(g - w).max()) <= tol, (name, key, r,
                                                           path)
    # the caches split by head: SSM states by Mamba head, KV by head; B/C
    # conv registers whole
    res = ranks[0]
    assert res["cspecs"] == res["decode_cspecs"]
    if cfg.family in ("ssm", "hybrid"):
        st = (res["cache"]["units"]["s0"] if cfg.family == "ssm"
              else res["cache"]["ssm"])
        nheads = cfg.ssm.n_heads(cfg.d_model)
        assert st.h.shape[-3] == nheads // tp
        assert st.conv_x.shape[-1] == cfg.ssm.d_inner(cfg.d_model) // tp
        assert st.conv_B.shape[-1] == st.conv_C.shape[-1] == cfg.ssm.d_state
    if cfg.family == "hybrid":
        assert res["cache"]["kv"].k.shape[-3] == cfg.num_kv_heads // tp
    if cfg.family == "encdec":
        c = res["cache"]
        assert c.self_kv.k.shape[-3] == c.cross_k.shape[-3] == \
            cfg.num_heads // tp


def test_tok_embed_split_where_its_rows_divide():
    """whisper's ``tok_embed`` is vocab-parallel at 2 ranks with 512 rows
    and whole at 4 with 51,866 (the full config's 51,866 split at 2:
    ``test_step_specs_equal_jax_but_whole_conv_registers``)."""

    assert "tok_embed" in grid_run(2)["whisper-tp2"][0]["split"]
    assert "tok_embed" not in grid_run(4)["whisper-v51866-tp4"][0]["split"]


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_norm_is_the_slice_of_the_whole(tp):
    x, w = _norm_inputs()
    want = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    n = x.shape[-1] // tp
    ranks = grid_run(tp)["norm"]
    assert len(ranks) == tp
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got, want[..., r * n:(r + 1) * n],
                                   rtol=NORM_RTOL, atol=0)
    # a rank's own mean of squares would be another function
    own = TL.rms_norm(torch.from_numpy(x[..., :n]),
                      torch.from_numpy(w[:n])).numpy()
    assert not np.allclose(own, want[..., :n], rtol=1e-3)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_shard_concatenates_to_one_rank(arch, tp):
    cfg = get_smoke_config(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shard_follows_init_distributions(arch):
    cfg = get_smoke_config(arch)
    ref = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    got = init_shard(0, cfg, None, MeshConfig(data=1, model=1, fsdp=False),
                     0, "cpu")
    jref = jax.tree.map(np.asarray, j_build(j_smoke(arch), JCtx()).init(
        jax.random.PRNGKey(0)))
    pairs = []
    tree_map_with_path(lambda p, g, w: pairs.append((p, g, w)), got, ref)
    assert len(pairs) > 10
    names = set()
    for path, g, w in pairs:
        name = S.leaf_name(path)
        names.add(name)
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if name == "A_log":
            # init's values, and JAX's within float32 rounding (the two
            # linspaces differ in the last place)
            assert torch.equal(g, w), path
            want = np.log(np.asarray(jnp.linspace(1.0, 16.0, g.shape[-1])))
            np.testing.assert_allclose(g.numpy(), np.broadcast_to(
                want, g.shape), rtol=1e-6, atol=0)
            continue
        if name == "dt_bias":
            dt = torch.nn.functional.softplus(g)
            assert float(dt.min()) >= 1e-3 * (1 - 1e-5), path
            assert float(dt.max()) <= 1e-1 * (1 + 1e-5), path
            assert len(torch.unique(g)) == g.numel(), path
            continue
        if bool((w == w.flatten()[0]).all()):     # a constant leaf
            assert torch.equal(g, w), path
            continue
        ratio = float(g.std()) / float(w.std())
        assert 0.9 < ratio < 1.1, (path, ratio)
        assert abs(float(g.mean())) < 0.1 * float(w.std()), path
    if arch != "whisper-large-v3":
        assert {"A_log", "D", "dt_bias"} <= names
        assert (jref["units"]["s0"]["ssm"]["D"] if arch == "mamba2-780m"
                else jref["units"]["mamba"]["ssm"]["D"]).min() == 1.0
    else:
        assert "w" in names            # the LayerNorm scales: ones
        assert jref["enc_ln"]["w"].min() == jref["enc_ln"]["w"].max() == 1.0
        assert bool((got["enc_layers"]["ln1"]["w"] == 1).all())


def _jflat(shapes, specs):
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jax.tree_util.keystr(p): (tuple(x.shape), tuple(s))
            for (p, x), s in zip(leaves, spec_leaves)}


def _tflat(shapes, specs):
    out = {}
    tree_map_with_path(
        lambda p, x, s: out.__setitem__(p, (tuple(x.shape), tuple(s))),
        shapes, specs)
    return out


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_specs_equal_jax_but_whole_conv_registers(arch, tp):
    """The full configs on ``meta``: the specs the steps cut params and
    caches by are JAX's, but for Mamba2's B/C conv registers, which JAX's
    rule splits on d_state and a rank holds whole; ``model_split`` takes
    them without a refusal."""

    batch, max_len = 4, 448
    jm = j_build(j_full(arch))
    tm = build_model(get_model_config(arch), device="meta")
    jmesh = JMesh(pod=1, data=1, model=tp, fsdp=False)
    tmesh = MeshConfig(data=1, model=tp, fsdp=False)
    jshapes, tshapes = JA.param_specs(jm), api.param_specs(tm)
    tspecs = S.param_pspecs(tm.cfg, tshapes, tmesh)
    assert _tflat(tshapes, tspecs) == _jflat(
        jshapes, JS.param_pspecs(jm.cfg, jshapes, jmesh))
    split = model_split(tshapes, tspecs)
    assert ("tok_embed" in split) == (arch == "whisper-large-v3" and tp == 2)
    jc, tc = JA.cache_specs(jm, batch, max_len), api.cache_specs(tm, batch,
                                                                 max_len)
    js = JShape("d", max_len, batch, "decode")
    ts = ShapeConfig("d", max_len, batch, "decode")
    want = _jflat(jc, JS.cache_pspecs_tree(jm.cfg, js, jmesh, jc))
    got = _tflat(tc, rank_cache_pspecs(
        tc, S.cache_pspecs_tree(tm.cfg, ts, tmesh, tc)))
    assert set(got) == set(want)
    differ = sorted(p for p in got if got[p] != want[p])
    if arch == "whisper-large-v3":
        assert differ == []
        return
    assert [S.leaf_name(p) for p in differ] == sorted(WHOLE_CACHE)
    for p in differ:
        # whole over "model" (JAX's d_state cut dropped), the batch's
        # entry JAX's
        (shape, spec), (_, jspec) = got[p], want[p]
        assert jspec[-1] == "model" and "model" not in spec
        assert spec == tuple(None if e == "model" else e for e in jspec)


@pytest.mark.parametrize("arch", ["mamba2-780m", "whisper-large-v3"])
def test_launcher_tp2_prints_the_tp1_tokens(arch, monkeypatch, capsys):
    monkeypatch.setattr(serve, "get_model_config", get_smoke_config)
    argv = ["--arch", arch, "--batch", "2", "--seq-len", "16", "--steps",
            "3", "--device", "cpu"]
    one = serve.main(argv + ["--tp", "1"])
    two = serve.main(argv + ["--tp", "2"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "greedy tokens" in ln]
    assert len(lines) == 2 and lines[0] == lines[1]
    assert one["ranks"][0]["tokens"] == two["ranks"][1]["tokens"]
    assert len(two["ranks"]) == 2 and two["backend"] == "gloo"
    assert "tok/s" in out
    # a rank holds fewer parameter bytes than the whole model
    assert two["ranks"][0]["param_bytes"] < one["ranks"][0]["param_bytes"]


@pytest.mark.parametrize("batch,refused", [(2, True), (4, False)])
def test_batch_equal_to_a_stacking_dim_is_refused(batch, refused):
    """zamba2's smoke cache stacks 2 units of 2 Mamba layers: at a batch
    of 2 the cache rule takes a stacking dim for the batch and puts
    ``"model"`` on it, not on the Mamba heads a rank holds; the steps
    refuse that layout (zamba2's 9 units refuse a batch of 9)."""

    cfg = get_smoke_config("zamba2-2.7b")
    model = build_model(cfg, device="cpu")
    mesh_cfg = MeshConfig(data=1, model=2, fsdp=False)
    cshapes = api.cache_specs(model, batch, 16)
    cspecs = rank_cache_pspecs(cshapes, S.cache_pspecs_tree(
        cfg, ShapeConfig("d", 16, batch, "decode"), mesh_cfg, cshapes))
    shapes = api.param_specs(model)
    split = model_split(shapes, S.param_pspecs(cfg, shapes, mesh_cfg))
    tp = TL.TP(group=None, rank=0, size=2, staged=False, split=split)
    tp_model = build_model(cfg, Ctx(tp=tp), device="cpu")
    if refused:
        with pytest.raises(NotImplementedError, match="stacking dim"):
            lm_engine._check_cache(tp_model, cshapes, cspecs, mesh_cfg,
                                   batch, 16)
    else:
        lm_engine._check_cache(tp_model, cshapes, cspecs, mesh_cfg, batch,
                               16)
