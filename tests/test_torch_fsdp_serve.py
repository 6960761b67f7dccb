"""Data-parallel and FSDP LM serving of the port against the JAX package,
on the CPU: four ``gloo`` ranks (``launch/gossip.py::run_on_grid(...,
device="cpu")``) on ``pod x data x model`` grids, at smoke sizes.

Cases, every one in one grid of four ranks: qwen1.5-32b's smoke config at
(data 2, model 2) with FSDP on and off, and at (pod 2, data 2, model 1);
internvl2-76b's (8 stub patch tokens; its projector gathered), granite-
moe-3b-a800m's in the psum and a2a expert-parallel forms and deepseek-v2-
lite-16b's (MLA, its latent cache cut on the batch; its head sublayer
gathered apart from its units) at (2, 2) with FSDP.  Parameters come from
JAX ``init`` through ``convert.lm_params_from_numpy`` and
``train.shard.shard_params``.

Held:

* **Steps.** ``make_prefill_step`` and three ``make_serve_step`` steps on
  every rank against JAX's one-device steps (``attn_impl="flashref"``,
  a float32 cache on both sides), the port fed JAX's greedy tokens: every
  rank's full (B, V) logits within 1e-5 x max|JAX logit| (the repo's f32
  pin) and its greedy tokens JAX's.  The a2a form's decode cannot split
  one token over the model ranks and raises ``ValueError``, as the JAX
  package's ``shard_map`` fails there; its prefill is held.  qwen with
  FSDP is also held against JAX's own sharded steps on a (2, 2) mesh of
  host devices with ``fsdp=True`` (a subprocess under
  ``--xla_force_host_platform_device_count=4``, as
  ``tests/test_distributed.py::run_prog`` runs one), at the same bound.
* **Gathers.** A rank's decode makes one FSDP all-gather a unit (and one
  for deepseek's head sublayer), not one a leaf, and the shards of a
  unit lie in one contiguous run that the gather takes as a view.
* **Shards and specs.** ``init_shard`` at (2, 2) and (pod 2, data 2,
  model 1) is, rank by rank, the slice of ``init_shard`` at 1 x 1 x 1, bit
  for bit; an FSDP rank holds a quarter of every leaf split on both
  axes; a rank's parameter and cache bytes equal ``shard_nbytes`` of the
  specs; the steps' specs equal JAX's at these meshes.
* **Launcher.** ``launch.serve.main`` at ``--tp 1``, ``--data 2 --tp 2``
  and ``--multi-pod --data 1 --tp 2`` prints the same greedy tokens, and
  rank 0's FSDP gathers one a unit.
* **Whole batches and the other families.** A batch that does not split
  over ``pod x data`` (B = 3 on (2, 2), B = 6 on (pod 2, data 2, model
  1)) serves whole on every rank and matches JAX's one-device steps;
  mamba2 and zamba2 serve on data ranks, with the tokens of one process
  (``tests/test_torch_long_context_serve.py`` holds them against JAX).
* **Refusals.** The encoder-decoder family on data ranks (item 6.8.2c),
  MLA's latent cache at a batch that does not split (6.8.2e), experts
  split on their width (6.8.2d) and training on the grid raise
  ``NotImplementedError`` naming their item.
"""

import dataclasses
import functools
import os
import subprocess
import sys

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
from repro.train import sharding as JS  # noqa: E402
from repro_torch.config import MeshConfig, ShapeConfig  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import gossip as tlaunch  # noqa: E402
from repro_torch.launch import lm_engine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.optimizers import tree_map_with_path  # noqa: E402
from repro_torch.train import sharding as S  # noqa: E402
from repro_torch.train.shard import (  # noqa: E402
    fsdp_split,
    init_shard,
    model_split,
    shard_nbytes,
    shard_params,
)

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, PROMPT, STEPS = 4, 16, 3
LOGIT_TOL = 1e-5      # x max|JAX logit|: the repo's f32 pin
MESHES = {
    "2x2": dict(pod=1, data=2, model=2, fsdp=True),
    "2x2-no-fsdp": dict(pod=1, data=2, model=2, fsdp=False),
    "pods-2x2x1": dict(multi_pod=True, pod=2, data=2, model=1, fsdp=True),
}
CASES = {             # name -> (arch, mesh, MoE form)
    "qwen-fsdp": ("qwen1.5-32b", "2x2", "psum"),
    "qwen-no-fsdp": ("qwen1.5-32b", "2x2-no-fsdp", "psum"),
    "qwen-pods": ("qwen1.5-32b", "pods-2x2x1", "psum"),
    "internvl2-fsdp": ("internvl2-76b", "2x2", "psum"),
    "granite-moe-psum": ("granite-moe-3b-a800m", "2x2", "psum"),
    "granite-moe-a2a": ("granite-moe-3b-a800m", "2x2", "a2a"),
    "deepseek-fsdp": ("deepseek-v2-lite-16b", "2x2", "psum"),
}


def _patches(cfg):
    return cfg.num_patch_tokens if cfg.family == "vlm" else 0


def _batch(cfg, seed=3, batch_size=B):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (batch_size, PROMPT))
             .astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (batch_size, cfg.num_patch_tokens, 1024)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def jax_run(arch, batch_size=B):
    """JAX's prefill + STEPS greedy decode steps on a one-device mesh
    (float32 cache) at a batch of ``batch_size``: (numpy params, batch,
    logits per step, tokens fed)."""

    jcfg = j_smoke(arch)
    mcfg = JMesh(pod=1, data=1, model=1, fsdp=False)
    mesh = make_mesh_from_config(mcfg)
    model = j_build(jcfg, JCtx(attn_impl="flashref",
                               cache_dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0))
    P = _patches(jcfg)
    max_len = P + PROMPT + STEPS
    batch = _batch(jcfg, batch_size=batch_size)
    prefill, _ = JE.make_prefill_step(
        model, mesh, mcfg, JShape("p", PROMPT, batch_size, "prefill"),
        max_len)
    decode, _ = JE.make_serve_step(
        model, mesh, mcfg, JShape("d", max_len - P, batch_size, "decode"))
    logits, cache = prefill(params, batch)
    out, fed = [np.asarray(logits)], []
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        fed.append(np.asarray(tok))
        logits, cache = decode(params, cache, tok, P + PROMPT + i)
        out.append(np.asarray(logits))
    return jax.tree.map(np.asarray, params), batch, out, fed


def _nbytes(tree) -> int:
    total = []
    tree_map_with_path(lambda _, x: total.append(x.numel()
                                                 * x.element_size()), tree)
    return sum(total)


def _case(rank, device, cfg, mesh_kw, moe_impl, params_np, batch, fed):
    """One case on one rank: prefill + decode steps fed ``fed``; the
    logits of every step (numpy), the rank's bytes, its decode's FSDP
    gathers and the a2a decode's refusal."""

    import torch.distributed as dist
    mesh_cfg = MeshConfig(**mesh_kw)
    model = build_model(cfg, Ctx(attn_impl="kernel", moe_impl=moe_impl,
                                 cache_dtype=torch.float32), device=device)
    P = _patches(cfg)
    max_len = P + PROMPT + STEPS
    Bx = batch["tokens"].shape[0]
    prefill, info = lm_engine.make_prefill_step(
        model, dist.group.WORLD, mesh_cfg,
        ShapeConfig("p", PROMPT, Bx, "prefill"), max_len)
    decode, dinfo = lm_engine.make_serve_step(
        model, dist.group.WORLD, mesh_cfg,
        ShapeConfig("d", max_len - P, Bx, "decode"))
    params = shard_params(lm_params_from_numpy(params_np, device),
                          info["pspecs"], mesh_cfg, rank)
    fsdp = dinfo["model"].ctx.fsdp
    if fsdp is not None:
        fsdp.timed = True
    logits, cache = prefill(params, batch)
    out = {"logits": [logits.numpy()], "param_bytes": _nbytes(params),
           "cache_bytes": _nbytes(cache), "decode_error": None,
           "fsdp_calls": None, "tp": dinfo["model"].ctx.tp_size}
    try:
        for i, tok in enumerate(fed):
            logits, cache = decode(params, cache, tok, P + PROMPT + i)
            out["logits"].append(logits.numpy())
    except ValueError as err:
        out["decode_error"] = str(err)
    if fsdp is not None:
        out["fsdp_calls"] = fsdp.stats.get("all_gather", [0])[0]
    return out


def _rank(rank, device, jobs):
    return [_case(rank, device, *job) for job in jobs]


@functools.lru_cache(maxsize=None)
def grid_run():
    """Every case in one grid of four ranks: {case: [rank results]}."""

    jobs = []
    for arch, mesh, impl in CASES.values():
        npp, batch, _, fed = jax_run(arch)
        jobs.append((get_smoke_config(arch), MESHES[mesh], impl, npp, batch,
                     fed))
    ranks = tlaunch.run_on_grid(_rank, (2, 2), jobs, device="cpu",
                                timeout=300)
    return {name: [r[i] for r in ranks] for i, name in enumerate(CASES)}


def _hold(name, ranks, want, fed, steps):
    for r, res in enumerate(ranks):
        assert len(res["logits"]) == steps, (name, r)
        for step, (got, ref) in enumerate(zip(res["logits"], want)):
            assert got.shape == ref.shape
            bound = LOGIT_TOL * float(np.abs(ref).max())
            err = float(np.abs(got - ref).max())
            assert err <= bound, (name, r, step, err, bound)
            # every rank holds the full logits and picks JAX's tokens
            want_tok = fed[step] if step < STEPS else ref.argmax(-1)
            np.testing.assert_array_equal(got.argmax(-1), want_tok)


@pytest.mark.parametrize("name", list(CASES))
def test_grid_steps_match_jax(name):
    arch, _, impl = CASES[name]
    _, _, want, fed = jax_run(arch)
    ranks = grid_run()[name]
    assert len(ranks) == 4
    if impl == "a2a":
        # one token does not split over the model ranks, as in JAX
        for res in ranks:
            assert "does not split" in res["decode_error"]
        _hold(name, ranks, want, fed, 1)
    else:
        assert all(res["decode_error"] is None for res in ranks)
        _hold(name, ranks, want, fed, STEPS + 1)


JAX_SHARDED = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.config import ShapeConfig, get_smoke_config
from repro.launch import lm_engine as JE
from repro.launch.mesh import mesh_config_for
from repro.models import build_model
from repro.models.api import Ctx
from repro.train.step import shardings_for
d = np.load(sys.argv[1])
tokens, fed = d["tokens"], d["fed"]
mesh = make_mesh((2, 2), ("data", "model"))
mcfg = mesh_config_for(mesh, multi_pod=False, fsdp=True)
model = build_model(get_smoke_config("qwen1.5-32b"),
                    Ctx(attn_impl="flashref", cache_dtype=jnp.float32,
                        mesh=mesh, dp=("data",)))
Bx, Lx = tokens.shape
max_len = Lx + len(fed)
prefill, info = JE.make_prefill_step(
    model, mesh, mcfg, ShapeConfig("p", Lx, Bx, "prefill"), max_len)
decode, _ = JE.make_serve_step(model, mesh, mcfg,
                               ShapeConfig("d", max_len, Bx, "decode"))
assert any("data" in tuple(s) for s in jax.tree.leaves(
    info["pspecs"], is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
params = jax.device_put(model.init(jax.random.PRNGKey(0)),
                        shardings_for(mesh, info["pspecs"]))
batch = jax.device_put({"tokens": tokens}, shardings_for(mesh, info["bspecs"]))
logits, cache = prefill(params, batch)
out = [np.asarray(logits)]
for i, tok in enumerate(fed):
    logits, cache = decode(params, cache, jnp.asarray(tok), Lx + i)
    out.append(np.asarray(logits))
np.save(sys.argv[2], np.stack(out))
"""


def test_fsdp_ranks_match_jax_sharded_steps(tmp_path):
    """qwen at (2, 2) with FSDP against JAX's own sharded steps on four
    host devices, fed the same tokens."""

    _, batch, one_device, fed = jax_run("qwen1.5-32b")
    np.savez(tmp_path / "in.npz", tokens=batch["tokens"], fed=np.stack(fed))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(_ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    run = subprocess.run(
        [sys.executable, "-c", JAX_SHARDED, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npy")], capture_output=True, text=True,
        env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    want = list(np.load(tmp_path / "out.npy"))
    assert len(want) == STEPS + 1
    # JAX's sharded steps are its one-device steps' within the pin
    for w, o in zip(want, one_device):
        assert np.abs(w - o).max() <= LOGIT_TOL * np.abs(o).max()
    _hold("qwen-fsdp", grid_run()["qwen-fsdp"], want, fed, STEPS + 1)


def _units(cfg):
    return cfg.num_layers - (1 if cfg.mla is not None else 0)


@pytest.mark.parametrize("name", [n for n, (_, m, i) in CASES.items()
                                  if MESHES[m]["fsdp"] and i == "psum"])
def test_fsdp_gathers_once_a_unit(name):
    arch, _, _ = CASES[name]
    cfg = get_smoke_config(arch)
    heads = 1 if cfg.mla is not None else 0
    for res in grid_run()[name]:
        # the decode steps: one gather a unit and a head sublayer
        assert res["fsdp_calls"] == STEPS * (_units(cfg) + heads), name


def test_a_units_shards_are_one_run_the_gather_views():
    cfg = get_smoke_config("qwen1.5-32b")
    model = build_model(cfg, device="cpu")
    shapes = api.param_specs(model)
    mesh_cfg = MeshConfig(data=2, model=2, fsdp=True)
    pspecs = S.param_pspecs(cfg, shapes, mesh_cfg)
    split = fsdp_split(shapes, pspecs)
    assert set(split) == {"units"}
    assert split["units"] == {
        ("s0", "attn", "wq"): -2, ("s0", "attn", "wk"): -2,
        ("s0", "attn", "wv"): -2, ("s0", "attn", "wo"): -1,
        ("s0", "mlp", "wi_gate"): -2, ("s0", "mlp", "wi_up"): -2,
        ("s0", "mlp", "wo"): -1}
    full = init_shard(0, cfg, None, MeshConfig(data=1, model=1, fsdp=False),
                      0, "cpu")
    for params in (shard_params(full, pspecs, mesh_cfg, 3),
                   init_shard(0, cfg, None, mesh_cfg, 3, "cpu")):
        unit = T._index(params["units"], 1)
        xs = [L.leaf_at(unit, keys) for keys in split["units"]]
        flat, view = L._flat(xs)
        assert view and flat.numel() == sum(x.numel() for x in xs)
        assert (flat.untyped_storage().data_ptr()
                == xs[0].untyped_storage().data_ptr())
        assert torch.equal(flat, torch.cat([x.reshape(-1) for x in xs]))
    # a gather of a group of one rank is the tree itself
    one = L.FSDP.dry(1, split)
    assert one.gather(unit, "units") is unit


@pytest.mark.parametrize("mesh", ["2x2", "pods-2x2x1"])
@pytest.mark.parametrize("arch", ["qwen1.5-32b", "internvl2-76b",
                                  "granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_init_shard_on_the_grid_is_the_one_process_slice(arch, mesh):
    cfg = get_smoke_config(arch)
    mesh_cfg = MeshConfig(**MESHES[mesh])
    ctx = Ctx(ep_pad_to=mesh_cfg.model if cfg.moe is not None else 0)
    full = init_shard(7, cfg, ctx, MeshConfig(data=1, model=1, fsdp=False),
                      0, "cpu")
    shapes = api.param_specs(build_model(cfg, ctx, device="meta"))
    specs = S.param_pspecs(cfg, shapes, mesh_cfg)
    both = 0
    for r in range(mesh_cfg.num_devices):
        got = init_shard(7, cfg, ctx, mesh_cfg, r, "cpu")
        want = shard_params(full, specs, mesh_cfg, r)
        assert _nbytes(got) == shard_nbytes(shapes, specs, mesh_cfg)
        pairs = []
        tree_map_with_path(lambda p, g, w, s, x: pairs.append((p, g, w, s, x)),
                           got, want, specs, shapes)
        for path, g, w, spec, x in pairs:
            assert g.dtype == w.dtype and torch.equal(g, w), (path, r)
            axes = {a for e in spec if e for a in
                    ((e,) if isinstance(e, str) else e)}
            if {"data", "model"} <= axes and mesh_cfg.model > 1:
                # an FSDP rank holds a quarter of a leaf split both ways
                assert 4 * g.numel() == x.numel(), path
                both += 1
    assert both > 0 or mesh_cfg.model == 1


def _jflat(shapes, specs):
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jax.tree_util.keystr(p): (tuple(x.shape), tuple(s))
            for (p, x), s in zip(leaves, spec_leaves)}


def _tflat(shapes, specs):
    out = {}
    tree_map_with_path(lambda p, x, s: out.__setitem__(
        p, (tuple(x.shape), tuple(s))), shapes, specs)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["qwen1.5-32b", "internvl2-76b",
                                  "granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_step_specs_equal_jax_on_the_grid(arch, mesh):
    """The steps' specs (built without a group on meta) against the JAX
    rules' at the grid's mesh, with the experts padded as both launchers
    pad them."""

    from repro.models import api as JA

    mesh_kw = MESHES[mesh]
    pad = mesh_kw["model"] if get_smoke_config(arch).moe else 0
    jm = j_build(j_smoke(arch), JCtx(ep_pad_to=pad))
    tm = build_model(get_smoke_config(arch), Ctx(ep_pad_to=pad),
                     device="meta")
    jmesh, tmesh = JMesh(**mesh_kw), MeshConfig(**mesh_kw)
    jshape = JShape("d", PROMPT, B, "decode")
    tshape = ShapeConfig("d", PROMPT, B, "decode")
    jp, tp = JA.param_specs(jm), api.param_specs(tm)
    assert _tflat(tp, S.param_pspecs(tm.cfg, tp, tmesh)) == _jflat(
        jp, JS.param_pspecs(jm.cfg, jp, jmesh))
    jc, tc = JA.cache_specs(jm, B, PROMPT), api.cache_specs(tm, B, PROMPT)
    assert _tflat(tc, S.cache_pspecs_tree(tm.cfg, tshape, tmesh, tc)) == \
        _jflat(jc, JS.cache_pspecs_tree(jm.cfg, jshape, jmesh, jc))
    jb, tb = JA.input_specs(jm.cfg, jshape), api.input_specs(tm.cfg, tshape)
    assert _tflat(tb, S.batch_pspecs(tm.cfg, tshape, tmesh, tb)) == \
        _jflat(jb, JS.batch_pspecs(jm.cfg, jshape, jmesh, jb))


@pytest.mark.parametrize("name", list(CASES))
def test_rank_bytes_are_shard_nbytes(name):
    arch, mesh, impl = CASES[name]
    cfg = get_smoke_config(arch)
    mesh_cfg = MeshConfig(**MESHES[mesh])
    pad = mesh_cfg.model if cfg.moe is not None and mesh_cfg.model > 1 else 0
    meta = build_model(cfg, Ctx(ep_pad_to=pad, cache_dtype=torch.float32),
                       device="meta")
    shapes = api.param_specs(meta)
    max_len = _patches(cfg) + PROMPT + STEPS
    cshapes = api.cache_specs(meta, B, max_len)
    shape = ShapeConfig("p", PROMPT, B, "prefill")
    cspecs = S.cache_pspecs_tree(cfg, shape, mesh_cfg, cshapes)
    pspecs = S.param_pspecs(cfg, shapes, mesh_cfg)
    for res in grid_run()[name]:
        assert res["param_bytes"] == shard_nbytes(shapes, pspecs, mesh_cfg)
        assert res["cache_bytes"] == shard_nbytes(cshapes, cspecs, mesh_cfg)
        assert res["tp"] == mesh_cfg.model


def test_launcher_grids_print_the_one_process_tokens(monkeypatch, capsys):
    monkeypatch.setattr(serve, "get_model_config", get_smoke_config)
    argv = ["--arch", "qwen1.5-32b", "--batch", "4", "--seq-len", "16",
            "--steps", "3", "--device", "cpu"]
    one = serve.main(argv + ["--tp", "1"])
    fsdp = serve.main(argv + ["--data", "2", "--tp", "2"])
    pods = serve.main(argv + ["--multi-pod", "--data", "1", "--tp", "2"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "greedy tokens" in ln]
    assert len(lines) == 3 and lines[0] == lines[1] == lines[2]
    for run in (fsdp, pods):
        assert len(run["ranks"]) == 4 and run["backend"] == "gloo"
        assert all(r["tokens"] == one["ranks"][0]["tokens"]
                   for r in run["ranks"])
    assert "on 1 x 2 x 2 (pod x data x model) rank(s), FSDP on" in out
    assert "on 2 x 1 x 2 (pod x data x model) rank(s), FSDP off" in out
    # rank 0 gathers its FSDP shards once a unit (3 units a step)
    assert "rank 0 fsdp_all_gather: 3 calls" in out
    assert "rank 0 batch_all_gather: 1 calls" in out
    grid, no_fsdp = fsdp["reckoned_bytes"]["grid"], \
        fsdp["reckoned_bytes"]["no_fsdp"]
    for r in fsdp["ranks"]:
        assert (r["param_bytes"], r["cache_bytes"]) == grid
    assert grid[0] < no_fsdp[0] and grid[1] == no_fsdp[1]


def _fake(size):
    return L.TP(group=None, rank=0, size=size, staged=False)


@pytest.mark.parametrize("batch", [3, 6])
def test_a_batch_that_does_not_split_is_refused(batch):
    """Item 6.8.2b, now served: at B = 3 over 2 data ranks, and B = 6 over
    2 pods x 2 data ranks, the rules keep the batch whole; every rank runs
    it whole and matches JAX's one-device steps (at B = 6 the KV cache is
    cut on its sequence over "data"; at B = 3 the rules take qwen's 3
    stacked layers for the batch and cut its heads)."""

    cfg = get_smoke_config("qwen1.5-32b")
    mesh = (dict(pod=1, data=2, model=2, fsdp=True) if batch == 3 else
            dict(multi_pod=True, pod=2, data=2, model=1, fsdp=True))
    npp, tokens, want, fed = jax_run("qwen1.5-32b", batch)
    ranks = [r[0] for r in tlaunch.run_on_grid(
        _rank, (2, 2), [(cfg, mesh, "psum", npp, tokens, fed)],
        device="cpu", timeout=300)]
    assert all(res["decode_error"] is None for res in ranks)
    _hold(f"qwen-b{batch}", ranks, want, fed, STEPS + 1)
    for res in ranks:
        # the whole batch's cache: B rows on every rank
        assert res["cache_bytes"] % batch == 0


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b",
                                  "whisper-large-v3"])
def test_the_other_families_on_data_ranks_are_refused(arch, monkeypatch,
                                                      capsys):
    """Item 6.8.2c: the encoder-decoder family is refused on data ranks;
    mamba2 and zamba2 serve there, with the one process's tokens."""

    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    shape = ShapeConfig("d", 16, 4, "decode")
    monkeypatch.setattr(serve, "get_model_config", get_smoke_config)
    argv = ["--arch", arch, "--batch", "4", "--seq-len", "16", "--steps",
            "2", "--device", "cpu"]
    if cfg.family == "encdec":
        with pytest.raises(NotImplementedError, match="item 6.8.2c"):
            lm_engine.make_serve_step(model, None,
                                      MeshConfig(data=2, model=1), shape)
        with pytest.raises(NotImplementedError, match="item 6.8.2c"):
            serve.main(argv + ["--multi-pod", "--data", "1"])
    else:
        one = serve.main(argv)
        pods = serve.main(argv + ["--multi-pod", "--data", "1"])
        assert len(pods["ranks"]) == 2
        assert all(r["tokens"] == one["ranks"][0]["tokens"]
                   for r in pods["ranks"])
        assert "FSDP off" in capsys.readouterr().out
    # the shards themselves are cut on any grid
    mesh_cfg = MeshConfig(data=2, model=1, fsdp=True)
    specs = S.param_pspecs(cfg, api.param_specs(model), mesh_cfg)
    full = init_shard(0, cfg, None, MeshConfig(data=1, model=1), 0, "cpu")
    pairs = []
    tree_map_with_path(lambda p, g, w: pairs.append(torch.equal(g, w)),
                       init_shard(0, cfg, None, mesh_cfg, 1, "cpu"),
                       shard_params(full, specs, mesh_cfg, 1))
    assert pairs and all(pairs)


@pytest.mark.parametrize("mesh", ["2x2", "pods-2x2x1"])
def test_mla_at_a_batch_that_does_not_split_is_refused(mesh, monkeypatch):
    """Item 6.8.2e: at B = 1 the rules cut MLA's c_kv and k_rope on their
    sequence over "data"; a batch that splits serves (``CASES``)."""

    cfg = get_smoke_config("deepseek-v2-lite-16b")
    model = build_model(cfg, device="cpu")
    mesh_cfg = MeshConfig(**MESHES[mesh])
    shape = ShapeConfig("d", 16, 1, "decode")
    for make in (lm_engine.make_serve_step, lm_engine.make_prefill_step):
        with pytest.raises(NotImplementedError, match="item 6.8.2e"):
            make(model, None, mesh_cfg, shape)
    monkeypatch.setattr(serve, "get_model_config", get_smoke_config)
    with pytest.raises(NotImplementedError, match="item 6.8.2e"):
        serve.main(["--arch", "deepseek-v2-lite-16b", "--data", "2",
                    "--tp", "2", "--batch", "1", "--seq-len", "16",
                    "--device", "cpu"])


def test_width_split_experts_and_grid_training_are_refused():
    """Item 6.8.2d: six experts on four model ranks, unpadded, are split
    on their width by the rules; a serving rank's context does not train
    (FSDP without the batch group, the batch axes without it); model
    ranks train whatever their KV cache layout, the cache cut on its
    sequence too (training holds no cache: tests/test_torch_tp_train.py,
    tests/test_torch_kv_train.py)."""

    cfg = get_smoke_config("granite-moe-3b-a800m")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                          num_experts=6))
    shapes = api.param_specs(build_model(cfg, device="meta"))
    pspecs = S.param_pspecs(cfg, shapes, MeshConfig(data=2, model=4))
    with pytest.raises(NotImplementedError, match="item 6.8.2d"):
        model_split(shapes, pspecs)
    qwen = get_smoke_config("qwen1.5-32b")
    seq = L.TP(group=None, rank=0, size=2, staged=False,
               kv_cache="sequence")
    for ctx in (Ctx(fsdp=L.FSDP.dry(2)), Ctx(dp=("data",))):
        with pytest.raises(NotImplementedError, match="training"):
            build_model(qwen, ctx, device="cpu").loss(
                {}, {"tokens": np.zeros((1, 2)),
                     "targets": np.zeros((1, 2))})
    # a model rank holding its KV cache cut on its sequence trains: its
    # loss on its shards (on meta, the collectives counted) is a scalar
    assert api.loss_refusal(qwen, Ctx(tp=seq)) is None
    mesh_cfg = MeshConfig(data=1, model=2, fsdp=False)
    shapes = api.param_specs(build_model(qwen, device="meta"))
    pspecs = S.param_pspecs(qwen, shapes, mesh_cfg)
    seq.split = model_split(shapes, pspecs)
    loss = build_model(qwen, Ctx(tp=seq), device="meta").loss(
        shard_params(shapes, pspecs, mesh_cfg, 0),
        {"tokens": np.zeros((1, 2)), "targets": np.zeros((1, 2))})
    assert loss.shape == () and seq.stats["all_reduce"][0] > 0
    with pytest.raises(ValueError, match="multi_pod"):
        init_shard(0, qwen, None, MeshConfig(pod=2, data=1, model=1), 0,
                   "cpu")
