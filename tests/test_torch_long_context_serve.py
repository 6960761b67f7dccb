"""Serving a batch that does not split over ``pod x data``, and the SSM and
hybrid families on data ranks with FSDP (the reference's ``long_500k``
cell, B = 1), of the port against the JAX package, on the CPU: ``gloo``
ranks (``launch/gossip.py::run_on_grid(..., device="cpu")``) at smoke
sizes.

Cases, every one but zamba2 on (data 2, model 1) in one grid of four
ranks (that one in a grid of two): at B = 1, zamba2-2.7b's smoke config
on (data 2, model 2), on (pod 2, data 2, model 1) and on (2, 1);
mamba2-780m's, qwen1.5-32b's, granite-34b's (MQA: the rules cut its
cache's sequence on ``"model"`` and leave it whole over ``"data"``) and
granite-moe-3b-a800m's (psum) on (2, 2); qwen at B = 3 on (2, 2), where
the rules take its 3 stacked layers for the batch (the first dim equal to
it), so its cache is cut on its heads and not on ``"data"``, as JAX's
is; and, at a batch that splits, zamba2 at B = 4 on (2, 2) and mamba2 at
B = 4 on (pod 2, data 2, model 1), each rank running its rows.  FSDP is
on throughout.
Parameters come from JAX ``init`` through ``convert.lm_params_from_numpy``
and ``train.shard.shard_params``, every leaf ``init`` fills with a
constant redrawn from a numpy seed first (norm offsets, biases, ``D``,
zamba2's ``lora_b``), so a wrong slice of any of them shows.  The cache
is 64 positions deep: where the rules cut its sequence in two, the
32-token prompt fills the first rank's slice exactly and the three decode
steps write into the next rank's.

Held:

* **Steps.** ``make_prefill_step`` and three ``make_serve_step`` steps
  on every rank against JAX's one-device steps (``attn_impl="flashref"``,
  a float32 cache on both sides), the port fed JAX's greedy tokens: every
  rank's logits within 1e-5 x max|JAX logit| (the repo's f32 pin), its
  greedy tokens JAX's, and the ranks of one grid equal to each other.
  zamba2 at (2, 2) is also held against JAX's own sharded steps on four
  host devices with ``fsdp=True`` (a subprocess under
  ``--xla_force_host_platform_device_count=4``).
* **Collectives.** A decode step makes one FSDP all-gather a unit (and
  one for zamba2's shared block), and, where the positions are cut on
  ``"data"``, three all-reduces over the data group an attention layer
  (the maxima, the sums, the P·V products).
* **Specs and bytes.** The steps' specs equal JAX's at B = 1 (``"data"``
  on the KV sequence), ``kv_cache_layout`` reads each axis's cut, and a
  rank's parameter and cache bytes equal ``shard_nbytes`` of the specs.
* **Launcher.** ``launch.serve.main --shape long_500k --seq-len 64``
  prints the same greedy tokens at ``--tp 1`` and ``--data 2 --tp 2``,
  for zamba2 and mamba2.
"""

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
from repro.models import api as JA  # noqa: E402
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
from repro_torch.optim.optimizers import tree_map_with_path  # noqa: E402
from repro_torch.train import sharding as S  # noqa: E402
from repro_torch.train.shard import (  # noqa: E402
    kv_cache_layout,
    rank_cache_pspecs,
    shard_nbytes,
    shard_params,
)

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT, STEPS, MAX_LEN = 32, 3, 64
LOGIT_TOL = 1e-5      # x max|JAX logit|: the repo's f32 pin
BIAS_STD = 0.2        # constant leaves redrawn: c + N(0, BIAS_STD^2)
LORA_B_STD = 1.0      # zamba2's lora_b, as tests/test_torch_lm_ssm.py draws it
MESHES = {
    "2x2": dict(pod=1, data=2, model=2, fsdp=True),
    "pods-2x2x1": dict(multi_pod=True, pod=2, data=2, model=1, fsdp=True),
    "2x1": dict(pod=1, data=2, model=1, fsdp=True),
}
CASES = {             # name -> (arch, mesh, batch)
    "zamba2-b1-2x2": ("zamba2-2.7b", "2x2", 1),
    "zamba2-b1-pods": ("zamba2-2.7b", "pods-2x2x1", 1),
    "mamba2-b1-2x2": ("mamba2-780m", "2x2", 1),
    "qwen-b1-2x2": ("qwen1.5-32b", "2x2", 1),
    "qwen-b3-2x2": ("qwen1.5-32b", "2x2", 3),
    "granite34b-b1-2x2": ("granite-34b", "2x2", 1),
    "granite-moe-b1-2x2": ("granite-moe-3b-a800m", "2x2", 1),
    "zamba2-b1-2x1": ("zamba2-2.7b", "2x1", 1),
    # a batch that splits: the SSM and hybrid families data parallel
    "zamba2-b4-2x2": ("zamba2-2.7b", "2x2", 4),
    "mamba2-b4-pods": ("mamba2-780m", "pods-2x2x1", 4),
}
# (model layout, data layout) of the KV caches the rules give each case
LAYOUTS = {"zamba2-b1-2x2": ("heads", "sequence"),
           "zamba2-b1-pods": ("heads", "sequence"),
           "mamba2-b1-2x2": ("heads", "whole"),     # no KV cache
           "qwen-b1-2x2": ("heads", "sequence"),
           "qwen-b3-2x2": ("heads", "whole"),
           "granite34b-b1-2x2": ("sequence", "whole"),
           "granite-moe-b1-2x2": ("heads", "sequence"),
           "zamba2-b1-2x1": ("heads", "sequence"),
           "zamba2-b4-2x2": ("heads", "whole"),
           "mamba2-b4-pods": ("heads", "whole")}


def _ranks(name) -> int:
    return MeshConfig(**MESHES[CASES[name][1]]).num_devices


def _redraw(npp, seed=11):
    """JAX ``init``'s tree with every leaf it fills with a constant
    redrawn: c + N(0, BIAS_STD^2) (``lora_b``: N(0, LORA_B_STD^2))."""

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


@functools.lru_cache(maxsize=None)
def jax_run(arch, batch_size):
    """JAX's prefill + STEPS greedy decode steps on a one-device mesh
    (float32 cache, MAX_LEN deep): (numpy params, batch, logits per step,
    tokens fed)."""

    jcfg = j_smoke(arch)
    mcfg = JMesh(pod=1, data=1, model=1, fsdp=False)
    mesh = make_mesh_from_config(mcfg)
    model = j_build(jcfg, JCtx(attn_impl="flashref",
                               cache_dtype=jnp.float32))
    npp = _redraw(jax.tree.map(np.asarray,
                               model.init(jax.random.PRNGKey(0))))
    params = jax.tree.map(jnp.asarray, npp)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (
        batch_size, PROMPT)).astype(np.int32)}
    prefill, _ = JE.make_prefill_step(
        model, mesh, mcfg, JShape("p", PROMPT, batch_size, "prefill"),
        MAX_LEN)
    decode, _ = JE.make_serve_step(
        model, mesh, mcfg, JShape("d", MAX_LEN, batch_size, "decode"))
    logits, cache = prefill(params, batch)
    out, fed = [np.asarray(logits)], []
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        fed.append(np.asarray(tok))
        logits, cache = decode(params, cache, tok, PROMPT + i)
        out.append(np.asarray(logits))
    return npp, batch, out, fed


def _nbytes(tree) -> int:
    total = []
    tree_map_with_path(lambda _, x: total.append(x.numel()
                                                 * x.element_size()), tree)
    return sum(total)


def _case(rank, device, cfg, mesh_kw, params_np, batch, fed):
    """One case on one rank: prefill + decode steps fed ``fed``; the
    logits of every step (numpy), the rank's bytes, its decode's FSDP
    gathers and partial-softmax all-reduces, its layouts."""

    import torch.distributed as dist
    mesh_cfg = MeshConfig(**mesh_kw)
    Bx = batch["tokens"].shape[0]
    model = build_model(cfg, Ctx(attn_impl="kernel",
                                 cache_dtype=torch.float32), device=device)
    prefill, info = lm_engine.make_prefill_step(
        model, dist.group.WORLD, mesh_cfg,
        ShapeConfig("p", PROMPT, Bx, "prefill"), MAX_LEN)
    decode, dinfo = lm_engine.make_serve_step(
        model, dist.group.WORLD, mesh_cfg,
        ShapeConfig("d", MAX_LEN, Bx, "decode"))
    params = shard_params(lm_params_from_numpy(params_np, device),
                          info["pspecs"], mesh_cfg, rank)
    logits, cache = prefill(params, batch)
    out = {"logits": [logits.numpy()], "param_bytes": _nbytes(params),
           "prefill_cache_bytes": _nbytes(cache)}
    serve.set_timed(dinfo, True)
    for i, tok in enumerate(fed):
        logits, cache = decode(params, cache, tok, PROMPT + i)
        out["logits"].append(logits.numpy())
    ctx = dinfo["model"].ctx
    out.update(cache_bytes=_nbytes(cache),
               collectives=serve.collectives(dinfo),
               tp=ctx.tp_size, dp=ctx.dp,
               kv_seq=None if ctx.kv_seq is None else ctx.kv_seq.size,
               kv_cache=None if ctx.tp is None else ctx.tp.kv_cache,
               batch_group=dinfo["grid"].batch is not None)
    return out


def _rank(rank, device, jobs):
    return [_case(rank, device, *job) for job in jobs]


@functools.lru_cache(maxsize=None)
def grid_run(world):
    """Every case of ``world`` ranks in one grid: {case: [rank results]}."""

    names, jobs = [], []
    for name, (arch, mesh, batch) in CASES.items():
        if _ranks(name) != world:
            continue
        npp, tokens, _, fed = jax_run(arch, batch)
        names.append(name)
        jobs.append((get_smoke_config(arch), MESHES[mesh], npp, tokens,
                     fed))
    grid = (world // 2, 2) if world == 4 else (world, 1)
    ranks = tlaunch.run_on_grid(_rank, grid, jobs, device="cpu",
                                timeout=300)
    return {name: [r[i] for r in ranks] for i, name in enumerate(names)}


def _hold(name, ranks, want, fed):
    for r, res in enumerate(ranks):
        assert len(res["logits"]) == STEPS + 1, (name, r)
        for step, (got, ref) in enumerate(zip(res["logits"], want)):
            assert got.shape == ref.shape
            bound = LOGIT_TOL * float(np.abs(ref).max())
            err = float(np.abs(got - ref).max())
            assert err <= bound, (name, r, step, err, bound)
            want_tok = fed[step] if step < STEPS else ref.argmax(-1)
            np.testing.assert_array_equal(got.argmax(-1), want_tok)


@pytest.mark.parametrize("name", list(CASES))
def test_whole_batch_steps_match_jax(name):
    arch, _, batch = CASES[name]
    _, _, want, fed = jax_run(arch, batch)
    ranks = grid_run(_ranks(name))[name]
    assert len(ranks) == _ranks(name)
    _hold(name, ranks, want, fed)
    # the ranks of the grid hold the same logits
    for res in ranks[1:]:
        for got, first in zip(res["logits"], ranks[0]["logits"]):
            np.testing.assert_array_equal(got, first)
    # a batch that does not split stays whole: no batch group, no batch
    # axes in the Ctx
    mesh_cfg = MeshConfig(**MESHES[CASES[name][1]])
    splits = batch % (mesh_cfg.pod * mesh_cfg.data) == 0
    for res in ranks:
        assert res["batch_group"] == splits
        assert (res["dp"] is not None) == splits


def _attention_layers(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    return 0 if cfg.family == "ssm" else cfg.num_layers


def _units(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every + 1  # + shared block
    return cfg.num_layers


@pytest.mark.parametrize("name", list(CASES))
def test_decode_collectives_a_step(name):
    arch, _, _ = CASES[name]
    cfg = get_smoke_config(arch)
    model_layout, data_layout = LAYOUTS[name]
    for res in grid_run(_ranks(name))[name]:
        stats = res["collectives"]
        # one FSDP gather a unit (and the hybrid's shared block)
        assert stats["fsdp_all_gather"][0] == STEPS * _units(cfg), name
        assert res["kv_cache"] == (model_layout if res["tp"] > 1 else None)
        if data_layout == "sequence" and _attention_layers(cfg):
            n = STEPS * _attention_layers(cfg)
            assert res["kv_seq"] == 2
            assert stats["kv_seq_all_reduce_max"][0] == n, name
            assert stats["kv_seq_all_reduce"][0] == 2 * n, name
        else:
            assert res["kv_seq"] is None
            assert not any(op.startswith("kv_seq") for op in stats)


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
tokens, fed, max_len = d["tokens"], d["fed"], int(d["max_len"])
mesh = make_mesh((2, 2), ("data", "model"))
mcfg = mesh_config_for(mesh, multi_pod=False, fsdp=True)
model = build_model(get_smoke_config("zamba2-2.7b"),
                    Ctx(attn_impl="flashref", cache_dtype=jnp.float32,
                        mesh=mesh, dp=("data",)))
Bx, Lx = tokens.shape
prefill, info = JE.make_prefill_step(
    model, mesh, mcfg, ShapeConfig("p", Lx, Bx, "prefill"), max_len)
decode, dinfo = JE.make_serve_step(model, mesh, mcfg,
                                   ShapeConfig("d", max_len, Bx, "decode"))
assert tuple(dinfo["cspecs"]["kv"].k)[-2] == "data", dinfo["cspecs"]
shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
paths, tree = jax.tree_util.tree_flatten_with_path(shapes)
params = jax.tree_util.tree_unflatten(tree, [
    jnp.asarray(d["p" + jax.tree_util.keystr(p)]) for p, _ in paths])
params = jax.device_put(params, shardings_for(mesh, info["pspecs"]))
batch = jax.device_put({"tokens": tokens}, shardings_for(mesh, info["bspecs"]))
logits, cache = prefill(params, batch)
out = [np.asarray(logits)]
for i, tok in enumerate(fed):
    logits, cache = decode(params, cache, jnp.asarray(tok), Lx + i)
    out.append(np.asarray(logits))
np.save(sys.argv[2], np.stack(out))
"""


def test_zamba2_ranks_match_jax_sharded_steps(tmp_path):
    """zamba2 at B = 1 on (2, 2) with FSDP against JAX's own sharded steps
    on four host devices (its KV cache cut on heads over "model" and on
    its sequence over "data"), fed the same parameters and tokens."""

    npp, batch, one_device, fed = jax_run("zamba2-2.7b", 1)
    flat = {"p" + jax.tree_util.keystr(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(npp)[0]}
    np.savez(tmp_path / "in.npz", tokens=batch["tokens"], fed=np.stack(fed),
             max_len=MAX_LEN, **flat)
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
    _hold("zamba2-b1-2x2", grid_run(4)["zamba2-b1-2x2"], want, fed)


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


def _specs(name):
    """(port model on meta, mesh, shape, cache shapes, rules' cache
    specs, JAX's cache specs)."""

    arch, mesh, batch = CASES[name]
    mesh_kw = MESHES[mesh]
    pad = mesh_kw["model"] if get_smoke_config(arch).moe else 0
    jm = j_build(j_smoke(arch), JCtx(ep_pad_to=pad,
                                     cache_dtype=jnp.float32))
    tm = build_model(get_smoke_config(arch),
                     Ctx(ep_pad_to=pad, cache_dtype=torch.float32),
                     device="meta")
    jmesh, tmesh = JMesh(**mesh_kw), MeshConfig(**mesh_kw)
    jshape = JShape("d", MAX_LEN, batch, "decode")
    tshape = ShapeConfig("d", MAX_LEN, batch, "decode")
    jc, tc = JA.cache_specs(jm, batch, MAX_LEN), api.cache_specs(
        tm, batch, MAX_LEN)
    jp, tp = JA.param_specs(jm), api.param_specs(tm)
    assert _tflat(tp, S.param_pspecs(tm.cfg, tp, tmesh)) == _jflat(
        jp, JS.param_pspecs(jm.cfg, jp, jmesh))
    jb, tb = JA.input_specs(jm.cfg, jshape), api.input_specs(tm.cfg, tshape)
    assert _tflat(tb, S.batch_pspecs(tm.cfg, tshape, tmesh, tb)) == \
        _jflat(jb, JS.batch_pspecs(jm.cfg, jshape, jmesh, jb))
    return (tm, tmesh, tshape, tc, S.cache_pspecs_tree(
        tm.cfg, tshape, tmesh, tc), JS.cache_pspecs_tree(
            jm.cfg, jshape, jmesh, jc), jc)


@pytest.mark.parametrize("name", list(CASES))
def test_specs_layouts_and_bytes(name):
    tm, tmesh, _, tc, tspecs, jspecs, jc = _specs(name)
    assert _tflat(tc, tspecs) == _jflat(jc, jspecs)
    kv = [s for p, (_, s) in _tflat(tc, tspecs).items()
          if S.leaf_name(p) in ("k", "v")]
    model_layout, data_layout = LAYOUTS[name]
    cspecs = rank_cache_pspecs(tc, tspecs)
    assert kv_cache_layout(tc, cspecs) == model_layout
    assert kv_cache_layout(tc, cspecs, "data") == data_layout
    # "data" on the KV sequence exactly where the batch is whole and the
    # model axis left the sequence whole
    assert all((s[-2] == "data") == (data_layout == "sequence")
               for s in kv)
    pspecs = S.param_pspecs(tm.cfg, api.param_specs(tm), tmesh)
    for res in grid_run(_ranks(name))[name]:
        assert res["param_bytes"] == shard_nbytes(api.param_specs(tm),
                                                  pspecs, tmesh)
        assert res["cache_bytes"] == res["prefill_cache_bytes"] == \
            shard_nbytes(tc, cspecs, tmesh)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-780m"])
def test_launcher_long_500k_grid_prints_the_one_process_tokens(
        arch, monkeypatch, capsys):
    monkeypatch.setattr(serve, "get_model_config", get_smoke_config)
    argv = ["--arch", arch, "--shape", "long_500k", "--seq-len", "64",
            "--steps", "3", "--device", "cpu"]
    one = serve.main(argv + ["--tp", "1"])
    grid = serve.main(argv + ["--data", "2", "--tp", "2"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "greedy tokens" in ln]
    assert len(lines) == 2 and lines[0] == lines[1]
    assert len(grid["ranks"]) == 4 and grid["backend"] == "gloo"
    assert all(r["tokens"] == one["ranks"][0]["tokens"]
               for r in grid["ranks"])
    assert "on 1 x 2 x 2 (pod x data x model) rank(s), FSDP on" in out
    assert "seq_len 524288 -> 64" in out
    cfg = get_smoke_config(arch)
    units = _units(cfg)
    assert f"rank 0 fsdp_all_gather: {units} calls" in out
    parts = grid["reckoned_bytes"]["parts"]
    for r in grid["ranks"]:
        assert r["cache_parts"] == parts["grid"]
        assert r["cache_bytes"] == sum(parts["grid"].values())
    if cfg.family == "hybrid":
        n = _attention_layers(cfg)
        assert f"rank 0 kv_seq_all_reduce_max: {n} calls" in out
        assert f"rank 0 kv_seq_all_reduce: {2 * n} calls" in out
        # a rank holds a quarter of the KV cache: heads over "model",
        # positions over "data"
        assert 4 * parts["grid"]["kv"] == parts["one"]["kv"]
    else:
        assert parts["grid"]["kv"] == 0 and "kv_seq" not in out
    assert 2 * parts["grid"]["state"] >= parts["one"]["state"]


def test_long_decode_roofline_record_counts_by_hand():
    """``roofline_bench``'s long decode record on rank 0 of (data 2, model
    2) at B = 1 (zamba2's smoke config, a cache of 64): three all-reduces
    over the data group an invocation, one FSDP gather a unit and the
    shared block's, no gather of the logits, a quarter of the KV cache."""

    from repro_torch.launch import roofline_bench as RB

    cfg = get_smoke_config("zamba2-2.7b")
    n = cfg.num_layers // cfg.shared_attn_every
    one = RB.lm_record(cfg, "decode", 1, MAX_LEN - 1, MAX_LEN, 1)
    rank = RB.lm_record(cfg, "decode", 1, MAX_LEN - 1, MAX_LEN, 2,
                        data_axis=2)
    coll = rank["collectives"]
    hkv, hd = cfg.num_kv_heads // 2, cfg.resolved_head_dim
    # the maxima and the sums: a float a (KV head, query head of its
    # group); the partial P.V products: head_dim floats
    assert coll["kv_seq_all_reduce_max"] == {"calls": n, "bytes": 4 * hkv * n}
    assert coll["kv_seq_all_reduce"] == {"calls": 2 * n,
                                         "bytes": 4 * hkv * (1 + hd) * n}
    assert coll["fsdp_all_gather"]["calls"] == n + 1
    assert "batch_all_gather" not in coll and "kv_seq" not in str(
        one["collectives"])
    kv = 2 * n * cfg.num_kv_heads * MAX_LEN * hd * 2     # bf16 k and v
    assert one["cache_bytes"] - rank["cache_bytes"] >= 3 * kv // 4
    assert rank["shape"] == f"decode_1x{MAX_LEN}" and rank["mesh"] == "2x2"
