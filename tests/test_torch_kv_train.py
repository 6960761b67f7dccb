"""The port's sharded train step where the KV heads do not divide the
model ranks, against the JAX package's on the same mesh, on the CPU:
``gloo`` ranks (``launch/gossip.py::run_on_grid(..., device="cpu")``) at
smoke sizes.

Cases (``CASES``), each with microbatch 0 and SGD and with microbatch 2
and AdamW, two steps of the global batch of 8 x 16 tokens from
``LMTokenPipeline``:

* granite-34b's smoke config (8 query heads over 1 KV head of 16, an
  untied ``lm_head``) at ``(data 2, model 2)`` with FSDP and at ``(data
  1, model 4)``: the rules cut ``wk``/``wv`` in halves and quarters of
  the head, so each rank gathers k and v whole (the **split** layout);
* gemma2-2b's (4 heads over 2 KV heads of 32, local/global windows,
  softcaps, the tied table) at ``(data 1, model 4)``: split;
* a variant of internlm2-20b's (6 query heads over 2 KV heads of 16,
  d_ff 384, vocab 768; ``dataclasses.replace`` on both sides) at ``(data
  1, model 3)``: 32 k/v columns do not split over 3 ranks, so the rules
  keep ``wk``/``wv`` whole and each rank computes k and v whole (the
  **whole** layout); rank 1's query heads 2 and 3 straddle the two KV
  groups.

Parameters come from JAX ``init`` through ``convert.lm_params_from_numpy``
and the optimizer state from JAX's ``init``, both sliced by
``train/step.py::shard_state``.  JAX's ``make_train_step`` runs every
case on the same mesh of host devices (the first three of four for
``model = 3``) in one subprocess; then the four-rank cases run in one
grid of four ranks, the three-rank ones in one of three.

Held, with ``tests/test_torch_tp_train.py``'s tolerances:

* **Against JAX's sharded step.**  Both steps' losses within rel
  ``LOSS_RTOL``; the parameters, each rank's shards against their slices
  of JAX's: SGD after two steps within ``SGD_TOL`` x max|leaf|; AdamW by
  ``tests/test_torch_train.py``'s rule after step 1 and after step 2,
  which starts from JAX's parameters and state after step 1 (an AdamW
  update moves by up to lr where a gradient is within rounding of zero,
  and gemma2 carries such a move into every gradient of the next step).
* **Gradients.**  Each rank's reduced gradient before the clip
  (``info["grads"]``) equals its slice of one process's within
  ``GRAD_TOL`` x max|leaf|, whole ``wk``/``wv`` included; every leaf the
  specs do not split on ``"model"`` (the norms, whole k/v) has the same
  gradient on every model rank of a data row.
* **The clip.**  The sharded norm equals one process's at rel 1e-6.
* **Collectives.**  Exact counts a step, by group: on the model group
  the all-reduces ``tests/test_torch_tp_train.py`` counts plus one a
  whole k/v leaf a step (``train/shard.py::whole_kv``); in the split
  layout one k/v gather a layer and part in the forward and one more in
  remat's recompute, one reduce-scatter a layer and part in the
  backward; no other gather: the logits are never gathered.
* **Bytes.**  A rank's parameters and optimizer state equal
  ``shard_nbytes`` of the specs.
* **Layouts.**  The specs cut ``wk``/``wv`` in parts of a head in the
  split cases; in the whole case they are the only leaves beside the
  norms that ``"model"`` leaves whole, and rank 1 reads KV heads 0 and 1.
* **The launcher.**  granite's smoke config at ``--tp 4``: its
  checkpoint goes on at ``--data 2 --tp 2`` and on one process within
  ``LOSS_RTOL`` of the straight run, and a ``--data 2 --tp 2``
  checkpoint restores at ``--tp 4`` (saving back the tree it restored,
  bitwise) and goes on as the straight run.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import get_smoke_config as j_smoke  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.data import LMTokenPipeline as JPipeline  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.api import Ctx as JCtx  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro_torch.checkpoint.manager import load_pytree  # noqa: E402
from repro_torch.config import (  # noqa: E402
    MeshConfig,
    ShapeConfig,
    TrainConfig,
    get_smoke_config,
)
from repro_torch.convert import (  # noqa: E402
    lm_params_from_numpy,
    opt_state_from_numpy,
)
from repro_torch.launch import gossip as glaunch  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.optim.optimizers import (  # noqa: E402
    square_norm,
    tree_leaves,
    tree_map_with_path,
)
from repro_torch.train import sharding as S  # noqa: E402
from repro_torch.train.shard import (  # noqa: E402
    fsdp_split,
    grid_coords,
    model_split,
    whole_kv,
)
from repro_torch.train.step import (  # noqa: E402
    loss_and_grads,
    make_sharded_train_step,
    shard_state,
    split_batch,
)

from _train_grid import (  # noqa: E402
    ADAM_FRAC,
    ADAM_MAX,
    GRAD_TOL,
    LOSS_RTOL,
    LR,
    NORM_RTOL,
    SEQ,
    SGD_TOL,
    STEPS,
    B,
    copy_step,
    grid_groups,
    nested,
    numpy_tree,
    on_model,
    slices,
    tc_kw,
    trees_equal,
)

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the configs, each a smoke config with these fields replaced on both
# sides
ARCHS = {"granite-34b": {}, "gemma2-2b": {},
         "internlm2-20b": dict(num_heads=6, d_ff=384, vocab_size=768)}
MESHES = {"data2model2": dict(pod=1, data=2, model=2, fsdp=True),
          "model4": dict(pod=1, data=1, model=4, fsdp=True),
          "model3": dict(pod=1, data=1, model=3, fsdp=True)}
JAX_AXES = {"data2model2": ((2, 2), ("data", "model")),
            "model4": ((1, 4), ("data", "model")),
            "model3": ((1, 3), ("data", "model"))}
LAYOUTS = [("granite-34b", "data2model2"), ("granite-34b", "model4"),
           ("gemma2-2b", "model4"), ("internlm2-20b", "model3")]
CASES = {f"{arch}-{mesh}-{opt}": (arch, mesh, mb, opt)
         for arch, mesh in LAYOUTS for mb, opt in ((0, "sgd"), (2, "adamw"))}


def config(arch):
    return dataclasses.replace(get_smoke_config(arch), **ARCHS[arch])


def j_config(arch):
    return dataclasses.replace(j_smoke(arch), **ARCHS[arch])


@functools.lru_cache(maxsize=None)
def jax_init(arch):
    """JAX's one-device init of ``arch``'s config, as numpy."""

    params = j_build(j_config(arch), JCtx()).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def jax_opt_init(arch, opt):
    state = j_make_optimizer(JTrainConfig(**tc_kw(0, opt))).init(
        jax_init(arch))
    return jax.tree.map(np.asarray, state)


def batches(arch):
    pipe = JPipeline(j_config(arch).vocab_size, SEQ, B)
    return [dict(zip(("tokens", "targets"), pipe.batch_at(i)))
            for i in range(STEPS)]


JAX_STEP = """
import dataclasses, math, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.compat import make_mesh
from repro.config import ShapeConfig, TrainConfig, get_smoke_config
from repro.data import LMTokenPipeline
from repro.launch.mesh import mesh_config_for
from repro.models import build_model
from repro.models.api import Ctx
from repro.train.step import make_train_step
cases = eval(sys.argv[1])
out = {}
for name, (arch, over, shape, axes, tc) in cases.items():
    init = np.load(sys.argv[2] + "/" + arch + ".npz")
    n = math.prod(shape)
    mesh = make_mesh(shape, axes) if n == jax.device_count() else Mesh(
        np.asarray(jax.devices()[:n]).reshape(shape), axes)
    mcfg = mesh_config_for(mesh, multi_pod=False, fsdp=True)
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    model = build_model(cfg, Ctx(mesh=mesh, remat=True, dp=("data",)))
    step, info = make_train_step(model, mesh, mcfg,
                                 ShapeConfig("t", %(seq)d, %(b)d, "train"),
                                 TrainConfig(**tc))
    like = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    flat, tdef = jax.tree_util.tree_flatten_with_path(like)
    params = jax.tree_util.tree_unflatten(
        tdef, [init[jax.tree_util.keystr(p)] for p, _ in flat])
    params = jax.device_put(params, info["params"])
    opt = jax.device_put(info["optimizer"].init(params), info["opt"])
    pipe = LMTokenPipeline(cfg.vocab_size, %(seq)d, %(b)d)
    losses = []
    for i in range(%(steps)d):
        tok, tgt = pipe.batch_at(i)
        batch = jax.device_put({"tokens": tok, "targets": tgt},
                               info["batch"])
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            for key, tree in (("1", params), ("1o", opt)):
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
                    out[name + "|" + key + "|" + jax.tree_util.keystr(p)] = (
                        np.asarray(x))
    out[name + "|loss"] = np.asarray(losses)
    for p, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[name + "|" + jax.tree_util.keystr(p)] = np.asarray(x)
np.savez(sys.argv[3], **out)
""" % {"seq": SEQ, "b": B, "steps": STEPS}


def _start_jax(tmp):
    for arch in ARCHS:
        flat = jax.tree_util.tree_flatten_with_path(jax_init(arch))[0]
        np.savez(os.path.join(tmp, f"{arch}.npz"),
                 **{jax.tree_util.keystr(p): x for p, x in flat})
    cases = {name: (arch, ARCHS[arch], *JAX_AXES[mesh], tc_kw(mb, opt))
             for name, (arch, mesh, mb, opt) in CASES.items()}
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(_ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, "-c", JAX_STEP, repr(cases), tmp,
         os.path.join(tmp, "out.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)


def _case(rank, device, cfg, mesh_kw, tc, params_np, opt_state, data,
          restart):
    """One case on one rank: the gradient before any update and its
    norm, then two steps with every group's collectives counted; with
    ``restart`` (JAX's parameters and optimizer state after step 1) the
    second step starts from it, the rank's own parameters after step 1
    kept in ``params1``."""

    import torch.distributed as dist

    model = build_model(cfg, Ctx(remat=True), device=device)
    step, info = make_sharded_train_step(
        model, dist.group.WORLD, MeshConfig(**mesh_kw),
        ShapeConfig("t", SEQ, B, "train"), TrainConfig(**tc))
    params, state = shard_state(lm_params_from_numpy(params_np, device),
                                opt_state, info, rank, device)
    loss0, grads = info["grads"](params, data[0])
    out = {"grads": numpy_tree(grads), "loss0": float(loss0),
           "grad_norm": float(info["grad_norm"](grads)),
           "param_bytes": sum(x.numel() * x.element_size()
                              for x in tree_leaves(params)),
           "opt_bytes": sum(x.numel() * x.element_size()
                            for x in tree_leaves(state)),
           "reckoned": (info["param_bytes"], info["opt_bytes"]),
           "split": sorted(info["model"].ctx.tp.split),
           "kv_whole": sorted(info["grid"].kv_whole)}
    del grads
    groups = grid_groups(info["grid"])
    for g in groups.values():
        g.stats.clear()
        g.timed = True
    losses = []
    for i, batch in enumerate(data):
        if i == 1 and restart is not None:
            out["params1"] = numpy_tree(params)
            params, state = shard_state(
                lm_params_from_numpy(restart[0], device),
                opt_state_from_numpy(restart[1], "cpu"), info, rank, device)
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    out.update(losses=losses, params=numpy_tree(params),
               counts={f"{k}_{op}": row[0] for k, g in groups.items()
                       for op, row in g.stats.items()})
    return out


def _rank(rank, device, jobs):
    return [_case(rank, device, *job) for job in jobs]


def _after_step1(want, name, arch, opt):
    """JAX's parameters and optimizer state after step 1 of case
    ``name``, as numpy trees."""

    trees = []
    for key, like in (("1", jax_init(arch)), ("1o", jax_opt_init(arch, opt))):
        flat, tdef = jax.tree_util.tree_flatten_with_path(like)
        trees.append(jax.tree_util.tree_unflatten(tdef, [
            want[f"{name}|{key}|{jax.tree_util.keystr(p)}"] for p, _ in flat]))
    return tuple(trees)


def runs(tmp):
    """Every case: ({name: the ranks' results}, JAX's {key: array}).  An
    AdamW case's ranks start step 2 from JAX's state after step 1, so the
    grids run after JAX's steps."""

    proc = _start_jax(tmp)
    try:
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    want = dict(np.load(os.path.join(tmp, "out.npz")))
    jobs = {4: [], 3: []}
    for name, (arch, mesh, mb, opt) in CASES.items():
        mesh_kw = MESHES[mesh]
        jobs[mesh_kw["data"] * mesh_kw["model"]].append((name, (
            config(arch), mesh_kw, tc_kw(mb, opt), jax_init(arch),
            opt_state_from_numpy(jax_opt_init(arch, opt), "cpu"),
            batches(arch),
            _after_step1(want, name, arch, opt) if opt == "adamw"
            else None)))
    cases = {}
    for world, named in jobs.items():
        ranks = glaunch.run_on_grid(
            _rank, (1, world), [job for _, job in named], device="cpu",
            timeout=300)
        cases.update({name: [r[i] for r in ranks]
                      for i, (name, _) in enumerate(named)})
    return cases, want


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return runs(str(tmp_path_factory.mktemp("kv_train")))


def _specs(arch, mesh):
    cfg = config(arch)
    shapes = api.param_specs(build_model(cfg, device="meta"))
    mesh_cfg = MeshConfig(**MESHES[mesh])
    return cfg, shapes, S.param_pspecs(cfg, shapes, mesh_cfg), mesh_cfg


@functools.lru_cache(maxsize=None)
def one_process(arch, mb):
    """One process's loss and gradient of the first batch at the init."""

    model = build_model(config(arch), Ctx(remat=True), device="cpu")
    params = lm_params_from_numpy(jax_init(arch), "cpu")
    loss, grads = loss_and_grads(model.loss, params,
                                 split_batch(batches(arch)[0], mb))
    return (float(loss), numpy_tree(grads),
            float(torch.sqrt(square_norm(grads))))


def _paths(shapes) -> set:
    out = set()
    tree_map_with_path(lambda p, _: out.add(p), shapes)
    return out


@pytest.mark.parametrize("arch,mesh", LAYOUTS)
def test_the_rules_cut_kv_in_parts_of_a_head_or_keep_it_whole(arch, mesh):
    cfg, shapes, pspecs, mesh_cfg = _specs(arch, mesh)
    assert cfg.num_kv_heads % mesh_cfg.model
    kv = {p for p in _paths(shapes) if p.endswith(("['wk']", "['wv']"))}
    whole = _paths(shapes) - on_model(shapes, pspecs)
    width = cfg.num_kv_heads * cfg.resolved_head_dim
    if width % mesh_cfg.model:
        # whole: beside the norms only the k/v leaves are whole on
        # "model", and they are the leaves summed over the model group
        assert {p for p in whole if "norm" not in p} == kv
        assert whole_kv(shapes, pspecs) == kv
        # rank 1's query heads 2 and 3 read KV heads 0 and 1
        heads = cfg.num_heads // mesh_cfg.model
        k = torch.arange(cfg.num_kv_heads).view(1, -1, 1, 1).float()
        tp = L.TP.dry(mesh_cfg.model, rank=1)
        picked, _ = A._rank_kv(k, k, A.KVShard(tp, False, None), heads)
        assert picked.flatten().tolist() == [0.0, 1.0]
    else:
        # split: each rank holds a part of a head's columns
        assert not kv & whole and not whole_kv(shapes, pspecs)
        assert (width // mesh_cfg.model) % cfg.resolved_head_dim
        assert "attn.wk" in model_split(shapes, pspecs)


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_jax_sharded_step(grid, name):
    ranks, want = grid
    ref = want[f"{name}|loss"]
    for r, res in enumerate(ranks[name]):
        assert len(res["losses"]) == STEPS
        np.testing.assert_allclose(res["losses"], ref, rtol=LOSS_RTOL,
                                   err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("name", list(CASES))
def test_params_match_jax_sharded_step(grid, name):
    """SGD: the parameters after two steps.  AdamW: after step 1, and
    after step 2 from JAX's state after step 1, each by the rule.  Its
    update g / (|g| + eps) moves by up to lr where a gradient is within
    f32 rounding of zero, and gemma2's sqrt(d) embedding scale carries
    such a move of an embedding coordinate at step 1 into every gradient
    of step 2 (up to 2e-4 of a leaf's max at model 4): two steps on the
    rank's own state would hold that rounding, not the sharded step."""

    ranks, want = grid
    arch, mesh, _, opt = CASES[name]
    _, _, pspecs, mesh_cfg = _specs(arch, mesh)
    for key, at in (("params", "|["), ("params1", "|1|[")):
        if key == "params1" and opt == "sgd":
            continue
        jtree_np = nested({k[len(name + at) - 1:]: v
                           for k, v in want.items()
                           if k.startswith(name + at)})
        diffs = []
        for r, res in enumerate(ranks[name]):
            ref = slices(jtree_np, pspecs, mesh_cfg, r)
            assert set(ref) == set(res[key])
            for path, got in res[key].items():
                if opt == "sgd":
                    scale = float(np.abs(ref[path]).max())
                    err = float(np.abs(got - ref[path]).max())
                    assert err <= SGD_TOL * scale, (name, r, path, err,
                                                    scale)
                else:
                    diffs.append(np.abs(got - ref[path]).ravel())
        if opt == "adamw":
            d = np.concatenate(diffs)
            assert float(d.max()) <= ADAM_MAX * LR, key
            assert float(np.mean(d > 1e-3 * LR)) <= ADAM_FRAC, key


@pytest.mark.parametrize("name", list(CASES))
def test_shard_gradients_are_slices_of_one_process(grid, name):
    ranks, _ = grid
    arch, mesh, mb, _ = CASES[name]
    _, shapes, pspecs, mesh_cfg = _specs(arch, mesh)
    loss, grads, _ = one_process(arch, mb)
    tree_np = nested(grads)
    for r, res in enumerate(ranks[name]):
        np.testing.assert_allclose(res["loss0"], loss, rtol=LOSS_RTOL)
        ref = slices(tree_np, pspecs, mesh_cfg, r)
        assert set(ref) == set(res["grads"])
        for path, got in res["grads"].items():
            scale = float(np.abs(grads[path]).max())
            err = float(np.abs(got - ref[path]).max())
            assert err <= GRAD_TOL * scale, (name, r, path, err, scale)
            assert np.abs(got).max() > 0, (name, r, path)


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_agree_over_the_model_ranks(grid, name):
    """A leaf the specs keep whole on ``"model"`` (the norms, whole k/v)
    gets the same gradient on every model rank of a data row."""

    ranks, _ = grid
    arch, mesh, _, _ = CASES[name]
    _, shapes, pspecs, mesh_cfg = _specs(arch, mesh)
    whole = [p for p in ranks[name][0]["grads"]
             if p not in on_model(shapes, pspecs)]
    assert any("norm" in p for p in whole)
    assert set(ranks[name][0]["kv_whole"]) <= set(whole)
    for r, res in enumerate(ranks[name]):
        if grid_coords(mesh_cfg, r)["model"]:
            continue
        for peer in ranks[name][r + 1:r + mesh_cfg.model]:
            for path in whole:
                np.testing.assert_array_equal(
                    res["grads"][path], peer["grads"][path],
                    err_msg=f"{name} {r} {path}")


@pytest.mark.parametrize("name", list(CASES))
def test_clip_norm_over_the_shards(grid, name):
    ranks, _ = grid
    arch, _, mb, _ = CASES[name]
    want = one_process(arch, mb)[2]
    for res in ranks[name]:
        assert abs(res["grad_norm"] - want) <= NORM_RTOL * want


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_a_step_are_exact(grid, name):
    ranks, _ = grid
    arch, mesh, mb, _ = CASES[name]
    cfg, shapes, pspecs, mesh_cfg = _specs(arch, mesh)
    split = fsdp_split(shapes, pspecs) if mesh_cfg.data > 1 else {}
    units = len(split.get("units", {}))
    n_units = cfg.num_layers // (cfg.local_global_pattern or 1)
    parts = max(mb, 1)
    n_leaves = len(tree_leaves(shapes))
    kv_whole = sorted(whole_kv(shapes, pspecs))
    gathered = "attn.wk" in model_split(shapes, pspecs)
    for res in ranks[name]:
        c = dict(res["counts"])
        assert res["split"] == sorted(model_split(shapes, pspecs))
        assert res["kv_whole"] == kv_whole
        # tests/test_torch_tp_train.py's count: a part's lookup,
        # each sublayer's two sums, those remat recomputes and two
        # conjugates, the final norm's, the cross-entropy's; a step's
        # clip, and one sum a whole k/v leaf
        recomputed = 2 * cfg.num_layers - (
            0 if cfg.local_global_pattern else n_units)
        assert c.pop("model_all_reduce") == STEPS * (
            parts * (4 * cfg.num_layers + recomputed + 3) + 1
            + len(kv_whole)), c
        assert c.pop("model_all_reduce_max") == STEPS * parts, c
        if gathered:
            # k and v in one gather a layer, again in remat's recompute;
            # one reduce-scatter a layer in the backward
            assert c.pop("model_all_gather") == (
                STEPS * parts * cfg.num_layers * 2), c
            assert c.pop("model_reduce_scatter") == (
                STEPS * parts * cfg.num_layers), c
        if mesh_cfg.data > 1:
            assert c.pop("batch_all_reduce") == STEPS * (
                n_leaves - units + parts + 1), c
        if units:
            assert c.pop("fsdp_all_gather") == STEPS * parts * n_units * 2
            assert c.pop("fsdp_reduce_scatter") == STEPS * parts * n_units
            assert c.pop("fsdp_all_reduce") == STEPS      # the clip's
        # nothing else: no gather of the logits
        assert c == {}, c


@pytest.mark.parametrize("name", list(CASES))
def test_rank_bytes_are_shard_nbytes(grid, name):
    ranks, _ = grid
    arch, mesh, _, _ = CASES[name]
    _, shapes, _, _ = _specs(arch, mesh)
    one = sum(x.numel() * x.element_size() for x in tree_leaves(shapes))
    for res in ranks[name]:
        assert (res["param_bytes"], res["opt_bytes"]) == res["reckoned"]
        assert res["param_bytes"] < one


# ---------------------------------------------------------------------- #
# the launcher
# ---------------------------------------------------------------------- #


@pytest.fixture
def launcher(monkeypatch):
    monkeypatch.setattr(tlaunch, "get_model_config", get_smoke_config)
    monkeypatch.setattr(tlaunch, "get_shape",
                        lambda name: ShapeConfig(name, SEQ, B, "train"))

    def run(steps, ckpt, *flags):
        return tlaunch.train(["--arch", "granite-34b", "--steps", str(steps),
                              "--microbatch", "2", "--ckpt", str(ckpt),
                              "--ckpt-every", "2", "--device", "cpu",
                              *flags])

    return run


def _saved(ckpt, step):
    cfg = get_smoke_config("granite-34b")
    shapes = api.param_specs(build_model(cfg, device="meta"))
    opt = tlaunch.make_optimizer(TrainConfig())
    return load_pytree(os.path.join(ckpt, f"step_{step:010d}"),
                       {"p": shapes, "o": opt.init(shapes)})


def test_launcher_checkpoints_move_between_model_and_data_ranks(
        launcher, tmp_path):
    tp4, tp2 = ("--tp", "4"), ("--data", "2", "--tp", "2")
    straight = launcher(4, tmp_path / "a", *tp4)
    assert straight["backend"] == "gloo" and len(straight["ranks"]) == 4
    assert straight["mesh_cfg"].model == 4
    ops = straight["ranks"][0]["collectives"]
    # the k/v gathers and their reduce-scatters, and no other gather
    assert ops["model_all_gather"][0] == 2 * ops["model_reduce_scatter"][0]
    assert ops["model_reduce_scatter"][0] > 0
    assert [op for op in ops if "all_gather" in op] == ["model_all_gather"]

    # a data 2 x model 2 checkpoint restores on model 4: the tree saved
    # back at once is the one restored, and the run goes on as the
    # straight one
    launcher(2, tmp_path / "b", *tp2)
    copy_step(tmp_path / "b", tmp_path / "c", 2)
    again = launcher(2, tmp_path / "c", *tp4)
    assert again["ranks"][0]["start"] == 2 and not again["losses"]
    assert trees_equal(_saved(tmp_path / "c", 2), _saved(tmp_path / "b", 2))
    on = launcher(4, tmp_path / "c", *tp4)
    np.testing.assert_allclose(on["losses"], straight["losses"][2:],
                               rtol=LOSS_RTOL)

    # and the straight run's checkpoint goes on at data 2 x model 2 and
    # on one process
    for name, flags in (("d", tp2), ("e", ())):
        copy_step(tmp_path / "a", tmp_path / name, 2)
        on = launcher(4, tmp_path / name, *flags)
        assert on["ranks"][0]["start"] == 2
        np.testing.assert_allclose(on["losses"], straight["losses"][2:],
                                   rtol=LOSS_RTOL, err_msg=name)
    assert on["mesh_cfg"].num_devices == 1
