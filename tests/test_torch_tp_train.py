"""The port's sharded train step on the model axis against the JAX
package's, on the CPU: four ``gloo`` ranks (``launch/gossip.py::
run_on_grid(..., device="cpu")``) on ``pod x data x model`` grids with
two model ranks, at smoke sizes.

Cases (``CASES``): gemma2-2b's smoke config (4 query heads, 2 KV heads,
the tied table, logit softcap) and internlm2-20b's (8 and 2, an untied
``lm_head``) on a ``(data 2, model 2)`` grid with FSDP and a ``(pod 2,
data 1, model 2)`` one, each with microbatch 0 and SGD and with
microbatch 2 and AdamW, two steps of the global batch of 8 x 16 tokens
from ``LMTokenPipeline``.  Parameters come from JAX ``init`` through
``convert.lm_params_from_numpy`` and the optimizer state from JAX's
``init`` through ``opt_state_from_numpy``, both sliced by
``train/step.py::shard_state``.  Every case runs in one grid of four
ranks; JAX's ``make_train_step`` runs every case on the same mesh of
four host devices in one subprocess, beside the grid.

Held:

* **Against JAX's sharded step.**  Both steps' losses within rel
  ``LOSS_RTOL``; the parameters after two steps, each rank's shards
  against their slices of JAX's: SGD within ``SGD_TOL`` x max|leaf|,
  AdamW by ``tests/test_torch_train.py``'s rule.
* **Gradients.**  Each rank's gradient before the update
  (``info["grads"]``) equals its slice of one process's gradient of the
  whole batch within ``GRAD_TOL`` x max|leaf|; a leaf the specs do not
  split on ``"model"`` has the same gradient on both model ranks of a
  data row (the conjugates' all-reduces: no sum runs over the model
  group).
* **The clip.**  The sharded norm equals one process's at rel 1e-6.
* **Collectives.**  Exact counts a step, by group: on the model group
  one all-reduce a part for the lookup, for each sublayer's two
  row-parallel sums, their two recomputed by remat (where the backward
  saved the sum) and their two conjugates' gradients, for the final
  norm's conjugate and for the
  cross-entropy's sums, one all-reduce of the logits' maxima a part, and
  the clip's; the FSDP and batch groups as ``tests/test_torch_dp_train.
  py`` counts them, per model coordinate.  The logits are never
  all-gathered: no group records an ``all_gather`` but the FSDP's.
* **Bytes.**  A rank's parameters and optimizer state equal
  ``shard_nbytes`` of the specs.
* **The backward rules alone**, on the same ranks with and without the
  staged (host) path: ``all_reduce``'s identity backward,
  ``all_reduce_grad``'s all-reduce, a column-parallel then row-parallel
  pair, a column-parallel product gathered whole and read in part by
  each rank (``all_gather``'s reduce-scatter backward), and
  ``vocab_parallel_cross_entropy`` (softcap, -1 targets) against
  ``cross_entropy`` of the whole logits, value and gradient.
* **The launcher.**  ``--data 2 --tp 2`` resumes from a ``--data 4``
  checkpoint (saving back the tree it restored, bitwise) and goes on
  within ``LOSS_RTOL`` of a straight ``--data 2 --tp 2`` run, whose
  checkpoint in turn goes on at ``--data 4`` and on one process.
* **Refusals.**  Query heads that do not divide the model ranks
  (granite-34b's 8 and gemma2's 4 over ``--tp 3``, item 6.8), MoE in
  the a2a form (6.2c-i-b) and the hybrid at ``--tp 2`` (6.2c), through
  the launcher (the hybrid's; it builds MoE in the psum form),
  ``make_sharded_train_step`` and ``Model.loss``.  KV heads that do not
  divide the ranks train (``tests/test_torch_kv_train.py``), whatever
  the rank's ``TP.kv_cache``: on the same four ranks both archs' smoke
  configs at ``model = 4`` give the same loss under a ``"sequence"`` TP
  as under a ``"heads"`` one.
"""

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
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.optim.optimizers import (  # noqa: E402
    square_norm,
    tree_leaves,
)
from repro_torch.train import sharding as S  # noqa: E402
from repro_torch.train.shard import (  # noqa: E402
    check_train_mesh,
    fsdp_split,
    grid_coords,
    model_split,
    shard_params,
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
# the backward rules alone: f32 sums in another order
RULE_RTOL = 1e-5
MESHES = {
    "data2model2": dict(pod=1, data=2, model=2, fsdp=True),
    "pods2model2": dict(multi_pod=True, pod=2, data=1, model=2, fsdp=True),
}
JAX_AXES = {"data2model2": ((2, 2), ("data", "model")),
            "pods2model2": ((2, 1, 2), ("pod", "data", "model"))}
CASES = {f"{arch}-{mesh}-{opt}": (arch, mesh, mb, opt)
         for arch in ("gemma2-2b", "internlm2-20b") for mesh in MESHES
         for mb, opt in ((0, "sgd"), (2, "adamw"))}


@functools.lru_cache(maxsize=None)
def jax_init(arch):
    """JAX's one-device init of ``arch``'s smoke config, as numpy."""

    model = j_build(j_smoke(arch), JCtx())
    params = model.init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def jax_opt_init(arch, opt):
    state = j_make_optimizer(JTrainConfig(**tc_kw(0, opt))).init(
        jax_init(arch))
    return jax.tree.map(np.asarray, state)


def batches(arch):
    pipe = JPipeline(j_smoke(arch).vocab_size, SEQ, B)
    return [dict(zip(("tokens", "targets"), pipe.batch_at(i)))
            for i in range(STEPS)]


JAX_STEP = """
import sys
import jax, numpy as np
from repro.compat import make_mesh
from repro.config import ShapeConfig, TrainConfig, get_smoke_config
from repro.data import LMTokenPipeline
from repro.launch.mesh import mesh_config_for
from repro.models import build_model
from repro.models.api import Ctx
from repro.train.step import make_train_step
cases = eval(sys.argv[1])
out = {}
for name, (arch, shape, axes, tc) in cases.items():
    init = np.load(sys.argv[2] + "/" + arch + ".npz")
    mesh = make_mesh(shape, axes)
    multi = "pod" in axes
    mcfg = mesh_config_for(mesh, multi_pod=multi, fsdp=True)
    cfg = get_smoke_config(arch)
    model = build_model(cfg, Ctx(mesh=mesh, remat=True,
                                 dp=("pod", "data") if multi else ("data",)))
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
    out[name + "|loss"] = np.asarray(losses)
    for p, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[name + "|" + jax.tree_util.keystr(p)] = np.asarray(x)
np.savez(sys.argv[3], **out)
""" % {"seq": SEQ, "b": B, "steps": STEPS}


def _start_jax(tmp):
    for arch in {a for a, *_ in CASES.values()}:
        flat = jax.tree_util.tree_flatten_with_path(jax_init(arch))[0]
        np.savez(os.path.join(tmp, f"{arch}.npz"),
                 **{jax.tree_util.keystr(p): x for p, x in flat})
    cases = {name: (arch, *JAX_AXES[mesh], tc_kw(mb, opt))
             for name, (arch, mesh, mb, opt) in CASES.items()}
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(_ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, "-c", JAX_STEP, repr(cases), tmp,
         os.path.join(tmp, "out.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)


def _case(rank, device, cfg, mesh_kw, tc_kw, params_np, opt_state, data):
    """One case on one rank: the gradient before any update and its
    norm, then two steps with every group's collectives counted."""

    import torch.distributed as dist

    mesh_cfg = MeshConfig(**mesh_kw)
    model = build_model(cfg, Ctx(remat=True), device=device)
    step, info = make_sharded_train_step(
        model, dist.group.WORLD, mesh_cfg, ShapeConfig("t", SEQ, B, "train"),
        TrainConfig(**tc_kw))
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
           "split": sorted(info["model"].ctx.tp.split)}
    del grads
    groups = grid_groups(info["grid"])
    for g in groups.values():
        g.stats.clear()
        g.timed = True
    losses = []
    for batch in data:
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    out.update(losses=losses, params=numpy_tree(params),
               counts={f"{k}_{op}": row[0] for k, g in groups.items()
                       for op, row in g.stats.items()})
    return out


# ---------------------------------------------------------------------- #
# the backward rules alone, on the same ranks
# ---------------------------------------------------------------------- #

RULE_N, RULE_D, RULE_H, RULE_V = 6, 8, 12, 20
RULE_CAP = 5.0
# the gather's check: the columns of the whole product each rank reads
# (overlapping: two ranks read some of the same columns, as two query
# heads read one KV head)
RULE_READ = 5


def rule_reads(rank):
    return [(2 * rank + j) % RULE_H for j in range(RULE_READ)]


def rule_inputs():
    """The seeded inputs of the rules' checks: x (N, d), the pair's w1 (d,
    h) column-split and w2 (h, d) row-split, a weight c (N, d), four
    ranks' partial sums p (4, N, d) and cotangents cs (4, N, d), the
    gather's cotangents cg (4, N, ``RULE_READ``), and logits (2, 3, V)
    with targets holding -1."""

    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    targets = rng.integers(0, RULE_V, (2, 3))
    targets[0, 1] = targets[1, 2] = -1
    return {"x": f(RULE_N, RULE_D), "w1": f(RULE_D, RULE_H),
            "w2": f(RULE_H, RULE_D), "c": f(RULE_N, RULE_D),
            "p": f(4, RULE_N, RULE_D), "cs": f(4, RULE_N, RULE_D),
            "cg": f(4, RULE_N, RULE_READ),
            "logits": 4 * f(2, 3, RULE_V), "targets": targets}


def _leaf(x):
    return torch.tensor(x, requires_grad=True)


def rules_rank(rank, staged, inp):
    """The rules under autograd on this rank of the world group (4
    ranks), staged through the host or not: each check's value and the
    gradients ``torch.autograd.grad`` gives, as numpy."""

    import torch.distributed as dist

    tp = L.TP(dist.group.WORLD, rank, 4, staged)
    n = 4
    out = {}
    # all_reduce: the sum of the ranks' p, its backward the identity
    p = _leaf(inp["p"][rank])
    y = L.all_reduce(p, tp)
    (gp,) = torch.autograd.grad((y * torch.tensor(inp["c"])).sum(), p)
    out["sum"], out["sum_grad"] = y.detach().numpy(), gp.numpy()
    out["sum_input_kept"] = bool(torch.equal(p.detach(), torch.tensor(
        inp["p"][rank])))
    # all_reduce_grad: x itself, its gradient the sum of the ranks'
    x = _leaf(inp["x"])
    z = L.all_reduce_grad(x, tp)
    (gx,) = torch.autograd.grad((z * torch.tensor(inp["cs"][rank])).sum(),
                                x)
    out["copy_equal"] = bool(torch.equal(z.detach(), x.detach()))
    out["copy_grad"] = gx.numpy()
    # the pair: x -> conjugate -> tanh(x @ w1[:, cols]) @ w2[cols] -> sum
    h = RULE_H // n
    x, w1, w2 = (_leaf(inp["x"]), _leaf(inp["w1"][:, rank * h:(rank + 1) * h]),
                 _leaf(inp["w2"][rank * h:(rank + 1) * h]))
    o = L.all_reduce(torch.tanh(L.all_reduce_grad(x, tp) @ w1) @ w2, tp)
    grads = torch.autograd.grad((o * torch.tensor(inp["c"])).sum(),
                                (x, w1, w2))
    out["pair"] = o.detach().numpy()
    out["pair_grads"] = [g.numpy() for g in grads]
    # the gather: x -> conjugate -> x @ w1[:, cols] gathered whole -> the
    # rank's columns read -> tanh, as k and v are gathered and read by the
    # rank's query heads
    x, w1 = _leaf(inp["x"]), _leaf(inp["w1"][:, rank * h:(rank + 1) * h])
    whole = L.all_gather(L.all_reduce_grad(x, tp) @ w1, tp, -1)
    read = torch.tanh(whole[:, rule_reads(rank)])
    grads = torch.autograd.grad(
        (read * torch.tensor(inp["cg"][rank])).sum(), (x, w1))
    out["gather"] = whole.detach().numpy()
    out["gather_grads"] = [g.numpy() for g in grads]
    # the vocab-parallel cross-entropy of the rank's softcapped range
    v = RULE_V // n
    lg = _leaf(inp["logits"][..., rank * v:(rank + 1) * v])
    loss = L.vocab_parallel_cross_entropy(
        L.softcap(lg, RULE_CAP), torch.tensor(inp["targets"]), tp)
    (gl,) = torch.autograd.grad(loss, lg)
    out["ce"], out["ce_grad"] = float(loss), gl.numpy()
    return out


# archs whose smoke configs' KV heads do not divide four model ranks,
# trained on them under either cache layout of the rank's TP
KV_LAYOUT_ARCHS = ("gemma2-2b", "granite-34b")


def kv_layouts_rank(rank, inputs):
    """Each arch's loss and gradients of its first batch on this rank of
    the world group at ``model = 4`` (its KV heads do not divide the
    ranks) under a ``TP`` holding its KV cache by ``"heads"`` and by
    ``"sequence"``: training holds no cache, so both train alike."""

    import torch.distributed as dist

    mesh_cfg = MeshConfig(data=1, model=4, fsdp=False)
    out = {}
    for arch, (params_np, batch) in inputs.items():
        cfg = get_smoke_config(arch)
        shapes = api.param_specs(build_model(cfg, device="meta"))
        pspecs = S.param_pspecs(cfg, shapes, mesh_cfg)
        params = shard_params(lm_params_from_numpy(params_np, "cpu"),
                              pspecs, mesh_cfg, rank)
        for layout in ("heads", "sequence"):
            tp = L.TP.of(dist.group.WORLD, "cpu",
                         model_split(shapes, pspecs), kv_cache=layout)
            loss, grads = loss_and_grads(
                build_model(cfg, Ctx(tp=tp), device="cpu").loss, params,
                [batch])
            out[arch, layout] = (float(loss), numpy_tree(grads))
    return out


def _rank(rank, device, jobs, rules, layouts):
    return ([_case(rank, device, *job) for job in jobs],
            {staged: rules_rank(rank, staged, rules)
             for staged in (False, True)},
            kv_layouts_rank(rank, layouts))


def runs(tmp):
    """Every case: (the grid's rank results, the rules' rank results,
    JAX's {key: array}, the KV layouts' rank results)."""

    proc = _start_jax(tmp)
    try:
        jobs = []
        for arch, mesh, mb, opt in CASES.values():
            jobs.append((get_smoke_config(arch), MESHES[mesh], tc_kw(mb, opt),
                         jax_init(arch),
                         opt_state_from_numpy(jax_opt_init(arch, opt), "cpu"),
                         batches(arch)))
        layouts = {arch: (jax_init(arch), batches(arch)[0])
                   for arch in KV_LAYOUT_ARCHS}
        ranks = glaunch.run_on_grid(_rank, (4, 1), jobs, rule_inputs(),
                                    layouts, device="cpu", timeout=300)
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    want = dict(np.load(os.path.join(tmp, "out.npz")))
    cases = {name: [r[0][i] for r in ranks] for i, name in enumerate(CASES)}
    return cases, [r[1] for r in ranks], want, [r[2] for r in ranks]


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return runs(str(tmp_path_factory.mktemp("tp_train")))


def _specs(arch, mesh):
    cfg = get_smoke_config(arch)
    shapes = api.param_specs(build_model(cfg, device="meta"))
    mesh_cfg = MeshConfig(**MESHES[mesh])
    return cfg, shapes, S.param_pspecs(cfg, shapes, mesh_cfg), mesh_cfg


@functools.lru_cache(maxsize=None)
def one_process(arch, mb):
    """One process's loss and gradient of the first batch at the init."""

    cfg = get_smoke_config(arch)
    model = build_model(cfg, Ctx(remat=True), device="cpu")
    params = lm_params_from_numpy(jax_init(arch), "cpu")
    loss, grads = loss_and_grads(model.loss, params,
                                 split_batch(batches(arch)[0], mb))
    return (float(loss), numpy_tree(grads),
            float(torch.sqrt(square_norm(grads))))


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_jax_sharded_step(grid, name):
    ranks, _, want, _ = grid
    ref = want[f"{name}|loss"]
    for r, res in enumerate(ranks[name]):
        assert len(res["losses"]) == STEPS
        np.testing.assert_allclose(res["losses"], ref, rtol=LOSS_RTOL,
                                   err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("name", list(CASES))
def test_params_match_jax_sharded_step(grid, name):
    ranks, _, want, _ = grid
    arch, mesh, _, opt = CASES[name]
    _, _, pspecs, mesh_cfg = _specs(arch, mesh)
    jtree_np = nested({k.split("|", 1)[1]: v for k, v in want.items()
                        if k.startswith(name + "|[")})
    diffs = []
    for r, res in enumerate(ranks[name]):
        ref = slices(jtree_np, pspecs, mesh_cfg, r)
        assert set(ref) == set(res["params"])
        for path, got in res["params"].items():
            if opt == "sgd":
                scale = float(np.abs(ref[path]).max())
                err = float(np.abs(got - ref[path]).max())
                assert err <= SGD_TOL * scale, (name, r, path, err, scale)
            else:
                diffs.append(np.abs(got - ref[path]).ravel())
    if opt == "adamw":
        d = np.concatenate(diffs)
        assert float(d.max()) <= ADAM_MAX * LR
        assert float(np.mean(d > 1e-3 * LR)) <= ADAM_FRAC


@pytest.mark.parametrize("name", list(CASES))
def test_shard_gradients_are_slices_of_one_process(grid, name):
    ranks, _, _, _ = grid
    arch, mesh, mb, _ = CASES[name]
    _, shapes, pspecs, mesh_cfg = _specs(arch, mesh)
    loss, grads, _ = one_process(arch, mb)
    model_paths = on_model(shapes, pspecs)
    # the embedding, each head and FFN product and the unembedding
    assert {"['embed']", "['units']['s0']['attn']['wq']",
            "['units']['s0']['mlp']['wo']"} <= model_paths
    tree_np = nested(grads)
    for r, res in enumerate(ranks[name]):
        np.testing.assert_allclose(res["loss0"], loss, rtol=LOSS_RTOL)
        ref = slices(tree_np, pspecs, mesh_cfg, r)
        for path, got in res["grads"].items():
            scale = float(np.abs(grads[path]).max())
            err = float(np.abs(got - ref[path]).max())
            assert err <= GRAD_TOL * scale, (name, r, path, err, scale)
            if path in model_paths:
                assert got.shape != grads[path].shape, path
                assert np.abs(got).max() > 0, (name, r, path)


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_agree_over_the_model_ranks(grid, name):
    """A leaf the specs keep whole on ``"model"`` (the norms) gets the
    same gradient on both model ranks of a data row, with no sum over the
    model group: the conjugates made each rank's the whole one."""

    ranks, _, _, _ = grid
    arch, mesh, _, _ = CASES[name]
    _, shapes, pspecs, mesh_cfg = _specs(arch, mesh)
    model_paths = on_model(shapes, pspecs)
    whole = [p for p in ranks[name][0]["grads"] if p not in model_paths]
    assert any("norm" in p for p in whole)
    for r, res in enumerate(ranks[name]):
        if grid_coords(mesh_cfg, r)["model"]:
            continue
        peer = ranks[name][r + 1]["grads"]
        for path in whole:
            np.testing.assert_array_equal(res["grads"][path], peer[path],
                                          err_msg=f"{name} {r} {path}")


@pytest.mark.parametrize("name", list(CASES))
def test_clip_norm_over_the_shards(grid, name):
    ranks, _, _, _ = grid
    arch, _, mb, _ = CASES[name]
    want = one_process(arch, mb)[2]
    for res in ranks[name]:
        assert abs(res["grad_norm"] - want) <= NORM_RTOL * want


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_a_step_are_exact(grid, name):
    ranks, _, _, _ = grid
    arch, mesh, mb, _ = CASES[name]
    cfg, shapes, pspecs, mesh_cfg = _specs(arch, mesh)
    split = fsdp_split(shapes, pspecs) if mesh_cfg.data > 1 else {}
    units = len(split.get("units", {}))
    n_units = cfg.num_layers // (cfg.local_global_pattern or 1)
    parts = max(mb, 1)
    n_leaves = len(tree_leaves(shapes))
    for res in ranks[name]:
        c = dict(res["counts"])
        assert res["split"] == sorted(model_split(shapes, pspecs))
        # a part: the lookup; each sublayer's two row-parallel sums, the
        # same two recomputed, its two conjugates' gradients; the final
        # norm's conjugate; the cross-entropy's sums; a step: the clip.
        # Remat (torch's non-reentrant checkpoint) stops recomputing a
        # unit once it has every tensor the backward saved: a unit that
        # ends in the residual add after the MLP's sum (no post-norm,
        # internlm2) does not sum again
        recomputed = 2 * cfg.num_layers - (
            0 if cfg.local_global_pattern else n_units)
        assert c.pop("model_all_reduce") == STEPS * (
            parts * (4 * cfg.num_layers + recomputed + 3) + 1), c
        assert c.pop("model_all_reduce_max") == STEPS * parts, c
        assert c.pop("batch_all_reduce") == STEPS * (
            n_leaves - units + parts + 1), c
        if units:
            assert c.pop("fsdp_all_gather") == STEPS * parts * n_units * 2
            assert c.pop("fsdp_reduce_scatter") == STEPS * parts * n_units
            assert c.pop("fsdp_all_reduce") == STEPS      # the clip's
        # nothing else: no gather of the logits, no sum over the pods
        # where no leaf is FSDP-split
        assert c == {}, c


@pytest.mark.parametrize("name", list(CASES))
def test_rank_bytes_are_shard_nbytes(grid, name):
    ranks, _, _, _ = grid
    arch, mesh, _, _ = CASES[name]
    _, shapes, _, _ = _specs(arch, mesh)
    one = sum(x.numel() * x.element_size() for x in tree_leaves(shapes))
    for res in ranks[name]:
        assert (res["param_bytes"], res["opt_bytes"]) == res["reckoned"]
        assert res["param_bytes"] < one


def _ce_reference(inp):
    logits = torch.tensor(inp["logits"], requires_grad=True)
    loss = L.cross_entropy(L.softcap(logits, RULE_CAP),
                           torch.tensor(inp["targets"]))
    (g,) = torch.autograd.grad(loss, logits)
    return float(loss.detach()), g.numpy()


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("rule", ["sum", "copy", "pair", "gather",
                                  "cross_entropy"])
def test_backward_rules_match_one_process(grid, rule, staged):
    """Each rank's gradients by ``torch.autograd.grad`` equal its slice of
    one process's, staged through the host or not."""

    _, rules, _, _ = grid
    inp = rule_inputs()
    c = torch.tensor(inp["c"])
    n = len(rules)
    if rule == "pair":
        x, w1, w2 = (torch.tensor(inp[k], requires_grad=True)
                     for k in ("x", "w1", "w2"))
        o = torch.tanh(x @ w1) @ w2
        want = torch.autograd.grad((o * c).sum(), (x, w1, w2))
        h = RULE_H // n
    elif rule == "gather":
        # one process: every rank's reads of the whole product, summed
        x, w1 = (torch.tensor(inp[k], requires_grad=True)
                 for k in ("x", "w1"))
        whole = x @ w1
        f = sum((torch.tanh(whole[:, rule_reads(r)])
                 * torch.tensor(inp["cg"][r])).sum() for r in range(n))
        want = torch.autograd.grad(f, (x, w1))
        h = RULE_H // n
    elif rule == "cross_entropy":
        ce, ce_grad = _ce_reference(inp)
        v = RULE_V // n
    for r, res in enumerate(rules):
        got = res[staged]
        if rule == "sum":
            np.testing.assert_allclose(got["sum"], inp["p"].sum(0),
                                       rtol=RULE_RTOL, atol=1e-6)
            np.testing.assert_array_equal(got["sum_grad"], inp["c"])
            assert got["sum_input_kept"]
        elif rule == "copy":
            assert got["copy_equal"]
            np.testing.assert_allclose(got["copy_grad"], inp["cs"].sum(0),
                                       rtol=RULE_RTOL, atol=1e-6)
        elif rule == "pair":
            np.testing.assert_allclose(got["pair"], o.detach().numpy(),
                                       rtol=RULE_RTOL, atol=1e-5)
            gx, gw1, gw2 = got["pair_grads"]
            cols = slice(r * h, (r + 1) * h)
            for a, b in ((gx, want[0]), (gw1, want[1][:, cols]),
                         (gw2, want[2][cols])):
                np.testing.assert_allclose(a, b.numpy(), rtol=RULE_RTOL,
                                           atol=1e-5)
        elif rule == "gather":
            np.testing.assert_allclose(got["gather"], whole.detach().numpy(),
                                       rtol=RULE_RTOL, atol=1e-5)
            gx, gw1 = got["gather_grads"]
            np.testing.assert_allclose(gx, want[0].numpy(), rtol=RULE_RTOL,
                                       atol=1e-5)
            np.testing.assert_allclose(gw1, want[1][:, r * h:(r + 1) * h]
                                       .numpy(), rtol=RULE_RTOL, atol=1e-5)
        else:
            np.testing.assert_allclose(got["ce"], ce, rtol=RULE_RTOL)
            np.testing.assert_allclose(
                got["ce_grad"], ce_grad[..., r * v:(r + 1) * v],
                rtol=RULE_RTOL, atol=1e-7)


# ---------------------------------------------------------------------- #
# the launcher
# ---------------------------------------------------------------------- #


@pytest.fixture
def launcher(monkeypatch):
    monkeypatch.setattr(tlaunch, "get_model_config", get_smoke_config)
    monkeypatch.setattr(tlaunch, "get_shape",
                        lambda name: ShapeConfig(name, SEQ, B, "train"))

    def run(steps, ckpt, *flags, arch="gemma2-2b"):
        return tlaunch.train(["--arch", arch, "--steps", str(steps),
                              "--microbatch", "2", "--ckpt", str(ckpt),
                              "--ckpt-every", "2", "--device", "cpu",
                              *flags])

    return run


def _saved(ckpt, step):
    cfg = get_smoke_config("gemma2-2b")
    shapes = api.param_specs(build_model(cfg, device="meta"))
    opt = tlaunch.make_optimizer(TrainConfig())
    return load_pytree(os.path.join(ckpt, f"step_{step:010d}"),
                       {"p": shapes, "o": opt.init(shapes)})


def test_launcher_checkpoints_move_between_model_and_data_ranks(
        launcher, tmp_path):
    tp = ("--data", "2", "--tp", "2")
    straight = launcher(4, tmp_path / "a", *tp)
    assert straight["backend"] == "gloo" and len(straight["ranks"]) == 4
    assert straight["mesh_cfg"].model == 2
    r0 = straight["ranks"][0]
    assert r0["collectives"]["model_all_reduce"][0] > 0
    assert not any("all_gather" in op for op in r0["collectives"]
                   if not op.startswith("fsdp_"))

    # a data-4 checkpoint restores on data 2 x model 2: the tree saved
    # back at once is the one restored, and the run goes on as the
    # straight one
    launcher(2, tmp_path / "b", "--data", "4")
    copy_step(tmp_path / "b", tmp_path / "c", 2)
    again = launcher(2, tmp_path / "c", *tp)
    assert again["ranks"][0]["start"] == 2 and not again["losses"]
    assert trees_equal(_saved(tmp_path / "c", 2), _saved(tmp_path / "b", 2))
    on = launcher(4, tmp_path / "c", *tp)
    np.testing.assert_allclose(on["losses"], straight["losses"][2:],
                               rtol=LOSS_RTOL)

    # and the straight run's checkpoint goes on at data 4 and on one
    # process
    for name, flags in (("d", ("--data", "4")), ("e", ())):
        copy_step(tmp_path / "a", tmp_path / name, 2)
        on = launcher(4, tmp_path / name, *flags)
        assert on["ranks"][0]["start"] == 2
        np.testing.assert_allclose(on["losses"], straight["losses"][2:],
                                   rtol=LOSS_RTOL, err_msg=name)
    assert on["mesh_cfg"].num_devices == 1


# ---------------------------------------------------------------------- #
# refusals
# ---------------------------------------------------------------------- #


def _loss_under(cfg, tp, moe_impl="psum"):
    return build_model(cfg, Ctx(tp=tp, moe_impl=moe_impl),
                       device="cpu").loss(
        {}, {"tokens": np.zeros((1, 2)), "targets": np.zeros((1, 2))})


@pytest.mark.parametrize("arch,tp,item", [
    ("granite-34b", 3, "6.8"),             # 8 query heads over 3
    ("gemma2-2b", 3, "6.8"),               # 4 query heads over 3
    ("granite-moe-3b-a800m", 2, "6.2c"),
    ("zamba2-2.7b", 2, "6.2c"),
])
def test_what_the_model_axis_does_not_train_is_refused(arch, tp, item,
                                                       launcher, tmp_path,
                                                       grid):
    cfg = get_smoke_config(arch)
    match = f"item {item}"
    # the MoE family trains on the model axis in the psum form
    # (tests/test_torch_moe_train.py), as the launcher builds it; its a2a
    # form is refused (item 6.2c-i-b)
    impl = "a2a" if cfg.family == "moe" else "psum"
    if cfg.family != "moe":
        with pytest.raises(NotImplementedError, match=match):
            launcher(1, tmp_path, "--tp", str(tp), arch=arch)
    with pytest.raises(NotImplementedError, match=match):
        check_train_mesh(MeshConfig(data=1, model=tp), cfg, B, 2,
                         moe_impl=impl)
    with pytest.raises(NotImplementedError, match=match):
        make_sharded_train_step(build_model(cfg, Ctx(moe_impl=impl),
                                            device="cpu"), None,
                                MeshConfig(data=1, model=tp),
                                ShapeConfig("t", SEQ, B, "train"),
                                TrainConfig())
    with pytest.raises(NotImplementedError, match=match):
        _loss_under(cfg, L.TP(group=None, rank=0, size=tp, staged=False),
                    impl)
    if cfg.family == "moe":
        check_train_mesh(MeshConfig(data=1, model=tp), cfg, B, 2)
        assert api.loss_refusal(cfg, Ctx(tp=L.TP(
            group=None, rank=0, size=tp, staged=False))) is None
    if cfg.family != "dense":
        return
    # the same model trains where its query heads divide the ranks,
    # whether its KV heads do (model 2) or not (model 4), and a TP that
    # holds its KV cache cut on its sequence trains with the same loss
    # and gradients as one that holds it by heads
    for model in (2, 4):
        check_train_mesh(MeshConfig(data=4 // model, model=model), cfg, B, 2)
        for kv_cache in L.TP.KV_CACHES:
            ok = L.TP(group=None, rank=0, size=model, staged=False,
                      kv_cache=kv_cache)
            assert api.loss_refusal(cfg, Ctx(tp=ok)) is None
    want = one_process(arch, 0)[0]
    for res in grid[3]:
        heads, seq = res[arch, "heads"], res[arch, "sequence"]
        assert heads[0] == seq[0]
        np.testing.assert_allclose(heads[0], want, rtol=LOSS_RTOL)
        assert heads[1].keys() == seq[1].keys()
        for path, g in heads[1].items():
            np.testing.assert_array_equal(g, seq[1][path], err_msg=path)
