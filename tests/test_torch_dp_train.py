"""The port's sharded train step on the data axis against the JAX
package's, on the CPU: four ``gloo`` ranks (``launch/gossip.py::
run_on_grid(..., device="cpu")``) on ``pod x data`` grids at ``model =
1``, FSDP on, at smoke sizes.

Cases (``CASES``): gemma2-2b's and internlm2-20b's smoke configs on a
``(data 4, model 1)`` and a ``(pod 2, data 2, model 1)`` grid, each with
microbatch 0 and SGD and with microbatch 2 and AdamW, two steps of the
global batch of 8 x 16 tokens from ``LMTokenPipeline``.  Parameters come
from JAX ``init`` through ``convert.lm_params_from_numpy`` and the
optimizer state from JAX's ``init`` through ``opt_state_from_numpy``,
both sliced by ``train/step.py::shard_state``.  Every case runs in one
grid of four ranks; JAX's ``make_train_step`` runs every case on four
host devices in one subprocess (``--xla_force_host_platform_device_count
=4``, as ``tests/test_torch_fsdp_serve.py`` runs one), beside the grid.

Held:

* **Against JAX's sharded step.**  Both steps' losses within rel
  ``LOSS_RTOL``; the parameters after two steps, each rank's shards
  against their slices of JAX's: SGD within ``SGD_TOL`` x max|leaf|,
  AdamW by ``tests/test_torch_train.py``'s rule (every coordinate within
  ``ADAM_MAX`` x lr, all but ``ADAM_FRAC`` of them within 1e-3 x lr).
* **Gradients.**  Each rank's gradient before the update (the step's
  ``info["grads"]``: reduce-scattered, summed over the pods, the
  replicated leaves all-reduced) equals its slice of one process's
  gradient of the whole batch within ``GRAD_TOL`` x max|leaf|, and no
  FSDP shard's gradient is all zero.
* **The clip.**  The sharded norm (``info["grad_norm"]``) equals one
  process's at rel 1e-6.
* **Collectives.**  A step makes exactly one FSDP all-gather a unit and
  microbatch part in the forward and one more in remat's recompute, one
  reduce-scatter a unit and part, one all-reduce over the pods a FSDP
  leaf at pod 2, and one over the batch group a replicated leaf, a part
  (the valid targets) and the loss.
* **Bytes.**  A rank's parameters and optimizer state equal
  ``shard_nbytes`` of the specs.
* **The launcher.**  ``launch.train.train --data 4``: 4 steps straight
  equal 2, a resume and 2 more, bitwise (the checkpoints); the step-2
  checkpoint restores at ``--multi-pod --data 2`` and on one process
  bitwise equal to the saved tree (each saves it again), loads in the
  JAX package's ``CheckpointManager``, and goes on within ``LOSS_RTOL``
  of the straight run.
* **One rank.**  At ``1 x 1`` the grid form's step is the one-card
  ``make_train_step`` (the step ``tests/test_torch_train.py`` holds
  against JAX's): two steps from one init agree bit for bit.
* **Refusals.**  What the model axis does not train yet: query heads
  that do not divide the model ranks (item 6.8) and SSM on model ranks
  (6.2c); SSM and hybrid on data ranks (6.2c), a microbatch part that
  does not split over the ranks (``ValueError``), and ``Model.loss``
  under those contexts.  The model axis itself trains:
  ``tests/test_torch_tp_train.py``, and where the KV heads do not divide
  it ``tests/test_torch_kv_train.py``; the MoE family trains on both
  axes (``tests/test_torch_moe_train.py``), its a2a form refused (item
  6.2c-i-b).
"""

import functools
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointManager as JCheckpoints  # noqa: E402
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
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.optim.optimizers import (  # noqa: E402
    square_norm,
    tree_leaves,
    tree_map_with_path,
)
from repro_torch.train import sharding as S  # noqa: E402
from repro_torch.train.shard import (  # noqa: E402
    check_train_mesh,
    fsdp_split,
    shard_leaf,
)
from repro_torch.train.step import (  # noqa: E402
    loss_and_grads,
    make_sharded_train_step,
    make_train_step,
    shard_state,
    split_batch,
)

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, SEQ, STEPS = 8, 16, 2
LR = 1e-3
# tests/test_torch_train.py's tolerances
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
SGD_TOL = 1e-5
ADAM_MAX = 0.25
ADAM_FRAC = 1e-3
NORM_RTOL = 1e-6
MESHES = {
    "data4": dict(pod=1, data=4, model=1, fsdp=True),
    "pods2x2": dict(multi_pod=True, pod=2, data=2, model=1, fsdp=True),
}
CASES = {f"{arch}-{mesh}-{opt}": (arch, mesh, mb, opt)
         for arch in ("gemma2-2b", "internlm2-20b") for mesh in MESHES
         for mb, opt in ((0, "sgd"), (2, "adamw"))}


def _tc(mb, opt):
    return dict(learning_rate=LR, warmup_steps=1, total_steps=10,
                microbatch=mb, optimizer=opt)


@functools.lru_cache(maxsize=None)
def jax_init(arch):
    """JAX's one-device init of ``arch``'s smoke config, as numpy."""

    model = j_build(j_smoke(arch), JCtx())
    params = model.init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def jax_opt_init(arch, opt):
    params = jax_init(arch)
    state = j_make_optimizer(JTrainConfig(**_tc(0, opt))).init(params)
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


def _jax_cases():
    axes = {"data4": ((4, 1), ("data", "model")),
            "pods2x2": ((2, 2, 1), ("pod", "data", "model"))}
    return {name: (arch, *axes[mesh], _tc(mb, opt))
            for name, (arch, mesh, mb, opt) in CASES.items()}


def _start_jax(tmp):
    for arch in {a for a, *_ in CASES.values()}:
        flat = jax.tree_util.tree_flatten_with_path(jax_init(arch))[0]
        np.savez(os.path.join(tmp, f"{arch}.npz"),
                 **{jax.tree_util.keystr(p): x for p, x in flat})
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(_ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, "-c", JAX_STEP, repr(_jax_cases()), tmp,
         os.path.join(tmp, "out.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)


def _numpy(tree):
    out = {}
    tree_map_with_path(lambda p, x: out.__setitem__(
        p, x.detach().cpu().numpy().copy()), tree)
    return out


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
    out = {"grads": _numpy(grads), "loss0": float(loss0),
           "grad_norm": float(info["grad_norm"](grads)),
           "param_bytes": sum(x.numel() * x.element_size()
                              for x in tree_leaves(params)),
           "opt_bytes": sum(x.numel() * x.element_size()
                            for x in tree_leaves(state)),
           "reckoned": (info["param_bytes"], info["opt_bytes"])}
    del grads
    grid = info["grid"]
    groups = {"fsdp": grid.fsdp, "batch": grid.batch, "pod": grid.pod}
    for g in groups.values():
        if g is not None:
            g.stats.clear()
            g.timed = True
    losses = []
    for batch in data:
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    out.update(losses=losses, params=_numpy(params),
               counts={f"{k}_{op}": row[0] for k, g in groups.items()
                       if g is not None for op, row in g.stats.items()})
    return out


def _rank(rank, device, jobs):
    return [_case(rank, device, *job) for job in jobs]


def runs(tmp):
    """Every case: (the grid's rank results, JAX's {key: array})."""

    proc = _start_jax(tmp)
    try:
        jobs = []
        for arch, mesh, mb, opt in CASES.values():
            jobs.append((get_smoke_config(arch), MESHES[mesh], _tc(mb, opt),
                         jax_init(arch),
                         opt_state_from_numpy(jax_opt_init(arch, opt), "cpu"),
                         batches(arch)))
        ranks = glaunch.run_on_grid(_rank, (4, 1), jobs, device="cpu",
                                    timeout=300)
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    want = dict(np.load(os.path.join(tmp, "out.npz")))
    return ({name: [r[i] for r in ranks] for i, name in enumerate(CASES)},
            want)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return runs(str(tmp_path_factory.mktemp("dp_train")))


def _specs(arch, mesh):
    cfg = get_smoke_config(arch)
    shapes = api.param_specs(build_model(cfg, device="meta"))
    mesh_cfg = MeshConfig(**MESHES[mesh])
    return cfg, shapes, S.param_pspecs(cfg, shapes, mesh_cfg), mesh_cfg


def _nested(flat):
    """``{"['a']['b']": x}`` as nested dicts ``{"a": {"b": x}}``."""

    out = {}
    for path, x in flat.items():
        keys = path[2:-2].split("']['")
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = x
    return out


def _slices(tree_np, pspecs, mesh_cfg, rank):
    """``{path: the rank's slice}`` of a numpy tree by ``pspecs``."""

    out = {}
    tree_map_with_path(lambda p, x, s: out.__setitem__(
        p, shard_leaf(x, s, mesh_cfg, rank).numpy()), tree_np, pspecs)
    return out


@functools.lru_cache(maxsize=None)
def one_process(arch, mb):
    """One process's loss and gradient of the first batch at the init."""

    cfg = get_smoke_config(arch)
    model = build_model(cfg, Ctx(remat=True), device="cpu")
    params = lm_params_from_numpy(jax_init(arch), "cpu")
    loss, grads = loss_and_grads(model.loss, params,
                                 split_batch(batches(arch)[0], mb))
    return float(loss), _numpy(grads), float(torch.sqrt(square_norm(grads)))


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
    ranks, want = grid
    arch, mesh, _, opt = CASES[name]
    _, _, pspecs, mesh_cfg = _specs(arch, mesh)
    # JAX's keystr spells a path as the port does
    jtree_np = _nested({k.split("|", 1)[1]: v for k, v in want.items()
                        if k.startswith(name + "|[")})
    diffs = []
    for r, res in enumerate(ranks[name]):
        ref = _slices(jtree_np, pspecs, mesh_cfg, r)
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
    ranks, _ = grid
    arch, mesh, mb, _ = CASES[name]
    _, shapes, pspecs, mesh_cfg = _specs(arch, mesh)
    loss, grads, _ = one_process(arch, mb)
    sharded = {f"['{top}']" + "".join(f"['{k}']" for k in keys)
               for top, leaves in fsdp_split(shapes, pspecs).items()
               for keys in leaves}
    assert sharded
    nested = _nested(grads)
    for r, res in enumerate(ranks[name]):
        np.testing.assert_allclose(res["loss0"], loss, rtol=LOSS_RTOL)
        ref = _slices(nested, pspecs, mesh_cfg, r)
        for path, got in res["grads"].items():
            scale = float(np.abs(grads[path]).max())
            err = float(np.abs(got - ref[path]).max())
            assert err <= GRAD_TOL * scale, (name, r, path, err, scale)
            if path in sharded:
                # the shard's gradient reached the leaf autograd knows
                assert got.shape != grads[path].shape
                assert np.abs(got).max() > 0, (name, r, path)


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
    units = len(fsdp_split(shapes, pspecs)["units"])
    n_units = cfg.num_layers // (cfg.local_global_pattern or 1)
    parts = max(mb, 1)
    n_leaves = len(tree_leaves(shapes))
    for res in ranks[name]:
        c = res["counts"]
        # forward and remat's recompute; one reduce-scatter in the backward
        assert c["fsdp_all_gather"] == STEPS * parts * n_units * 2, c
        assert c["fsdp_reduce_scatter"] == STEPS * parts * n_units, c
        assert c["fsdp_all_reduce"] == STEPS, c      # the clip's norm
        assert c["batch_all_reduce"] == STEPS * (
            n_leaves - units + parts + 1), c
        if mesh_cfg.pod > 1:
            assert c["pod_all_reduce"] == STEPS * units, c
        else:
            assert "pod_all_reduce" not in c


@pytest.mark.parametrize("name", list(CASES))
def test_rank_bytes_are_shard_nbytes(grid, name):
    ranks, _ = grid
    arch, mesh, _, _ = CASES[name]
    cfg, shapes, _, mesh_cfg = _specs(arch, mesh)
    one = sum(x.numel() * x.element_size() for x in tree_leaves(shapes))
    for res in ranks[name]:
        assert (res["param_bytes"], res["opt_bytes"]) == res["reckoned"]
        assert res["param_bytes"] < one


def test_one_rank_is_the_one_card_step():
    cfg = get_smoke_config("gemma2-2b")
    tc = TrainConfig(**_tc(2, "adamw"))

    def one_card(model):
        return make_train_step(model, tc), make_optimizer(tc)

    def grid_form(model):
        step, info = make_sharded_train_step(
            model, None, MeshConfig(data=1, model=1),
            ShapeConfig("t", SEQ, B, "train"), tc)
        return step, info["optimizer"]

    runs = []
    for make in (one_card, grid_form):
        step, opt = make(build_model(cfg, Ctx(remat=True), device="cpu"))
        params = lm_params_from_numpy(jax_init("gemma2-2b"), "cpu")
        state = opt.init(params)
        losses = []
        for batch in batches("gemma2-2b"):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        runs.append((losses, params, state))
    (la, pa, sa), (lb, pb, sb) = runs
    assert la == lb
    assert _equal(pa, pb) and _equal(sa, sb)


# ---------------------------------------------------------------------- #
# the launcher
# ---------------------------------------------------------------------- #


@pytest.fixture
def launcher(monkeypatch):
    monkeypatch.setattr(tlaunch, "get_model_config", get_smoke_config)
    monkeypatch.setattr(tlaunch, "get_shape",
                        lambda name: ShapeConfig(name, SEQ, B, "train"))

    def run(steps, ckpt, *flags):
        return tlaunch.train(["--arch", "gemma2-2b", "--steps", str(steps),
                              "--microbatch", "2", "--ckpt", str(ckpt),
                              "--ckpt-every", "2", "--device", "cpu",
                              *flags])

    return run


def _saved(ckpt, step):
    cfg = get_smoke_config("gemma2-2b")
    model = build_model(cfg, device="meta")
    shapes = api.param_specs(model)
    opt = tlaunch.make_optimizer(TrainConfig())
    return load_pytree(os.path.join(ckpt, f"step_{step:010d}"),
                       {"p": shapes, "o": opt.init(shapes)})


def _equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_launcher_resumes_bitwise_and_restores_on_other_grids(
        launcher, tmp_path):
    straight = launcher(4, tmp_path / "a", "--data", "4")
    assert straight["backend"] == "gloo" and len(straight["ranks"]) == 4
    launcher(2, tmp_path / "b", "--data", "4")
    resumed = launcher(4, tmp_path / "b", "--data", "4")
    assert all(r["start"] == 2 for r in resumed["ranks"])
    assert _equal(_saved(tmp_path / "a", 4), _saved(tmp_path / "b", 4))
    assert resumed["losses"] == straight["losses"][2:]

    saved = _saved(tmp_path / "a", 2)
    for name, flags in (("pods", ("--multi-pod", "--data", "2")),
                        ("one", ())):
        ckpt = tmp_path / name
        os.makedirs(ckpt)
        shutil.copytree(tmp_path / "a" / "step_0000000002",
                        ckpt / "step_0000000002")
        # resumed at step 2 and saved again at once: the tree it restored
        again = launcher(2, ckpt, *flags)
        assert again["ranks"][0]["start"] == 2 and not again["losses"]
        assert _equal(_saved(ckpt, 2), saved), name
        on = launcher(4, ckpt, *flags)
        np.testing.assert_allclose(on["losses"], straight["losses"][2:],
                                   rtol=LOSS_RTOL, err_msg=name)
    assert again["mesh_cfg"].num_devices == 1


def test_launcher_grid_has_no_deadline(launcher, tmp_path, monkeypatch):
    """A training run lasts as long as its steps: the launcher's grid is
    given no deadline (``run_on_grid``'s default ends it after 600 s)."""

    seen = {}

    def spy(*args, **kw):
        seen.update(kw)
        return glaunch.run_on_grid(*args, **kw)

    monkeypatch.setattr(tlaunch, "run_on_grid", spy)
    launcher(1, tmp_path, "--data", "4")
    assert "timeout" in seen and seen["timeout"] is None


def _rank_of(rank, device):
    import torch.distributed as dist

    backend = dist.group.WORLD._get_backend(torch.device("cpu"))
    return rank, backend.options._timeout.total_seconds()


def test_run_on_grid_without_a_deadline():
    """No deadline: a collective too waits as long as a peer's host work
    takes (``NO_DEADLINE``, not the backend's default limit, which ended a
    four-card ``launch.train`` run's ranks in the checkpoint's gather while
    rank 0 processed its profile); a deadline is each collective's."""

    week = glaunch.NO_DEADLINE.total_seconds()
    assert glaunch.run_on_grid(_rank_of, (2, 1), device="cpu",
                               timeout=None) == [(0, week), (1, week)]
    assert glaunch.run_on_grid(_rank_of, (2, 1), device="cpu",
                               timeout=60) == [(0, 60.0), (1, 60.0)]


def test_launcher_checkpoint_loads_in_the_jax_manager(launcher, tmp_path):
    launcher(2, tmp_path, "--data", "4")
    jm = j_build(j_smoke("gemma2-2b"), JCtx())
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jo = jax.eval_shape(j_make_optimizer(JTrainConfig()).init, jp)
    step, tree = JCheckpoints(str(tmp_path)).restore({"p": jp, "o": jo})
    assert step == 2
    ours = _saved(tmp_path, 2)
    jflat = jax.tree_util.tree_flatten_with_path(tree)[0]
    tflat = []
    tree_map_with_path(lambda p, x: tflat.append((p, x)), ours)
    tflat = dict(tflat)
    assert len(jflat) == len(tflat)
    for path, x in jflat:
        got = tflat[jax.tree_util.keystr(path)]
        assert np.array_equal(np.asarray(x), got.numpy()), path


# ---------------------------------------------------------------------- #
# refusals
# ---------------------------------------------------------------------- #


def test_model_axis_is_refused(launcher, tmp_path):
    """The model axis trains the dense and MoE families (``tests/test_
    torch_tp_train.py``, ``tests/test_torch_kv_train.py``, ``tests/test_
    torch_moe_train.py``); what it does not train yet is refused, naming
    its item: gemma2's 4 query heads over 3 model ranks (6.8: the rules
    cut the flat q width into parts of a head) and an SSM model on model
    ranks (6.2c)."""

    for arch, tp, item in (("gemma2-2b", 3, "6.8"),
                           ("mamba2-780m", 2, "6.2c")):
        match = f"item {item}"
        with pytest.raises(NotImplementedError, match=match):
            tlaunch.train(["--arch", arch, "--data", "1", "--tp", str(tp),
                           "--steps", "1", "--ckpt", str(tmp_path),
                           "--device", "cpu"])
        cfg = get_smoke_config(arch)
        with pytest.raises(NotImplementedError, match=match):
            make_sharded_train_step(build_model(cfg, device="cpu"), None,
                                    MeshConfig(data=1, model=tp),
                                    ShapeConfig("t", SEQ, B, "train"),
                                    TrainConfig())
        ranks = L.TP(group=None, rank=0, size=tp, staged=False)
        with pytest.raises(NotImplementedError, match=match):
            build_model(cfg, Ctx(tp=ranks), device="cpu").loss(
                {}, {"tokens": np.zeros((1, 2)),
                     "targets": np.zeros((1, 2))})


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "zamba2-2.7b",
                                  "mamba2-780m"])
def test_other_families_on_data_ranks_are_refused(arch):
    """The SSM and hybrid families on data ranks wait for item 6.2c.  The
    MoE family trains there (``tests/test_torch_moe_train.py``): its
    meshes pass, and only its a2a form on a model axis is refused (item
    6.2c-i-b)."""

    cfg = get_smoke_config(arch)
    batch_tp = L.TP(group=None, rank=0, size=4, staged=False)
    if cfg.family == "moe":
        for mesh in MESHES.values():
            check_train_mesh(MeshConfig(**mesh), cfg, B, 2)
        assert api.loss_refusal(
            cfg, Ctx(dp=("data",), dp_group=batch_tp)) is None
        with pytest.raises(NotImplementedError, match="item 6.2c-i-b"):
            check_train_mesh(MeshConfig(data=2, model=2), cfg, B, 2,
                             moe_impl="a2a")
        return
    for mesh in MESHES.values():
        with pytest.raises(NotImplementedError, match="item 6.2c"):
            check_train_mesh(MeshConfig(**mesh), cfg, B, 2)
    model = build_model(cfg, Ctx(dp=("data",), dp_group=batch_tp),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="item 6.2c"):
        model.loss({}, {"tokens": np.zeros((1, 2)),
                        "targets": np.zeros((1, 2))})
    # one rank trains any family, as one card does
    check_train_mesh(MeshConfig(data=1, model=1), cfg, B, 2)


@pytest.mark.parametrize("mesh,mb", [("data4", 4), ("pods2x2", 8),
                                     ("data4", 3)])
def test_parts_that_do_not_split_are_refused(mesh, mb, launcher, tmp_path):
    cfg = get_smoke_config("gemma2-2b")
    with pytest.raises(ValueError, match="does not split"):
        check_train_mesh(MeshConfig(**MESHES[mesh]), cfg, B, mb)
    with pytest.raises(ValueError, match="does not split"):
        make_sharded_train_step(build_model(cfg, device="cpu"), None,
                                MeshConfig(**MESHES[mesh]),
                                ShapeConfig("t", SEQ, B, "train"),
                                TrainConfig(microbatch=mb))


def test_fsdp_dry_counts_its_reduce_scatter():
    """``FSDP.dry`` counts the gather's backward on meta tensors as it
    counts the gather."""

    fsdp = L.FSDP.dry(4, {"units": {("w",): -2, ("v",): -1}})
    w = torch.empty((3, 5), device="meta", requires_grad=True)
    v = torch.empty((5, 2), device="meta", requires_grad=True)
    whole = fsdp.gather({"w": w, "v": v}, "units")
    assert whole["w"].shape == (12, 5) and whole["v"].shape == (5, 8)
    (whole["w"].sum() + whole["v"].sum()).backward()
    assert w.grad.shape == w.shape and v.grad.shape == v.shape
    assert fsdp.stats == {"all_gather": [1, 0.0, 100],
                          "reduce_scatter": [1, 0.0, 400]}
    # without autograd the gather is the plain one
    with torch.no_grad():
        fsdp.gather({"w": w, "v": v}, "units")
    assert fsdp.stats["all_gather"][0] == 2
    assert fsdp.stats["reduce_scatter"][0] == 1


def test_a_rank_loss_divides_by_the_whole_batch():
    """``Ctx.dp_group`` makes a rank's loss its rows' share: with a group
    of one rank it is the plain mean; the count is at least 1."""

    cfg = get_smoke_config("gemma2-2b")
    npp = jax_init("gemma2-2b")
    one = build_model(cfg, device="cpu")
    tp = L.TP(group=None, rank=0, size=1, staged=False)
    ctx = Ctx(dp=("data",), dp_group=tp)
    rank = build_model(cfg, ctx, device="cpu")
    params = lm_params_from_numpy(npp, "cpu")
    batch = batches("gemma2-2b")[0]
    with torch.no_grad():
        assert float(rank.loss(params, batch)) == float(
            one.loss(params, batch))
    none = dict(batch, targets=-np.ones_like(batch["targets"]))
    with torch.no_grad():
        assert float(rank.loss(params, none)) == 0.0
