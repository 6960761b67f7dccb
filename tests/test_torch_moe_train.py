"""The port's sharded train step of the MoE family against the JAX
package's on the same mesh, on the CPU: ``gloo`` ranks
(``launch/gossip.py::run_on_grid(..., device="cpu")``) at smoke sizes.

The reference's launcher trains the MoE family with expert parallelism in
the psum form wherever the model axis is above 1 (``ep_axis="model"``,
``ep_pad_to`` the model axis), and the port's launcher builds the same
model (``launch/train.py::train_ctx``), which every case here uses.  The
router's aux is not linear in the batch, and the reference reckons it
two ways (``models/moe.py::aux_reckoning``): at one model rank over the
whole part's tokens (GSPMD), on model ranks as the mean of the data
rows' auxes (the ``shard_map`` body's ``pmean``).

Cases (``CASES``), each two steps of the global batch of 8 x 16 tokens
from ``LMTokenPipeline``:

* granite-moe's smoke config at ``(data 4)`` with microbatch 2 and AdamW,
  FSDP: the global aux, its statistics summed over the batch group;
* granite-moe at ``(data 2, model 2)`` with SGD, FSDP: EP in the psum
  form, the mean of the two rows' auxes;
* deepseek's (an MLA + dense head sublayer, MLA + MoE units with a shared
  expert) at ``(data 1, model 4)`` with SGD and at ``(data 2, model 2)``
  with microbatch 2 and AdamW: MLA's whole latent (``wkv_a``,
  ``kv_norm``) summed over the model group;
* a granite-moe variant with 6 experts at ``(data 1, model 4)``, padded to
  8 (``Ctx.ep_pad_to``), AdamW: the last rank holds two padded experts;
* a granite-moe variant with a vocab of 515 rows at ``(data 2, model 2)``,
  microbatch 2, SGD: the rules keep the tied table whole on the model
  ranks (515 does not split in two), as the full config's 49,155 rows at
  model 2 and 4, so a rank's logits and cross-entropy are whole;
* the first two again with ``router_aux_loss_coef = 1.0`` (SGD): at the
  default coefficient the two conventions differ by about 6e-6 of the
  loss, under ``LOSS_RTOL``; at 1.0 by about 6e-3.

Parameters come from JAX ``init`` (with the case's expert padding)
through ``convert.lm_params_from_numpy`` and the optimizer state from
JAX's ``init``, both sliced by ``train/step.py::shard_state``.  Four JAX
subprocesses on four host devices each (``JAX_PROCS``) run the cases'
inits, ``make_train_step`` and the gradient at the init on the same mesh
(the step's ``grads_of``, jitted with the step's shardings); then one
grid of four ranks runs every case.

Held, with ``tests/_train_grid.py``'s tolerances:

* **Losses** of both steps within rel ``LOSS_RTOL`` of JAX's.
* **Parameters:** SGD after two steps within ``SGD_TOL`` x max|leaf|;
  AdamW by ``tests/test_torch_train.py``'s rule after step 1 and after
  step 2, which starts from JAX's parameters and state after step 1.
* **Gradients:** each rank's reduced gradient before the clip
  (``info["grads"]``) within ``GRAD_TOL`` x max|leaf| of its slice of
  JAX's; every leaf the specs keep whole on ``"model"`` (the router, the
  norms, MLA's latent, the odd-vocab table) equal on every model rank of
  a data row; the padded experts' gradients and AdamW moments exactly 0.
* **The clip:** the sharded norm within rel ``NORM_RTOL`` of the norm of
  the whole gradient assembled from the ranks' shards (each replicated
  leaf counted once), and within ``GRAD_TOL`` of JAX's.
* **Collectives** a step, exactly, by group, and the run lengths' host
  reads (one a MoE layer and part, again in remat's recompute).
* **Bytes:** a rank's parameters and state equal ``shard_nbytes``.
* **Refusals:** the a2a form on model ranks (item 6.2c-i-b), the SSM,
  hybrid, VLM and encoder-decoder families on more than one rank (6.2c),
  experts that neither divide the model axis nor are padded to it
  (``moe.EP_REASON``, 6.8.2d).
* **The launcher:** granite-moe's smoke config at ``--data 2 --tp 2``: its
  checkpoint goes on at ``--tp 4`` within ``LOSS_RTOL`` of the same
  checkpoint going on in one process (both reckon the aux over a part's
  tokens); the straight run's own loss there is the mean of its rows'
  auxes, which at this size is about 1e-4 of the loss away.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import get_smoke_config as j_smoke  # noqa: E402
from repro.data import LMTokenPipeline as JPipeline  # noqa: E402
from repro.optim.optimizers import AdamWState, SGDState  # noqa: E402
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
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.transformer import unit_spec  # noqa: E402
from repro_torch.optim.optimizers import (  # noqa: E402
    tree_leaves,
    tree_map_with_path,
)
from repro_torch.train import sharding as S  # noqa: E402
from repro_torch.train.shard import (  # noqa: E402
    check_train_mesh,
    fsdp_split,
    grid_coords,
    model_split,
    whole_kv,
)
from repro_torch.train.step import (  # noqa: E402
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
)

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# variant -> (arch, fields replaced, MoEConfig fields replaced), on both
# sides
VARIANTS = {
    "granite": ("granite-moe-3b-a800m", {}, {}),
    "deepseek": ("deepseek-v2-lite-16b", {}, {}),
    "granite6": ("granite-moe-3b-a800m", {}, dict(num_experts=6)),
    "granite515": ("granite-moe-3b-a800m", dict(vocab_size=515), {}),
    "granite-coef1": ("granite-moe-3b-a800m", {},
                      dict(router_aux_loss_coef=1.0)),
}
MESHES = {"data4": dict(pod=1, data=4, model=1, fsdp=True),
          "data2model2": dict(pod=1, data=2, model=2, fsdp=True),
          "model4": dict(pod=1, data=1, model=4, fsdp=True)}
JAX_AXES = {"data4": ((4, 1), ("data", "model")),
            "data2model2": ((2, 2), ("data", "model")),
            "model4": ((1, 4), ("data", "model"))}
# name -> (variant, mesh, microbatch, optimizer)
CASES = {
    "granite-data4-adamw": ("granite", "data4", 2, "adamw"),
    "granite-data2model2-sgd": ("granite", "data2model2", 0, "sgd"),
    "deepseek-model4-sgd": ("deepseek", "model4", 0, "sgd"),
    "deepseek-data2model2-adamw": ("deepseek", "data2model2", 2, "adamw"),
    "granite6-model4-adamw": ("granite6", "model4", 0, "adamw"),
    "granite515-data2model2-sgd": ("granite515", "data2model2", 2, "sgd"),
    "granite-coef1-data4-sgd": ("granite-coef1", "data4", 2, "sgd"),
    "granite-coef1-data2model2-sgd": ("granite-coef1", "data2model2", 0,
                                      "sgd"),
}
EXPERTS = ("['wi_gate']", "['wi_up']", "['wo']")
# JAX's cases run in this many subprocesses at once, dealt in this order
# (the deepseek cases, the longest, to different subprocesses)
JAX_PROCS = 4
JAX_ORDER = ("deepseek-model4-sgd", "deepseek-data2model2-adamw",
             "granite-data4-adamw", "granite-data2model2-sgd",
             "granite6-model4-adamw", "granite515-data2model2-sgd",
             "granite-coef1-data4-sgd", "granite-coef1-data2model2-sgd")


def _replaced(cfg, over, moe_over):
    cfg = dataclasses.replace(cfg, **over)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            **moe_over))


def config(variant):
    arch, over, moe_over = VARIANTS[variant]
    return _replaced(get_smoke_config(arch), over, moe_over)


def j_config(variant):
    arch, over, moe_over = VARIANTS[variant]
    return _replaced(j_smoke(arch), over, moe_over)


def pad_of(mesh) -> int:
    """The expert padding of a mesh, as both launchers set it."""

    model = MESHES[mesh]["model"]
    return model if model > 1 else 0


def batches(variant):
    pipe = JPipeline(j_config(variant).vocab_size, SEQ, B)
    return [dict(zip(("tokens", "targets"), pipe.batch_at(i)))
            for i in range(STEPS)]


JAX_STEP = """
import dataclasses, math, sys
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.config import ShapeConfig, TrainConfig, get_smoke_config
from repro.data import LMTokenPipeline
from repro.launch.mesh import mesh_config_for
from repro.models import build_model
from repro.models.api import Ctx
from repro.optim.optimizers import clip_by_global_norm
from repro.train.step import make_train_step
cases = eval(sys.argv[1])
out = {}
for name, (arch, over, moe_over, shape, axes, tc) in cases.items():
    mesh = make_mesh(shape, axes)
    mcfg = mesh_config_for(mesh, multi_pod=False, fsdp=True)
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           **moe_over))
    # the reference launcher's model (src/repro/launch/train.py)
    ep = mcfg.model > 1
    model = build_model(cfg, Ctx(mesh=mesh, remat=True, dp=("data",),
                                 ep_axis="model" if ep else None,
                                 ep_pad_to=mcfg.model if ep else 0))
    step, info = make_train_step(model, mesh, mcfg,
                                 ShapeConfig("t", %(seq)d, %(b)d, "train"),
                                 TrainConfig(**tc))
    # the init of one device (with the launcher's expert padding), which
    # the port's ranks start from too
    params = build_model(cfg, Ctx(ep_pad_to=mcfg.model if ep else 0)).init(
        jax.random.PRNGKey(0))
    opt = info["optimizer"].init(params)
    for key, tree in (("0", params), ("0o", opt)):
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[name + "|" + key + "|" + jax.tree_util.keystr(p)] = (
                np.asarray(x))
    params = jax.device_put(params, info["params"])
    opt = jax.device_put(opt, info["opt"])
    pipe = LMTokenPipeline(cfg.vocab_size, %(seq)d, %(b)d)
    n_micro = tc["microbatch"]

    def grads_of(params, batch):
        # the step's own (src/repro/train/step.py::grads_of)
        if n_micro and n_micro > 1:
            micro = jax.tree.map(lambda x: x.reshape(
                (n_micro, x.shape[0] // n_micro) + x.shape[1:]), batch)

            def acc_fn(carry, mb):
                loss, g = jax.value_and_grad(model.loss)(params, mb)
                acc_l, acc_g = carry
                return (acc_l + loss / n_micro, jax.tree.map(
                    lambda a, b: a + b / n_micro, acc_g, g)), None

            zero = (jnp.zeros((), jnp.float32), jax.tree.map(
                lambda p: jnp.zeros(p.shape, jnp.float32), params))
            return jax.lax.scan(acc_fn, zero, micro)[0]
        return jax.value_and_grad(model.loss)(params, batch)

    gfn = jax.jit(grads_of, in_shardings=(info["params"], info["batch"]),
                  out_shardings=(None, info["params"]))
    tok, tgt = pipe.batch_at(0)
    _, g = gfn(params, jax.device_put({"tokens": tok, "targets": tgt},
                                      info["batch"]))
    out[name + "|norm"] = np.asarray(clip_by_global_norm(g, 1.0)[1])
    for p, x in jax.tree_util.tree_flatten_with_path(g)[0]:
        out[name + "|g|" + jax.tree_util.keystr(p)] = np.asarray(x)
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
    for key, tree in (("p", params), ("o", opt)):
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[name + "|" + key + "|" + jax.tree_util.keystr(p)] = (
                np.asarray(x))
np.savez(sys.argv[2], **out)
""" % {"seq": SEQ, "b": B, "steps": STEPS}


def _start_jax(names, out):
    """A JAX subprocess running the cases ``names`` into ``out``."""

    cases = {}
    for name in names:
        variant, mesh, mb, opt = CASES[name]
        cases[name] = (*VARIANTS[variant], *JAX_AXES[mesh], tc_kw(mb, opt))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(_ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, "-c", JAX_STEP, repr(cases), out],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _case(rank, device, cfg, mesh_kw, tc, params_np, opt_state, data,
          restart):
    """One case on one rank: the gradient before any update, its norm and
    the run lengths' host reads, then two steps with every group's
    collectives and the host reads counted; with ``restart`` (JAX's
    parameters and optimizer state after step 1) the second step starts
    from it."""

    import torch.distributed as dist

    mesh_cfg = MeshConfig(**mesh_kw)
    model = build_model(cfg, tlaunch.train_ctx(cfg, mesh_cfg), device=device)
    step, info = make_sharded_train_step(
        model, dist.group.WORLD, mesh_cfg, ShapeConfig("t", SEQ, B, "train"),
        TrainConfig(**tc))
    params, state = shard_state(lm_params_from_numpy(params_np, device),
                                opt_state_from_numpy(opt_state, "cpu"),
                                info, rank, device)
    MOE.run_length_reads[0] = 0
    loss0, grads = info["grads"](params, data[0])
    out = {"grads": numpy_tree(grads), "loss0": float(loss0),
           "grad_norm": float(info["grad_norm"](grads)),
           "grads_reads": MOE.run_length_reads[0],
           "param_bytes": sum(x.numel() * x.element_size()
                              for x in tree_leaves(params)),
           "opt_bytes": sum(x.numel() * x.element_size()
                            for x in tree_leaves(state)),
           "reckoned": (info["param_bytes"], info["opt_bytes"]),
           "kv_whole": sorted(info["grid"].kv_whole)}
    del grads
    groups = grid_groups(info["grid"])
    for g in groups.values():
        g.stats.clear()
        g.timed = True
    MOE.run_length_reads[0] = 0
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
               reads=MOE.run_length_reads[0],
               counts={f"{k}_{op}": row[0] for k, g in groups.items()
                       for op, row in g.stats.items()})
    if hasattr(state, "mu"):
        out["moments"] = {"mu": numpy_tree(state.mu),
                          "nu": numpy_tree(state.nu)}
    return out


def _rank(rank, device, jobs):
    return [_case(rank, device, *job) for job in jobs]


def _opt_tree(want, name, key):
    """JAX's optimizer state ``key`` of case ``name`` as its NamedTuple
    of nested numpy dicts."""

    flat = _jax_flat(want, name, key)

    def field(f):
        return nested({k[len(f):]: v for k, v in flat.items()
                       if k.startswith(f + "[")})

    if ".mu['embed']" in flat:
        return AdamWState(flat[".step"], field(".mu"), field(".nu"))
    return SGDState(flat[".step"], field(".momentum") or ())


def _jax_flat(want, name, key):
    """``{path: array}`` of JAX's tree ``key`` of case ``name``."""

    head = f"{name}|{key}|"
    return {k[len(head):]: v for k, v in want.items() if k.startswith(head)}


def runs(tmp):
    """Every case: ({name: the ranks' results}, JAX's {key: array}).  JAX
    runs the cases in ``JAX_PROCS`` subprocesses at once.  An AdamW case's
    ranks start step 2 from JAX's state after step 1, so the grid runs
    after JAX's steps; trees cross to the ranks as numpy."""

    outs = [os.path.join(tmp, f"out{i}.npz") for i in range(JAX_PROCS)]
    procs = [_start_jax(JAX_ORDER[i::JAX_PROCS], out)
             for i, out in enumerate(outs)]
    errs = []
    try:
        for proc in procs:
            errs.append(proc.communicate(timeout=300)[1])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, err in zip(procs, errs):
        assert proc.returncode == 0, err[-4000:]
    want = {}
    for out in outs:
        want.update(np.load(out))
    jobs = []
    for name, (variant, mesh, mb, opt) in CASES.items():
        restart = None
        if opt == "adamw":
            restart = (nested(_jax_flat(want, name, "1")),
                       _opt_tree(want, name, "1o"))
        jobs.append((config(variant), MESHES[mesh], tc_kw(mb, opt),
                     nested(_jax_flat(want, name, "0")),
                     _opt_tree(want, name, "0o"), batches(variant), restart))
    ranks = glaunch.run_on_grid(_rank, (1, 4), jobs, device="cpu",
                                timeout=300)
    return {name: [r[i] for r in ranks]
            for i, name in enumerate(CASES)}, want


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return runs(str(tmp_path_factory.mktemp("moe_train")))


def _specs(variant, mesh):
    cfg = config(variant)
    mesh_cfg = MeshConfig(**MESHES[mesh])
    shapes = api.param_specs(build_model(
        cfg, tlaunch.train_ctx(cfg, mesh_cfg), device="meta"))
    return cfg, shapes, S.param_pspecs(cfg, shapes, mesh_cfg), mesh_cfg


def _padded(path, cfg) -> slice | None:
    """The padded experts of an expert leaf of the whole tree (its expert
    dim, the last three dims' first), or ``None``."""

    if "['moe']" in path and path.endswith(EXPERTS):
        return slice(cfg.moe.num_experts, None)
    return None


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_jax_sharded_step(grid, name):
    ranks, want = grid
    ref = want[f"{name}|loss"]
    for r, res in enumerate(ranks[name]):
        assert len(res["losses"]) == STEPS
        np.testing.assert_allclose(res["losses"], ref, rtol=LOSS_RTOL,
                                   err_msg=f"{name} rank {r}")
        np.testing.assert_allclose(res["loss0"], ref[0], rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_params_match_jax_sharded_step(grid, name):
    """SGD: the parameters after two steps.  AdamW: after step 1, and
    after step 2 from JAX's state after step 1, each by the rule (its
    update moves by up to lr where a gradient is within f32 rounding of
    zero)."""

    ranks, want = grid
    variant, mesh, _, opt = CASES[name]
    _, _, pspecs, mesh_cfg = _specs(variant, mesh)
    for key, got_key in (("p", "params"), ("1", "params1")):
        if key == "1" and opt == "sgd":
            continue
        ref_tree = nested(_jax_flat(want, name, key))
        diffs = []
        for r, res in enumerate(ranks[name]):
            ref = slices(ref_tree, pspecs, mesh_cfg, r)
            assert set(ref) == set(res[got_key])
            for path, got in res[got_key].items():
                if opt == "sgd":
                    scale = float(np.abs(ref[path]).max())
                    err = float(np.abs(got - ref[path]).max())
                    assert err <= SGD_TOL * scale, (name, r, path, err,
                                                    scale)
                else:
                    diffs.append(np.abs(got - ref[path]).ravel())
        if diffs:
            d = np.concatenate(diffs)
            assert float(d.max()) <= ADAM_MAX * LR, key
            assert float(np.mean(d > 1e-3 * LR)) <= ADAM_FRAC, key


@pytest.mark.parametrize("name", list(CASES))
def test_shard_gradients_are_slices_of_jax(grid, name):
    """Each rank's reduced gradient at the init against its slice of
    JAX's on the same mesh; every leaf but the padded experts' reaches
    the loss."""

    ranks, want = grid
    variant, mesh, _, _ = CASES[name]
    cfg, _, pspecs, mesh_cfg = _specs(variant, mesh)
    jflat = _jax_flat(want, name, "g")
    tree_np = nested(jflat)
    for r, res in enumerate(ranks[name]):
        ref = slices(tree_np, pspecs, mesh_cfg, r)
        assert set(ref) == set(res["grads"])
        for path, got in res["grads"].items():
            scale = float(np.abs(jflat[path]).max())
            err = float(np.abs(got - ref[path]).max())
            assert err <= GRAD_TOL * scale, (name, r, path, err, scale)
            if _padded(path, cfg) is None:
                assert np.abs(got).max() > 0, (name, r, path)


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_agree_over_the_model_ranks(grid, name):
    """A leaf the specs keep whole on ``"model"`` (the router, the norms,
    MLA's latent leaves, the odd-vocab table) gets the same gradient on
    every model rank of a data row: the router's through the combine
    weights' conjugate, the latent's after its sum over the model
    group."""

    ranks, _ = grid
    variant, mesh, _, _ = CASES[name]
    _, shapes, pspecs, mesh_cfg = _specs(variant, mesh)
    if mesh_cfg.model == 1:
        return
    whole = [p for p in ranks[name][0]["grads"]
             if p not in on_model(shapes, pspecs)]
    assert any(p.endswith("['router']") for p in whole)
    assert set(ranks[name][0]["kv_whole"]) <= set(whole)
    if variant == "deepseek":
        assert {p for p in whole if p.endswith(("['wkv_a']",
                                                "['kv_norm']"))} == set(
            ranks[name][0]["kv_whole"])
    if variant == "granite515":
        assert "['embed']" in whole
    for r, res in enumerate(ranks[name]):
        if grid_coords(mesh_cfg, r)["model"]:
            continue
        for peer in ranks[name][r + 1:r + mesh_cfg.model]:
            for path in whole:
                np.testing.assert_array_equal(
                    res["grads"][path], peer["grads"][path],
                    err_msg=f"{name} {r} {path}")


def test_padded_experts_stay_exactly_zero(grid):
    """6 experts padded to 8 at model 4: the last rank holds experts 6
    and 7, which the router never picks; their gradients and AdamW
    moments are exactly 0, in JAX and in the port."""

    ranks, want = grid
    name = "granite6-model4-adamw"
    cfg, shapes, pspecs, mesh_cfg = _specs("granite6", "model4")
    jg = _jax_flat(want, name, "g")
    jo = _jax_flat(want, name, "o")
    padded = [p for p in jg if _padded(p, cfg) is not None]
    assert padded and all(jg[p].shape[-3] == 8 for p in padded)
    for p in padded:
        assert not np.any(jg[p][..., 6:, :, :]), p
        assert np.any(jg[p][..., :6, :, :]), p
        for field in (".mu", ".nu"):
            assert not np.any(jo[field + p][..., 6:, :, :]), (field, p)
    last = ranks[name][3]
    for p in padded:
        assert not np.any(last["grads"][p]), p
        for field in ("mu", "nu"):
            assert not np.any(last["moments"][field][p]), (field, p)
    # the other ranks' experts are routed to
    for res in ranks[name][:3]:
        for p in padded:
            assert np.any(res["grads"][p]), p


@pytest.mark.parametrize("name", list(CASES))
def test_clip_norm_over_the_shards(grid, name):
    """The sharded norm (``TrainGrid.sq_norm``) against the norm of the
    whole gradient assembled from the ranks' shards, each replicated leaf
    once (float64), and against JAX's."""

    ranks, want = grid
    variant, mesh, _, _ = CASES[name]
    _, shapes, pspecs, mesh_cfg = _specs(variant, mesh)
    sq = 0.0
    specs = {}
    tree_map_with_path(lambda p, _, s: specs.__setitem__(p, s), shapes,
                       pspecs)
    assert set(specs) == set(ranks[name][0]["grads"])
    for path, spec in specs.items():
        # the ranks that hold distinct slices of the leaf
        seen = {}
        for r, res in enumerate(ranks[name]):
            c = grid_coords(mesh_cfg, r)
            key = tuple(c[a] if any(a == e or (isinstance(e, tuple)
                                               and a in e) for e in spec)
                        else 0 for a in ("pod", "data", "model"))
            seen.setdefault(key, res["grads"][path])
        sq += sum(float(np.square(g.astype(np.float64)).sum())
                  for g in seen.values())
    whole = float(np.sqrt(sq))
    jnorm = float(want[f"{name}|norm"])
    for res in ranks[name]:
        assert abs(res["grad_norm"] - whole) <= NORM_RTOL * whole
        assert abs(res["grad_norm"] - jnorm) <= GRAD_TOL * jnorm


def _counts(cfg, shapes, pspecs, mesh_cfg, mb):
    """The collectives of a step, by group and op, and the run lengths'
    host reads.  A MoE layer and part: the router's sums over the batch
    group at one model rank (one in the forward, again in remat's
    recompute, one in the backward); on model ranks the experts' sum
    (forward only: the recompute stops before it, once it has every
    tensor the backward saved) and its two conjugates' gradients (the
    experts' input, the combine weights)."""

    parts = max(mb, 1)
    _, n_scan, head = unit_spec(cfg)
    n_moe = n_scan
    layers = cfg.num_layers
    split = fsdp_split(shapes, pspecs) if mesh_cfg.data > 1 else {}
    units = len(split.get("units", {}))
    heads = len(split.get("head0", {}))
    n_leaves = len(tree_leaves(shapes))
    want = {}
    if mesh_cfg.model > 1:
        tied_whole = "['embed']" not in on_model(shapes, pspecs)
        # a part: the lookup's sum (none where the table is whole), each
        # sublayer's attention sum, each dense MLP's, each MoE's, the
        # attention sums that remat recomputes (the head sublayer is not
        # recomputed), the mixer input's conjugate, each dense MLP's, each
        # MoE's two, the final norm's conjugate (none where the table is
        # whole) and the cross-entropy's sum (none where whole)
        per_part = (layers                      # attention's sum
                    + 2 * len(head)             # head: MLP sum + conjugate
                    + n_moe                     # the experts' sum
                    + n_moe                     # recomputed attention sums
                    + layers                    # mixer input's conjugate
                    + 2 * n_moe                 # MoE's two conjugates
                    + (0 if tied_whole else 3))
        want["model_all_reduce"] = STEPS * (
            parts * per_part + 1 + len(whole_kv(shapes, pspecs)))
        if not tied_whole:
            want["model_all_reduce_max"] = STEPS * parts
        if cfg.num_kv_heads % mesh_cfg.model:
            want["model_all_gather"] = STEPS * parts * layers * 2
            want["model_reduce_scatter"] = STEPS * parts * layers
    if mesh_cfg.data > 1:
        stats = 0 if mesh_cfg.model > 1 else 3 * n_moe
        want["batch_all_reduce"] = STEPS * (
            n_leaves - units - heads + parts * (1 + stats) + 1)
    if units:
        n_units = n_scan
        want["fsdp_all_gather"] = STEPS * parts * (n_units * 2 + len(head)
                                                   * (1 if heads else 0))
        want["fsdp_reduce_scatter"] = STEPS * parts * (
            n_units + (len(head) if heads else 0))
        want["fsdp_all_reduce"] = STEPS          # the clip's
    reads = STEPS * parts * n_moe * 2
    return want, reads


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_a_step_are_exact(grid, name):
    ranks, _ = grid
    variant, mesh, mb, _ = CASES[name]
    cfg, shapes, pspecs, mesh_cfg = _specs(variant, mesh)
    want, reads = _counts(cfg, shapes, pspecs, mesh_cfg, mb)
    for res in ranks[name]:
        assert res["counts"] == want, (res["counts"], want)
        assert res["reads"] == reads
        assert res["grads_reads"] == reads // STEPS
        assert res["kv_whole"] == sorted(whole_kv(shapes, pspecs))


@pytest.mark.parametrize("name", list(CASES))
def test_rank_bytes_are_shard_nbytes(grid, name):
    ranks, _ = grid
    variant, mesh, _, _ = CASES[name]
    _, shapes, _, _ = _specs(variant, mesh)
    one = sum(x.numel() * x.element_size() for x in tree_leaves(shapes))
    for res in ranks[name]:
        assert (res["param_bytes"], res["opt_bytes"]) == res["reckoned"]
        assert res["param_bytes"] < one


def test_the_rules_keep_the_odd_vocab_table_whole_on_the_model_ranks():
    """granite-moe's 49,155 rows (3 x 5 x 29 x 113) split over neither 2
    nor 4 model ranks, and the 515 rows of the test's variant not over
    2; the smoke config's 512 do."""

    for variant, model, whole in (("granite515", 2, True),
                                  ("granite", 2, False)):
        cfg = config(variant)
        shapes = api.param_specs(build_model(cfg, device="meta"))
        for mesh_cfg in (MeshConfig(data=2, model=model),):
            specs = S.param_pspecs(cfg, shapes, mesh_cfg)
            assert (specs["embed"][0] is None) == whole
    full = tlaunch.get_model_config("granite-moe-3b-a800m")
    assert full.vocab_size == 49155 and full.tie_embeddings
    assert all(full.vocab_size % m for m in (2, 4))


# ---------------------------------------------------------------------- #
# refusals
# ---------------------------------------------------------------------- #


def test_a2a_training_is_refused():
    """Training in the a2a form on model ranks names item 6.2c-i-b; the
    psum form trains, and at one model rank the form is not used."""

    cfg = get_smoke_config("granite-moe-3b-a800m")
    mesh_cfg = MeshConfig(data=2, model=2)
    shape = ShapeConfig("t", SEQ, B, "train")
    with pytest.raises(NotImplementedError, match=r"item 6\.2c-i-b"):
        check_train_mesh(mesh_cfg, cfg, B, 2, moe_impl="a2a")
    with pytest.raises(NotImplementedError, match=r"item 6\.2c-i-b"):
        make_sharded_train_step(
            build_model(cfg, Ctx(moe_impl="a2a"), device="cpu"), None,
            mesh_cfg, shape, TrainConfig())
    tp = L.TP(group=None, rank=0, size=2, staged=False)
    with pytest.raises(NotImplementedError, match=r"item 6\.2c-i-b"):
        build_model(cfg, Ctx(tp=tp, moe_impl="a2a"), device="cpu").loss(
            {}, {"tokens": np.zeros((1, 2)), "targets": np.zeros((1, 2))})
    check_train_mesh(mesh_cfg, cfg, B, 2)
    check_train_mesh(MeshConfig(data=4, model=1), cfg, B, 2,
                     moe_impl="a2a")
    assert api.loss_refusal(cfg, Ctx(tp=tp)) is None


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b",
                                  "internvl2-76b", "whisper-large-v3"])
def test_other_families_on_more_than_one_rank_are_refused(arch):
    cfg = get_smoke_config(arch)
    for mesh_cfg in (MeshConfig(data=4, model=1),
                     MeshConfig(data=2, model=2),
                     MeshConfig(data=1, model=2)):
        with pytest.raises(NotImplementedError, match=r"item 6\.2c\)"):
            check_train_mesh(mesh_cfg, cfg, B, 2)
    assert "6.2c" in api.tp_train_refusal(cfg, 2)
    batch_tp = L.TP(group=None, rank=0, size=4, staged=False)
    assert "6.2c" in api.loss_refusal(
        cfg, Ctx(dp=("data",), dp_group=batch_tp))


def test_experts_that_neither_divide_nor_are_padded_are_refused():
    """6 experts over 4 model ranks unpadded: the rules split them on
    their width, which the port does not train or serve (item 6.8.2d);
    padded to 8 (the launcher's ``train_ctx``) they split by expert."""

    cfg = config("granite6")
    mesh_cfg = MeshConfig(data=1, model=4)
    shapes = api.param_specs(build_model(cfg, device="meta"))
    with pytest.raises(NotImplementedError, match=r"6\.8\.2d"):
        model_split(shapes, S.param_pspecs(cfg, shapes, mesh_cfg))
    tp = L.TP.dry(4)
    p = {"router": torch.zeros((cfg.d_model, 6), device="meta"),
         "wi_gate": torch.zeros((6, cfg.d_model, 8), device="meta")}
    with pytest.raises(NotImplementedError, match=r"6\.8\.2d") as err:
        MOE.moe_ffn(p, torch.zeros((1, 2, cfg.d_model), device="meta"),
                    cfg.moe, tp=tp)
    assert str(err.value) == MOE.EP_REASON
    assert tlaunch.train_ctx(cfg, mesh_cfg).ep_pad_to == 4
    assert tlaunch.train_ctx(cfg, MeshConfig(data=4, model=1)).ep_pad_to == 0


def test_aux_reckoning_follows_the_mesh():
    """One function picks the convention: the batch group's sums at one
    model rank, the row's own aux on model ranks; the share is 1/n of
    the batch group either way."""

    batch = L.TP.dry(4)
    model = L.TP.dry(2)
    assert MOE.aux_reckoning(None, None) == (None, 1)
    assert MOE.aux_reckoning(None, batch) == (batch, 4)
    assert MOE.aux_reckoning(L.TP.dry(1), batch) == (batch, 4)
    assert MOE.aux_reckoning(model, batch) == (None, 4)
    assert MOE.aux_reckoning(model, None) == (None, 1)


def test_psum_sums_both_ways():
    """``layers.psum``'s backward sums the ranks' gradients, where
    ``all_reduce``'s is the identity (counted on meta tensors)."""

    tp = L.TP.dry(4)
    x = torch.empty((3,), device="meta", requires_grad=True)
    L.psum(x, tp).sum().backward()
    assert tp.stats["all_reduce"][0] == 2
    y = torch.empty((3,), device="meta", requires_grad=True)
    L.all_reduce(y, tp).sum().backward()
    assert tp.stats["all_reduce"][0] == 3
    assert L.psum(x, None) is x


# ---------------------------------------------------------------------- #
# the launcher
# ---------------------------------------------------------------------- #


@pytest.fixture
def launcher(monkeypatch):
    monkeypatch.setattr(tlaunch, "get_model_config", get_smoke_config)
    monkeypatch.setattr(tlaunch, "get_shape",
                        lambda name: ShapeConfig(name, SEQ, B, "train"))

    def run(steps, ckpt, *flags):
        return tlaunch.train(["--arch", "granite-moe-3b-a800m", "--steps",
                              str(steps), "--microbatch", "2", "--ckpt",
                              str(ckpt), "--ckpt-every", "2", "--device",
                              "cpu", *flags])

    return run


def _rows_aux_loss(ckpt, step, batch_at, data):
    """One process's loss of batch ``batch_at`` at checkpoint ``step``
    with each MoE layer's aux reckoned as the mean of the ``data`` rows'
    auxes (each part's rows cut over ``data`` ranks in order), as JAX's
    ``shard_map`` body reckons it at data x model."""

    cfg = get_smoke_config("granite-moe-3b-a800m")
    model = build_model(cfg, Ctx(), device="cpu")
    shapes = api.param_specs(model)
    opt = tlaunch.make_optimizer(TrainConfig())
    tree = load_pytree(os.path.join(ckpt, f"step_{step:010d}"),
                       {"p": shapes, "o": opt.init(shapes)})
    route = MOE.route

    def rows_route(params, xt, moe_cfg, group=None):
        top_idx, top_w, _ = route(params, xt, moe_cfg)
        auxes = [route(params, rows, moe_cfg)[2]
                 for rows in xt.chunk(data)]
        return top_idx, top_w, sum(auxes) / data

    pipe = JPipeline(cfg.vocab_size, SEQ, B)
    tok, tgt = pipe.batch_at(batch_at)
    parts = split_batch({"tokens": tok, "targets": tgt}, 2)
    MOE.route = rows_route
    try:
        with torch.no_grad():
            return sum(float(model.loss(tree["p"], p)) for p in parts) / 2
    finally:
        MOE.route = route


def test_launcher_checkpoint_goes_on_from_data_and_model_to_model_ranks(
        launcher, tmp_path):
    """A ``--data 2 --tp 2`` checkpoint goes on at ``--tp 4`` as it goes on
    in one process: both reckon the aux over a part's tokens, and their
    losses agree within ``LOSS_RTOL``.  The straight run at ``--data 2
    --tp 2`` reckons the mean of its two data rows' auxes, as the
    reference does there; at the smoke size (32 tokens a row and part)
    that moves the loss by about 1e-4 of it, past ``LOSS_RTOL``, so its
    loss at the checkpoint is held against one process's with that
    reckoning instead."""

    straight = launcher(4, tmp_path / "a", "--data", "2", "--tp", "2")
    assert straight["backend"] == "gloo" and len(straight["ranks"]) == 4
    ops = straight["ranks"][0]["collectives"]
    assert ops["model_all_reduce"][0] > 0 and ops["batch_all_reduce"][0] > 0
    for name in ("b", "c"):
        copy_step(tmp_path / "a", tmp_path / name, 2)
    on = launcher(4, tmp_path / "b", "--tp", "4")
    one = launcher(4, tmp_path / "c")
    assert on["mesh_cfg"].model == 4 and on["ranks"][0]["start"] == 2
    assert one["mesh_cfg"].num_devices == 1
    np.testing.assert_allclose(on["losses"], one["losses"], rtol=LOSS_RTOL)
    rows = _rows_aux_loss(tmp_path / "a", 2, 2, 2)
    np.testing.assert_allclose(straight["losses"][2], rows, rtol=LOSS_RTOL)
    assert abs(straight["losses"][2] - on["losses"][0]) > (
        LOSS_RTOL * on["losses"][0])
