"""Train and eval step factories of the LM harness (port of
``repro.train.step``): on one card, and on a ``pod x data`` grid of
ranks.

``make_train_step`` builds the one-card step: the model loss and its
gradients by autograd, optional microbatched gradient accumulation, then
the optimizer update.  The JAX step's buffer donation has its
counterpart: the step updates ``params`` and ``opt_state`` in place and
returns them.

With ``microbatch = n > 1`` the leading batch dim is split into n equal
parts as the JAX step's ``grads_of`` splits it; each part's forward is
followed by the backward of ``loss_i / n``, which adds into the
parameters' ``.grad``, so the gradients of the n parts sum in one tree
(JAX's ``lax.scan`` carries a second, zero-initialised one) and only one
part's activations are alive at a time.  The loss is Σ loss_i / n.

``make_sharded_train_step(model, group, mesh_cfg, shape_cfg, train_cfg)``
is the grid form of the reference's ``make_train_step`` on a ``pod x
data x model`` mesh, FSDP on or off: where the JAX step is one program
whose collectives and their transposes GSPMD inserts, the port's runs on
one rank of a ``torch.distributed`` group of ``pod x data x model``
ranks (the whole default group; ``launch/lm_engine.py::grid_groups``).
The step takes the rank's parameter shards (``train/shard.py``: the
rules' specs, the FSDP shards of a unit in one buffer) and optimizer
state (the same specs, ``opt_pspecs``), and the **global** batch.  It
splits the batch into the microbatch parts as the JAX step does, then
cuts each part's rows over ``pod x data`` as the rules cut the part, so
that each part's mean covers JAX's tokens: a rank's loss is its rows' token losses over
the part's valid targets, counted over the batch group
(``Ctx.dp_group``), and the ranks' losses sum to JAX's.  The model ranks
of a data row run the same rows: the rank's model holds its heads, FFN
columns and vocab range (``Ctx.tp``, the split ``train/shard.py::
model_split`` names, as serving splits them), and the backward rules of
``models/layers.py`` (an all-reduce's identity backward, its conjugate's
all-reduce, the vocab-parallel cross-entropy) give every model rank its
own shards' gradients and the same, whole gradient of each leaf
replicated on ``"model"``.  The MoE family trains in the psum form,
its experts split by expert over the model ranks (padded to the axis by
``Ctx.ep_pad_to`` where they do not divide it): the experts' input and
the combine weights enter through the conjugate, so the router's
gradient is whole on every model rank, and the router's aux is the
reference's on the mesh (``models/moe.py::aux_reckoning``): at one
model rank its statistics summed over the batch group (a sum whose
backward sums, ``layers.psum``), on model ranks the data row's own, each
rank adding its ``1/n`` share.  Gradients: an FSDP leaf's arrives
reduce-scattered over the FSDP group by the gather's backward
(``models/layers.py::FSDP``), summed over the pods by an all-reduce over
the cross-pod group; any other leaf's (``embed``, the norms) is
all-reduced over the batch group once, after the last part.  The batch
and FSDP groups are per model coordinate, so a model-split leaf is
summed only with the ranks that hold its shard.  One sum runs over the
model group: where the KV heads do not divide the model ranks and the
rules keep ``wk``/``wv`` (and their biases) whole, each rank computes k
and v whole but reads only its query heads' KV heads, and MLA's
``wkv_a`` and ``kv_norm``, which the rules keep whole, give the latent
and the shared rope key that a rank's heads read through its ``wkv_b``
slice, so those leaves' gradients (``train/shard.py::whole_kv``) are
each rank's heads' share and are summed over the model group once a
step, after the sums above and before the clip (the latent's share of
the input's gradient is summed by the mixer input's conjugate); where
the rules cut ``wk``/``wv`` in parts of a head, k and v are gathered
and the gather's backward reduce-scatters (``models/layers.py::
all_gather``).  The clip takes the norm over the whole tree: the shards'
squares summed over the FSDP group and over the model group as their
specs split them, each replicated leaf counted once (``sq_norm``; a
whole k/v or latent leaf is the same on every model rank after its sum,
the router's and a tied table kept whole on the model ranks are before
it).  Parameters and state update in
place; where the FSDP ranks share one card and read each other's shards
(``FSDP.one_card``), every rank then synchronizes its card and the group
passes a barrier before the next gather.
``train/shard.py::check_train_mesh`` refuses the families other than the
dense and MoE ones on more than one rank (6.2c), the MoE family's a2a
form on model ranks (6.2c-i-b), query heads that do not divide the model
ranks (6.8), and parts that do not split.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.config import MeshConfig, ShapeConfig, TrainConfig
from repro_torch.models.api import (Model, build_model, input_specs,
                                    param_specs)
from repro_torch.models.layers import FSDP, TP, all_gather, all_reduce
from repro_torch.optim import Optimizer, apply_updates, make_optimizer
from repro_torch.optim.optimizers import (AdamWState, SGDState,
                                          square_norm, tree_leaves,
                                          tree_map, tree_map_with_path)
from repro_torch.train import sharding as S
from repro_torch.train.shard import (check_train_mesh, fsdp_split,
                                     model_split, shard_leaf, shard_nbytes,
                                     shard_params, whole_kv)


def loss_and_grads(loss_fn, params, batches):
    """(Σ_i loss_fn(params, b_i) / n, its gradient tree) over the n
    batches in ``batches``, one forward and backward at a time.  The
    gradients are new tensors (the leaves' ``.grad``, detached from them
    afterwards); ``params``' ``requires_grad`` flags are left as found."""

    leaves = tree_leaves(params)
    flags = [p.requires_grad for p in leaves]
    n = len(batches)
    for p in leaves:
        p.grad = None
        p.requires_grad_(True)
    try:
        total = None
        for batch in batches:
            loss = loss_fn(params, batch)
            if n > 1:
                loss = loss / n
            loss.backward()
            loss = loss.detach()
            total = loss if total is None else total + loss
        grads = tree_map(
            lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
            params)
    finally:
        for p, flag in zip(leaves, flags):
            p.grad = None
            p.requires_grad_(flag)
    return total, grads


def split_batch(batch: dict, n: int) -> list[dict]:
    """The batch as n equal parts of its leading dim (``[batch]`` for
    n <= 1)."""

    if not n or n <= 1:
        return [batch]
    size = {len(v) for v in batch.values()}
    if len(size) != 1 or next(iter(size)) % n:
        raise ValueError(f"cannot split the batch's leading dims "
                         f"{sorted(size)} into {n} equal parts")
    m = next(iter(size)) // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def _step(grads_of, optimizer: Optimizer, after=None):
    """The train step of either form: ``grads_of(params, batch) -> (loss,
    grads)``, the optimizer update applied in place, then ``after()``."""

    def train_step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        if after is not None:
            after()
        return params, opt_state, {"loss": loss}

    return train_step


def make_train_step(model: Model, train_cfg: TrainConfig,
                    optimizer: Optimizer | None = None):
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss":
    loss})``; ``params`` and ``opt_state`` are updated in place."""

    n_micro = train_cfg.microbatch
    return _step(lambda params, batch: loss_and_grads(
        model.loss, params, split_batch(batch, n_micro)),
        optimizer or make_optimizer(train_cfg))


def make_eval_step(model: Model):
    """``step(params, batch) -> loss``, without autograd."""

    @torch.no_grad()
    def eval_step(params, batch):
        return model.loss(params, batch)

    return eval_step


# ---------------------------------------------------------------------------
# The step on a pod x data grid of ranks
# ---------------------------------------------------------------------------


def opt_pspecs(opt_state: Any, param_specs_tree: Any):
    """Optimizer-state specs mirror the parameter specs (ZeRO for free),
    as the JAX package's ``opt_pspecs``."""

    if isinstance(opt_state, AdamWState):
        return AdamWState(S.P(), param_specs_tree, param_specs_tree)
    if isinstance(opt_state, SGDState):
        mom = param_specs_tree if opt_state.momentum != () else ()
        return SGDState(S.P(), mom)
    raise TypeError(type(opt_state))


def _axis_dim(spec, axis: str) -> int | None:
    """The dim a spec puts on ``axis`` (``"data"``: an FSDP shard's;
    ``"model"``: a model shard's), or None."""

    for d, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return d
    return None


def _fsdp_paths(split: dict) -> frozenset:
    """The parameter paths of ``fsdp_split``'s leaves, spelled as
    ``tree_map_with_path`` spells them."""

    return frozenset(f"['{top}']" + "".join(f"['{k}']" for k in keys)
                     for top, leaves in split.items() for keys in leaves)


def _model_paths(shapes, pspecs) -> frozenset:
    """The parameter paths whose specs split them on ``"model"``."""

    out = []
    tree_map_with_path(lambda path, _, spec: out.append(path)
                       if _axis_dim(spec, "model") is not None else None,
                       shapes, pspecs)
    return frozenset(out)


@dataclasses.dataclass(eq=False)
class TrainGrid:
    """A training rank's place on the grid: the mesh, its rank, the
    ``TP`` of its batch group (every ``pod x data`` rank at its model
    coordinate), of its cross-pod group (``None`` in one pod) and its
    ``FSDP`` group (``None`` without FSDP), the paths of the leaves it
    holds FSDP shards of, the ``TP`` of its model group (``None`` at one
    model rank; the rank model's ``Ctx.tp``), the paths of the leaves it
    holds model shards of and those of the k/v and MLA latent leaves it
    holds whole under a split ``wo`` (``train/shard.py::whole_kv``)."""

    mesh_cfg: MeshConfig
    rank: int
    batch: TP | None
    pod: TP | None
    fsdp: FSDP | None
    sharded: frozenset
    model: TP | None = None
    split: frozenset = frozenset()
    kv_whole: frozenset = frozenset()

    def parts(self, batch: dict, n_micro: int) -> list[dict]:
        """The rank's rows of each microbatch part of the global
        ``batch``: the part as the JAX step splits it, then cut over
        ``pod x data`` as the rules cut it."""

        spec = S.P(S.dp_axes(self.mesh_cfg), None)
        return [{k: v if self.batch is None else
                 shard_leaf(v, spec, self.mesh_cfg, self.rank)
                 for k, v in part.items()}
                for part in split_batch(batch, n_micro)]

    def reduce(self, grads):
        """The gradient tree summed over the grid: an FSDP leaf's over the
        pods (the reduce-scatter summed it over the pod's data ranks), any
        other leaf's over the batch group (the ranks at the rank's model
        coordinate: a model shard's with the ranks that hold it); a whole
        k/v or latent leaf's then over the model group too (each rank's
        holds its query heads' share)."""

        def leaf(path, g):
            g = all_reduce(g, self.pod if path in self.sharded
                           else self.batch, inplace=True)
            if path in self.kv_whole:
                g = all_reduce(g, self.model, inplace=True)
            return g

        return tree_map_with_path(leaf, grads)

    def sq_norm(self, grads) -> torch.Tensor:
        """‖g‖² of the whole tree: the rank's FSDP shards' squares summed
        over the FSDP group, its model shards' over the model group (a
        leaf split on both over both: one all-reduce a group), each
        replicated leaf's counted once."""

        if not self.sharded and not self.split:
            return square_norm(grads)
        by = {}
        tree_map_with_path(lambda path, g: by.setdefault(
            (path in self.sharded, path in self.split), []).append(g),
            grads)
        sq = {k: square_norm(v) for k, v in by.items()}
        total = sq.get((False, False), 0.0)
        if not self.split:
            return total + all_reduce(sq[True, False], self.fsdp)
        zero = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(grads)[0].device)
        fsdp_only, both = all_reduce(torch.stack(
            [sq.get((True, False), zero), sq.get((True, True), zero)]),
            self.fsdp)
        return total + fsdp_only + all_reduce(
            both + sq.get((False, True), zero), self.model)

    def whole(self, tree, specs, keep: bool):
        """``tree`` (parameters or optimizer state) with every FSDP shard
        gathered whole over the FSDP group (the pods hold the same
        shards) and every model shard over the model group (the data
        rows hold the same ones), on the host where ``keep``, else
        ``None`` leaves: a checkpoint, in the JAX package's format, of
        the whole tree."""

        def leaf(path, x, spec):
            for axis, group in (("data", self.fsdp), ("model", self.model)):
                d = _axis_dim(spec, axis)
                if d is not None and group is not None:
                    x = all_gather(x, group, d)
            return x.detach().cpu() if keep else None

        return tree_map_with_path(leaf, tree, specs)


def make_sharded_train_step(model: Model, group, mesh_cfg: MeshConfig,
                            shape_cfg: ShapeConfig, train_cfg: TrainConfig):
    """``(step, info)``: ``step(params, opt_state, batch) -> (params,
    opt_state, {"loss": loss})`` on this rank's shards of a ``pod x data
    x model`` grid, ``batch`` the global batch of ``shape_cfg``;
    ``loss`` is the whole batch's mean on every rank.  ``info``: the specs
    (``pspecs``, ``ospecs``, ``bspecs``), the rank's ``model`` and
    ``grid`` (``TrainGrid``), the ``optimizer`` (``TrainConfig``'s, its
    clip over the whole tree), the reckoned bytes of a rank's shards
    (``param_bytes``, ``opt_bytes``), ``grads(params, batch) -> (loss,
    grads)`` (the rank's reduced gradients, before the clip) and
    ``grad_norm(grads)``.  On one rank the step is ``make_train_step``'s
    own (the one-card step), with these ``info`` keys."""

    cfg = model.cfg
    B, n_micro = shape_cfg.global_batch, train_cfg.microbatch
    check_train_mesh(mesh_cfg, cfg, B, n_micro, model.ctx.moe_impl)
    shapes = param_specs(model)
    pspecs = S.param_pspecs(cfg, shapes, mesh_cfg)
    bspecs = S.batch_pspecs(cfg, shape_cfg, mesh_cfg,
                            input_specs(cfg, shape_cfg))
    split = fsdp_split(shapes, pspecs) if mesh_cfg.data > 1 else {}
    device = model.device
    if mesh_cfg.num_devices == 1:
        grid = TrainGrid(mesh_cfg, 0, None, None, None, frozenset())
        rank_model = model
    else:
        # here, not at the top: launch/lm_engine.py imports this package
        from repro_torch.launch.lm_engine import grid_groups

        if group is None:
            raise ValueError(f"a {mesh_cfg.pod} x {mesh_cfg.data} x "
                             f"{mesh_cfg.model} grid of ranks needs its "
                             "process group")
        model_group, fsdp_group, batch_group, pod_group = grid_groups(
            group, mesh_cfg)
        tp = None
        if mesh_cfg.model > 1:
            # the split serving's ranks use (launch/lm_engine.py)
            tp = TP.of(model_group, device, model_split(shapes, pspecs))
        grid = TrainGrid(
            mesh_cfg, dist.get_rank(group),
            None if batch_group is None else TP.of(batch_group, device),
            None if pod_group is None else TP.of(pod_group, device),
            FSDP.of(fsdp_group, device, split) if split else None,
            _fsdp_paths(split), tp,
            _model_paths(shapes, pspecs) if tp is not None else frozenset(),
            whole_kv(shapes, pspecs) if tp is not None else frozenset())
        rank_model = build_model(cfg, dataclasses.replace(
            model.ctx, tp=tp, fsdp=grid.fsdp,
            dp=None if grid.batch is None else S.dp_axes(mesh_cfg),
            dp_group=grid.batch), device=device)
    optimizer = make_optimizer(train_cfg, grid.sq_norm)
    opt_shapes = optimizer.init(shapes)
    ospecs = opt_pspecs(opt_shapes, pspecs)

    def grads_of(params, batch):
        rows = {len(v) for v in batch.values()}
        if rows != {B}:
            raise ValueError(f"the step takes the global batch of {B} "
                             f"rows, got {sorted(rows)}")
        loss, grads = loss_and_grads(rank_model.loss, params,
                                     grid.parts(batch, n_micro))
        return all_reduce(loss, grid.batch), grid.reduce(grads)

    def after():
        # the peers read these shards at the next gather; one_card is
        # known from the first gather on
        if grid.fsdp is not None and grid.fsdp.one_card:
            torch.cuda.synchronize(device)
            dist.barrier(group=grid.fsdp.group)

    if mesh_cfg.num_devices == 1:
        train_step = make_train_step(model, train_cfg, optimizer)
    else:
        train_step = _step(grads_of, optimizer, after)

    info = {"pspecs": pspecs, "ospecs": ospecs, "bspecs": bspecs,
            "model": rank_model, "grid": grid, "optimizer": optimizer,
            "param_bytes": shard_nbytes(shapes, pspecs, mesh_cfg),
            "opt_bytes": shard_nbytes(opt_shapes, ospecs, mesh_cfg),
            "grads": grads_of,
            "grad_norm": lambda grads: torch.sqrt(grid.sq_norm(grads))}
    return train_step, info


def shard_state(params, opt_state, info, rank: int, device):
    """A rank's shards of a whole parameter tree and optimizer state (a
    seeded init, or a checkpoint read on the host) by the step's specs:
    the parameters laid out as ``train/shard.py::shard_params`` lays them
    out, the state cut leaf by leaf, both on ``device``."""

    mesh_cfg = info["grid"].mesh_cfg
    params = shard_params(params, info["pspecs"], mesh_cfg, rank, device)
    opt_state = tree_map_with_path(
        lambda _, x, spec: shard_leaf(x, spec, mesh_cfg, rank).to(device),
        opt_state, info["ospecs"])
    return params, opt_state
