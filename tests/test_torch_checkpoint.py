"""The port's checkpoints against the JAX package's, on the CPU.

* One on-disk format: a nested dict of arrays saved by JAX
  ``save_pytree`` loads in the port's ``load_pytree`` and the reverse,
  leaf for leaf (values, dtypes and shapes exactly); so do optimizer
  states (``AdamWState``/``SGDState`` NamedTuples under ``.field`` paths),
  each side getting back its own NamedTuple type.
* ``CheckpointManager``: a partial ``step_<n>.tmp``, a missing or
  incomplete manifest, a missing shard and a stale ``LATEST`` are
  skipped; ``keep`` garbage-collects old steps.
* Resume is bit-exact within the port: a fit stopped after its second
  checkpoint and resumed with ``resume_from=`` equals the uninterrupted
  fit bitwise, for Sequential, Wave and FullGD on both layouts.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as jck  # noqa: E402
from repro import mc as jmc  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch import mc as tmc  # noqa: E402
from repro_torch.config import GossipMCConfig as TConfig  # noqa: E402
from repro_torch.data import lowrank_problem  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

torch.set_num_threads(2)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "U": rng.normal(size=(2, 3, 5, 4)).astype(np.float32),
        "t": np.asarray(17, np.int32),
        "nested": {"mask": rng.random((7,)) < 0.5,
                   "ids": rng.integers(0, 99, (3, 2)).astype(np.int64),
                   "pair": [np.float32(1.5), np.arange(4, dtype=np.float32)]},
        "b": rng.normal(size=(6,)).astype(np.float64),
    }


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_jax_save_loads_in_the_port(tmp_path):
    tree = _tree(0)
    jck.save_pytree(tree, str(tmp_path / "c"))
    got = tck.load_pytree(str(tmp_path / "c"), tree, device="cpu")
    for g, w in zip(_leaves(got), _leaves(tree)):
        assert isinstance(g, torch.Tensor)
        _equal(g.numpy(), w)
    assert isinstance(got["nested"]["pair"], list)


def test_port_save_loads_in_jax(tmp_path):
    tree = _tree(1)
    as_torch = {"U": torch.from_numpy(tree["U"]), "t": torch.tensor(17,
                dtype=torch.int32), "nested": {
                "mask": torch.from_numpy(tree["nested"]["mask"]),
                "ids": torch.from_numpy(tree["nested"]["ids"]),
                "pair": [1.5, torch.arange(4, dtype=torch.float32)]},
                "b": torch.from_numpy(tree["b"])}
    tck.save_pytree(as_torch, str(tmp_path / "c"), shard_bytes=16)
    like = {"U": 0, "t": 0, "nested": {"mask": 0, "ids": 0,
                                       "pair": [0, 0]}, "b": 0}
    got = jck.load_pytree(str(tmp_path / "c"), like)
    want = dict(tree)
    want["nested"] = dict(tree["nested"], pair=[
        np.float64(1.5), np.arange(4, dtype=np.float32)])
    for g, w in zip(_leaves(got), _leaves(want)):
        # jax loads through jnp.asarray, which keeps 32-bit types
        _equal(np.asarray(g), np.asarray(jnp.asarray(w)))
    # the two packages write the same skeleton for the same tree
    jck.save_pytree(want, str(tmp_path / "j"), shard_bytes=16)
    with open(tmp_path / "c" / "skeleton.json") as f, \
            open(tmp_path / "j" / "skeleton.json") as g:
        assert json.load(f) == json.load(g)


_OPTIMIZERS = {
    "adamw": lambda m: m.adamw(m.cosine_warmup(1e-2, 0, 10)),
    "sgd": lambda m: m.sgd(m.cosine_warmup(1e-2, 0, 10)),
    "paper_sgd": lambda m: m.paper_sgd(1e-3, 0.1),
}


@pytest.mark.parametrize("kind", sorted(_OPTIMIZERS))
def test_optimizer_states_cross_both_ways(tmp_path, kind):
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": {"x": rng.normal(size=(5,)).astype(np.float32)}}
    grads = {"w": rng.normal(size=(4, 3)).astype(np.float32),
             "b": {"x": rng.normal(size=(5,)).astype(np.float32)}}
    jo = _OPTIMIZERS[kind](jopt)
    _, jstate = jo.update(grads, jo.init(params), params)
    jtree = {"p": params, "o": jstate}
    jck.save_pytree(jtree, str(tmp_path / "j"))
    with open(tmp_path / "j" / "skeleton.json") as f:
        paths = [e["path"] for e in json.load(f)]
    assert "['o'].step" in paths
    if kind == "adamw":
        assert "['o'].mu['w']" in paths and "['o'].nu['b']['x']" in paths

    tparams = {"w": torch.zeros(4, 3), "b": {"x": torch.zeros(5)}}
    like = {"p": tparams, "o": _OPTIMIZERS[kind](topt).init(tparams)}
    got = tck.load_pytree(str(tmp_path / "j"), like, device="cpu")
    assert type(got["o"]) is type(like["o"])
    assert got["o"].step.dtype == torch.int32 and int(got["o"].step) == 1
    want = [np.asarray(x) for x in jax.tree.leaves(jtree)]
    assert len(list(_leaves(got))) == len(want)
    for g, w in zip(tck.manager._flatten(got), want):
        _equal(g[1].numpy(), w)

    # and back: the port's save of the same tree is JAX's, skeleton and all
    tck.save_pytree(got, str(tmp_path / "t"))
    with open(tmp_path / "t" / "skeleton.json") as f, \
            open(tmp_path / "j" / "skeleton.json") as g:
        assert json.load(f) == json.load(g)
    back = jck.load_pytree(str(tmp_path / "t"), jtree)
    assert type(back["o"]) is type(jstate)
    for g, w in zip(jax.tree.leaves(back), want):
        _equal(np.asarray(g), w)


def _manager(tmp_path, steps=(1, 2, 3), keep=5):
    mgr = tck.CheckpointManager(str(tmp_path), keep=keep)
    for s in steps:
        mgr.save(s, {"x": torch.full((3,), float(s))})
    return mgr


@pytest.mark.parametrize("damage", ["tmp_dir", "no_manifest",
                                    "incomplete_manifest", "missing_shard",
                                    "stale_latest"])
def test_manager_skips_a_damaged_step(tmp_path, damage):
    mgr = _manager(tmp_path)
    top = os.path.join(str(tmp_path), "step_0000000003")
    if damage == "tmp_dir":
        os.rename(top, top + ".tmp")
    elif damage == "no_manifest":
        os.remove(os.path.join(top, "MANIFEST.json"))
        os.remove(os.path.join(top, "a00000_s000.npy"))
    elif damage == "incomplete_manifest":
        with open(os.path.join(top, "MANIFEST.json"), "w") as f:
            json.dump({"num_leaves": 1, "files": [], "complete": False}, f)
    elif damage == "missing_shard":
        os.remove(os.path.join(top, "a00000_s000.npy"))
    else:
        with open(os.path.join(str(tmp_path), "LATEST"), "w") as f:
            f.write("99")
    want = 3 if damage == "stale_latest" else 2
    assert mgr.latest_step() == want
    assert mgr.valid_steps()[-1] == want
    step, tree = mgr.restore({"x": 0})
    assert step == want and torch.equal(tree["x"], torch.full((3,),
                                                              float(want)))
    # the reference's manager reads the same directory the same way
    assert jck.CheckpointManager(str(tmp_path)).latest_step() == want


def test_manager_keeps_the_newest_steps(tmp_path):
    mgr = _manager(tmp_path, steps=range(1, 7), keep=2)
    assert mgr.valid_steps() == [5, 6]
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009.tmp"))
    mgr.save(7, {"x": torch.zeros(3)})
    assert mgr.valid_steps() == [6, 7]
    assert not [d for d in os.listdir(str(tmp_path)) if d.endswith(".tmp")]
    assert tck.CheckpointManager(str(tmp_path / "empty")).restore(
        {"x": 0}) is None


def test_checkpoint_validation_equals_the_reference(tmp_path):
    msgs = []
    for mod in (tmc, jmc):
        with pytest.raises(ValueError) as err:
            mod.Checkpoint(str(tmp_path), every=0)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


M, N, R = 48, 40, 3
SCHEDULES = {
    "sequential": (tmc.Sequential(num_iters=90, eval_every=30), 60),
    "wave": (tmc.Wave(num_rounds=9, eval_every=3), 6),
    "full": (tmc.FullGD(num_rounds=9, eval_every=3), 6),
}


class _Stop(tmc.Callback):
    def __init__(self, unit):
        self.unit = unit

    def on_eval(self, unit, cost, state, key):
        if unit >= self.unit:
            raise KeyboardInterrupt


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_resume_is_bitwise_the_uninterrupted_fit(tmp_path, name, layout):
    sched, stop_at = SCHEDULES[name]
    prob = tmc.CompletionProblem.from_dataset(
        lowrank_problem(M, N, R, density=0.3, seed=0), 4, 4, R,
        layout=layout, device="cpu")
    trainer = tmc.Trainer(TConfig(m=M, n=N, p=4, q=4, rank=R))
    whole = trainer.fit(prob, sched, seed=7)
    ck = tmc.Checkpoint(str(tmp_path))
    with pytest.raises(KeyboardInterrupt):
        tmc.Trainer(trainer.cfg, callbacks=[ck, _Stop(stop_at)]).fit(
            prob, sched, seed=7)
    assert ck.manager.valid_steps() == [stop_at // 2, stop_at]
    unit, state, key = ck.restore(prob)
    assert unit == stop_at and key.dtype == torch.uint8
    res = trainer.fit(prob, sched, seed=7, resume_from=str(tmp_path))
    assert torch.equal(res.state.U, whole.state.U)
    assert torch.equal(res.state.W, whole.state.W)
    assert res.t == whole.t
    assert res.history == whole.history[2:]


def test_restore_session_refuses_another_grid(tmp_path):
    prob = tmc.CompletionProblem.from_dataset(
        lowrank_problem(M, N, R, density=0.3, seed=0), 4, 4, R,
        device="cpu")
    tmc.Trainer(TConfig(m=M, n=N, p=4, q=4, rank=R),
                callbacks=[tmc.Checkpoint(str(tmp_path))]).fit(
        prob, tmc.FullGD(num_rounds=2))
    other = tmc.CompletionProblem.from_dataset(
        lowrank_problem(M, N, R, density=0.3, seed=0), 2, 2, R,
        device="cpu")
    with pytest.raises(ValueError, match="the problem needs"):
        tmc.restore_session(tck.CheckpointManager(str(tmp_path)), other)
