"""The port's gossip data-parallel LM training against the JAX package's, on
the CPU.

JAX's ``make_gossip_dp_step`` runs on four forced host devices in a
subprocess (results through an ``.npz``); the port's runs on a 4x1 grid of
four ``gloo`` CPU processes (``launch.gossip.run_on_grid``), one replica a
rank, from the same JAX-initialised parameters and the same
``LMTokenPipeline`` batches.  Setting: smoke internlm2-20b, ``sgd``
(momentum 0.9) at lr 1e-2 without warm-up, 10 steps of 8 sequences (2 a
rank), at staleness 1 and 2 and compression ``none`` and ``int8``.

Held, per case: every rank's parameters against JAX's worker of the same
index, each leaf within a tolerance of max|JAX leaf| (below); every
step's loss (the mean over the ranks) within rel ``LOSS_RTOL``; the
``rank_consensus_error`` of the replicas equal to JAX's ``consensus_error``
of its stacked tree within rel ``CERR_RTOL``, and the port's
``consensus_error`` of the ranks' replicas stacked in this process equal
to the collective one.  Tolerances: float32 on both sides, sums in other
orders, ~1e-6 of a leaf's scale over 10 steps without compression.  An
int8 message is rounded to quanta of 1/127 of its max, and an ulp of
difference in a value on a rounding boundary moves that element of the
message by a quantum, which the mix weighs by α: the int8 cases hold
every element within ``INT8_QUANTA`` such shares (α / 127 of the leaf's
scale each; measured: 1.6 at staleness 1, 1.0 at staleness 2), their
losses and consensus errors within the same tolerances as the
uncompressed cases.  The gossip itself is checked to matter: the
replicas that mix every step agree more closely than those that mix
every other step.

Every subprocess and rank grid has a timeout of its own.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import TrainConfig, get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.data import LMTokenPipeline  # noqa: E402
from repro_torch.launch import gossip as tlaunch  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import (  # noqa: E402
    consensus_error,
    make_gossip_dp_step,
    rank_consensus_error,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPROCESS_TIMEOUT = 300
GRID_TIMEOUT = 180
ARCH = "internlm2-20b"
WORKERS, STEPS, BATCH, SEQ = 4, 10, 8, 16
TRAIN = dict(optimizer="sgd", learning_rate=1e-2, warmup_steps=0,
             total_steps=100, max_grad_norm=0.0)
CASES = {"s1_none": dict(staleness=1, compression="none"),
         "s2_none": dict(staleness=2, compression="none"),
         "s1_int8": dict(staleness=1, compression="int8"),
         "s2_int8": dict(staleness=2, compression="int8")}
TOL = 1e-5
ALPHA = 0.25
INT8_QUANTA = 2
LOSS_RTOL = 1e-5
CERR_RTOL = 1e-3


def run_jax(prog: str, devices: int) -> str:
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(prog)],
                         capture_output=True, text=True, env=env,
                         timeout=SUBPROCESS_TIMEOUT)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    return out.stdout


@pytest.fixture(scope="module")
def jax_dp(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_dp") / "jax.npz"
    prog = f"""
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import make_mesh
    from repro.config import get_smoke_config, TrainConfig
    from repro.data import LMTokenPipeline
    from repro.models import build_model
    from repro.models.api import Ctx
    from repro.optim import make_optimizer
    from repro.train.gossip_dp import (make_gossip_dp_step,
                                       replicate_for_workers,
                                       consensus_error)
    assert len(jax.devices()) == {WORKERS}
    cfg = get_smoke_config({ARCH!r})
    model = build_model(cfg, Ctx(attn_impl="ref", cache_dtype=jnp.float32))
    opt = make_optimizer(TrainConfig(**{TRAIN!r}))
    mesh = make_mesh(({WORKERS},), ("data",))
    params = model.init(jax.random.PRNGKey(0))
    pipe = LMTokenPipeline(cfg.vocab_size, {SEQ}, {BATCH})

    def flat(tree, prefix):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {{prefix + "/".join(k.key for k in path): np.asarray(leaf)
                for path, leaf in flat}}

    res = flat(params, "p0/")
    for name, kw in {CASES!r}.items():
        step = make_gossip_dp_step(lambda p, b: model.loss(p, b), opt, mesh,
                                   **kw)
        gp = replicate_for_workers(params, {WORKERS})
        go = replicate_for_workers(opt.init(params), {WORKERS})
        losses = []
        for i in range({STEPS}):
            tok, tgt = pipe.batch_at(i)
            gp, go, loss = step(gp, go, {{"tokens": tok, "targets": tgt}},
                                jnp.int32(i))
            losses.append(float(loss))
        res[name + "/loss"] = np.asarray(losses)
        res[name + "/cerr"] = np.asarray(float(consensus_error(gp)))
        res.update(flat(gp, name + "/p/"))
    np.savez({str(out)!r}, **res)
    """
    run_jax(prog, WORKERS)
    return dict(np.load(out))


def _nest(flat: dict, prefix: str) -> dict:
    """The nested dict of the "/"-joined keys under ``prefix``."""

    tree: dict = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        *path, last = key[len(prefix):].split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = val
    return tree


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _dp_rank(rank, device, p0, cases):
    """One worker: every case from the same parameters; returns per case
    the losses, the collective consensus error and its replica."""

    model = build_model(get_smoke_config(ARCH), Ctx(attn_impl="ref"),
                        device=device)
    optimizer = make_optimizer(TrainConfig(**TRAIN))
    pipe = LMTokenPipeline(model.cfg.vocab_size, SEQ, BATCH)
    out = {}
    for name, kw in cases.items():
        params = lm_params_from_numpy(p0, device)
        opt_state = optimizer.init(params)
        step = make_gossip_dp_step(model.loss, optimizer, **kw)
        losses = []
        for i in range(STEPS):
            tok, tgt = pipe.batch_at(i)
            params, opt_state, loss = step(
                params, opt_state, {"tokens": tok, "targets": tgt}, i)
            losses.append(float(loss))
        out[name] = {"loss": losses,
                     "cerr": float(rank_consensus_error(params)),
                     "p": tree_map(lambda a: a.numpy(), params)}
    return out


@pytest.fixture(scope="module")
def port_dp(jax_dp):
    p0 = _nest(jax_dp, "p0/")
    return tlaunch.run_on_grid(_dp_rank, (WORKERS, 1), p0, CASES,
                               device="cpu", timeout=GRID_TIMEOUT)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gossip_dp_matches_jax_per_rank(jax_dp, port_dp, case):
    int8 = CASES[case]["compression"] == "int8"
    for rank, out in enumerate(port_dp):
        got = _flat(out[case]["p"])
        want = {k[len(case) + 3:]: v[rank] for k, v in jax_dp.items()
                if k.startswith(case + "/p/")}
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            scale = float(np.abs(w).max())
            err = np.abs(got[key] - w)
            bound = INT8_QUANTA * ALPHA / 127 if int8 else TOL
            assert float(err.max()) <= bound * scale, (
                case, rank, key, float(err.max()), scale)
        np.testing.assert_allclose(out[case]["loss"], jax_dp[case + "/loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(out[case]["cerr"],
                                   float(jax_dp[case + "/cerr"]),
                                   rtol=CERR_RTOL)
    # the stacked measure in this process is the collective one (the mean
    # over ranks sums in gloo's order there, in torch.mean's here)
    stacked = tree_map(lambda *a: torch.from_numpy(np.stack(a)),
                       *(out[case]["p"] for out in port_dp))
    np.testing.assert_allclose(float(consensus_error(stacked)),
                               port_dp[0][case]["cerr"], rtol=1e-5)


def test_gossip_pulls_the_replicas_together(jax_dp, port_dp):
    """Staleness 1 mixes after every step; staleness 2 skips every other
    exchange, so its replicas drift further apart."""

    s1 = port_dp[0]["s1_none"]["cerr"]
    s2 = port_dp[0]["s2_none"]["cerr"]
    assert 0 < s1 < s2
    assert all(out["s1_none"]["cerr"] == s1 for out in port_dp)


def test_single_worker_step_is_the_plain_step():
    """Without a process group the step is one worker's SGD step and the
    mix leaves it unchanged."""

    model = build_model(get_smoke_config(ARCH), device="cpu")
    optimizer = make_optimizer(TrainConfig(**TRAIN))
    params = model.init(torch.Generator().manual_seed(0))
    ref = tree_map(torch.clone, params)
    step = make_gossip_dp_step(model.loss, optimizer)
    tok, tgt = LMTokenPipeline(model.cfg.vocab_size, SEQ, 2).batch_at(0)
    batch = {"tokens": tok, "targets": tgt}
    params, _, loss = step(params, optimizer.init(params), batch, 0)
    want = model.loss(ref, batch)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    assert all(not torch.equal(a, b) for a, b in
               zip(tree_leaves(params), tree_leaves(ref)) if a.dim() > 1)
