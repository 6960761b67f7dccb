"""Expert-parallel MoE and head-sharded MLA serving of the port against the
JAX package, on the CPU: ranks of ``gloo`` processes
(``launch/gossip.py::run_on_grid(..., device="cpu")``), at smoke sizes.

The JAX package's expert-parallel bodies run on one CPU device under
``jax.vmap(..., axis_name="model")``, fed per-rank stacked slices: the
psum form ``_moe_local(p, x, cfg, "model", ("model",))`` with whole
activations, the all-to-all form ``_moe_a2a(p, x, cfg, "model",
("model",), cf)`` with the sequence split over the ranks.

Held, with their tolerances:

* **The psum body** on 2 and 4 ranks (E = 8, k = 2, without and with a
  shared expert; E = 6 on 4 ranks, padded to 8): every rank's output
  within 1e-5 x max|y| of JAX's vmapped body and of both packages'
  single-program ``moe_ffn``; its aux the port's single-program aux
  exactly (the ranks route the same tokens) and JAX's at rtol 1e-5
  (``tests/test_torch_moe.py``'s pin across the packages).
* **The a2a body** on 2 and 4 ranks: at capacity 4.0 (no drops) within
  1e-5 x max|y| of JAX's vmapped body and of single-program; at a
  capacity that drops slots (a collapsed router, one expert's column 10
  and the others 0, as ``tests/test_torch_moe.py`` builds it: the slots
  crowd onto few experts), the port drops the slots JAX's bucket rule
  drops, and its
  output is JAX's within 1e-5 x max|y| on every token but one a rank.
  That token's slot sat in bucket (0, 0) of its rank, where the JAX body
  also writes every dropped slot and so loses it on the CPU (XLA applies
  duplicate scatter writes in order); the port keeps it, and its output
  there is JAX's plus exactly that slot's weighted expert output, within
  the same tolerance.  aux: JAX's at rtol 1e-5.  L = 1 raises
  ``ValueError``.
* **The steps**: ``make_prefill_step`` and three ``make_serve_step``
  steps of granite-moe-3b-a800m's and deepseek-v2-lite-16b's smoke
  configs at tp = 2 and 4 (granite-moe's with 4 KV heads at 4: its 2 do
  not split), against JAX's one-device steps (``attn_impl="flashref"``,
  a float32 cache on both sides): every rank's logits within 1e-5 x
  max|JAX logit| (the repo's f32 pin) and its greedy tokens JAX's.
  The a2a form through the model (``Ctx(moe_impl="a2a")``) at tp = 2: the
  prefill's logits JAX's within the same bound (no slot can drop: C =
  t·k), and the decode step raises ``ValueError``.
* **The shards**: ``init_shard`` of both configs at tp = 2 and 4 is, rank
  by rank, the slice of ``init_shard`` at tp = 1, bit for bit, and its
  draws follow ``init``'s distributions.
* **The launcher**: ``launch.serve.main`` at ``--tp 1`` and ``--tp 2``
  prints the same greedy tokens for granite-moe.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import MeshConfig as JMesh  # noqa: E402
from repro.config import MoEConfig as JMoEConfig  # noqa: E402
from repro.config import ShapeConfig as JShape  # noqa: E402
from repro.config import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import lm_engine as JE  # noqa: E402
from repro.launch.mesh import make_mesh_from_config  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models.api import Ctx as JCtx  # noqa: E402
from repro_torch.config import MeshConfig, MoEConfig, ShapeConfig  # noqa: E402
from repro_torch.config import get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import gossip as tlaunch  # noqa: E402
from repro_torch.launch import lm_engine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.layers import TP  # noqa: E402
from repro_torch.optim.optimizers import tree_map_with_path  # noqa: E402
from repro_torch.train import sharding as S  # noqa: E402
from repro_torch.train.shard import init_shard, shard_params  # noqa: E402

torch.set_num_threads(2)

Y_TOL = 1e-5          # x max|y|: the repo's f32 pin
AUX_RTOL = 1e-5       # across the packages (tests/test_torch_moe.py)
LOGIT_TOL = 1e-5      # x max|JAX logit|
D, TOKENS = 32, (2, 16)
B, PROMPT, STEPS = 4, 20, 3
EXPERTS = ("wi_gate", "wi_up", "wo")
# body cases: name -> (E, k, pad_to, shared experts, ranks)
BODIES = {"e8-tp2": (8, 2, 0, 0, 2), "e8-shared-tp2": (8, 2, 0, 1, 2),
          "e8-tp4": (8, 2, 0, 0, 4), "e8-shared-tp4": (8, 2, 0, 1, 4),
          "e6-padded-tp4": (6, 2, 4, 0, 4)}
# a2a cases: name -> (E, k, shared, ranks, capacity factor, collapsed)
A2A = {"nodrop-tp2": (8, 2, 0, 2, 4.0, False),
       "nodrop-shared-tp4": (8, 2, 1, 4, 4.0, False),
       "drops-tp2": (8, 2, 0, 2, 0.5, True),
       "drops-tp4": (8, 2, 0, 4, 0.5, True)}
# step cases: name -> (arch, tp, config overrides)
STEP_CASES = {"granite-moe-tp2": ("granite-moe-3b-a800m", 2, {}),
              "granite-moe-kv4-tp4": ("granite-moe-3b-a800m", 4,
                                      {"num_kv_heads": 4}),
              "deepseek-tp2": ("deepseek-v2-lite-16b", 2, {}),
              "deepseek-tp4": ("deepseek-v2-lite-16b", 4, {})}


# ---------------------------------------------------------------------------
# the bodies: inputs, the rank's slices, JAX's vmapped bodies
# ---------------------------------------------------------------------------


def _moe_setup(E, k, pad_to, shared, collapsed=False, seed=1):
    jcfg = JMoEConfig(num_experts=E, num_experts_per_tok=k, expert_d_ff=16,
                      num_shared_experts=shared)
    tcfg = MoEConfig(num_experts=E, num_experts_per_tok=k, expert_d_ff=16,
                     num_shared_experts=shared)
    jp = jax.tree.map(np.asarray, JMOE.init_moe(
        jax.random.PRNGKey(0), D, jcfg, jnp.float32, pad_to))
    if collapsed:
        router = np.zeros_like(jp["router"])
        router[:, 0] = 10.0
        jp["router"] = router
    x = np.random.default_rng(seed).normal(
        size=TOKENS + (D,)).astype(np.float32)
    return jcfg, tcfg, jp, x


def _rank_slice(jp, n, r):
    """Rank r's leaves of n: its experts, the shared experts' width (as the
    rules split them), the router whole."""

    El = jp["wi_gate"].shape[0] // n
    p = {"router": jp["router"]}
    p.update({w: jp[w][r * El:(r + 1) * El] for w in EXPERTS})
    if "shared" in jp:
        sh = jp["shared"]
        f = sh["wi_gate"].shape[1] // n
        p["shared"] = {"wi_gate": sh["wi_gate"][:, r * f:(r + 1) * f],
                       "wi_up": sh["wi_up"][:, r * f:(r + 1) * f],
                       "wo": sh["wo"][r * f:(r + 1) * f]}
    return p


def _split(jp):
    names = {f"moe.{w}" for w in EXPERTS}
    if "shared" in jp:
        names |= {f"shared.{w}" for w in EXPERTS}
    return frozenset(names)


def _jax_stacked(jp, n):
    """JAX's per-rank inputs to the shard_map body: the experts sliced, the
    router and the shared experts whole (their spec is P())."""

    El = jp["wi_gate"].shape[0] // n
    p = {w: jp[w].reshape((n, El) + jp[w].shape[1:]) for w in EXPERTS}
    p["router"] = np.stack([jp["router"]] * n)
    if "shared" in jp:
        p["shared"] = {w: np.stack([v] * n) for w, v in jp["shared"].items()}
    return p


def jax_psum(jcfg, jp, x, n):
    body = jax.vmap(lambda p, xx: JMOE._moe_local(p, xx, jcfg, "model",
                                                  ("model",)),
                    axis_name="model")
    y, aux = body(_jax_stacked(jp, n), np.stack([x] * n))
    return np.asarray(y), np.asarray(aux)


def _seq_parts(x, n):
    Bx, Lx, d = x.shape
    return x.reshape(Bx, n, Lx // n, d).transpose(1, 0, 2, 3)


def jax_a2a(jcfg, jp, x, n, cf):
    """JAX's a2a body on the sequence split over n ranks: (y whole, aux)."""

    body = jax.vmap(lambda p, xx: JMOE._moe_a2a(p, xx, jcfg, "model",
                                                ("model",), cf),
                    axis_name="model")
    y, aux = body(_jax_stacked(jp, n), _seq_parts(x, n))
    Bx, Lx, d = x.shape
    return (np.asarray(y).transpose(1, 0, 2, 3).reshape(Bx, Lx, d),
            np.asarray(aux))


def _dropped_by_jax_rule(top_idx, El, C):
    """JAX's bucket rule on the host: slots stably sorted by owner rank,
    each bucket's first C kept.  (dropped mask in slot order, the slot at
    bucket (0, 0) or None)."""

    dst = np.asarray(top_idx).reshape(-1) // El
    order = np.argsort(dst, kind="stable")
    seen, dropped = {}, np.zeros(dst.size, bool)
    for s in order:
        dropped[s] = seen.get(dst[s], 0) >= C
        seen[dst[s]] = seen.get(dst[s], 0) + 1
    first = order[0] if dst[order[0]] == 0 else None
    return dropped, first


# ---------------------------------------------------------------------------
# the rank functions (module level: the grid's processes import them)
# ---------------------------------------------------------------------------


def _psum_job(rank, device, tp_size, tcfg, jp, x):
    import torch.distributed as dist
    tp = TP.of(dist.group.WORLD, device, _split(jp))
    p = lm_params_from_numpy(_rank_slice(jp, tp_size, rank), device)
    y, aux = TMOE.moe_ffn(p, torch.from_numpy(x), tcfg, tp=tp)
    return {"y": y.numpy(), "aux": float(aux)}


def _a2a_job(rank, device, tp_size, tcfg, jp, x, cf):
    import torch.distributed as dist
    tp = TP.of(dist.group.WORLD, device, _split(jp))
    p = lm_params_from_numpy(_rank_slice(jp, tp_size, rank), device)
    tx = torch.from_numpy(x)
    y, aux = TMOE.moe_ffn(p, tx, tcfg, tp=tp, impl="a2a",
                          capacity_factor=cf)
    # the rank's own buckets: its part of the sequence, routed
    Lr = x.shape[1] // tp_size
    xt = tx[:, rank * Lr:(rank + 1) * Lr].reshape(-1, x.shape[-1])
    top_idx, _, _ = TMOE.route(p, xt, tcfg)
    n_local = p["wi_gate"].shape[0]
    C = TMOE.a2a_capacity(xt.shape[0], tcfg.num_experts_per_tok, tp_size,
                          cf)
    order, place = TMOE.a2a_buckets(top_idx, n_local, tp_size, C)
    dropped = np.zeros(place.numel(), bool)
    dropped[order.numpy()] = (place == tp_size * C).numpy()
    try:
        TMOE.moe_ffn(p, tx[:, :1], tcfg, tp=tp, impl="a2a")
        raised = None
    except ValueError as err:
        raised = str(err)
    return {"y": y.numpy(), "aux": float(aux), "dropped": dropped,
            "C": C, "top_idx": top_idx.numpy(), "l1": raised}


def _steps_job(rank, device, tp_size, cfg, params_np, batch, fed):
    import torch.distributed as dist
    model = build_model(cfg, Ctx(attn_impl="kernel",
                                 cache_dtype=torch.float32), device=device)
    mesh_cfg = MeshConfig(data=1, model=tp_size, fsdp=False)
    max_len = PROMPT + STEPS
    prefill, info = lm_engine.make_prefill_step(
        model, dist.group.WORLD, mesh_cfg,
        ShapeConfig("p", PROMPT, B, "prefill"), max_len)
    decode, _ = lm_engine.make_serve_step(
        model, dist.group.WORLD, mesh_cfg,
        ShapeConfig("d", max_len, B, "decode"))
    params = shard_params(lm_params_from_numpy(params_np, device),
                          info["pspecs"], mesh_cfg, rank)
    logits, cache = prefill(params, batch)
    out = [logits.numpy()]
    for i, tok in enumerate(fed):
        logits, cache = decode(params, cache, tok, PROMPT + i)
        out.append(logits.numpy())
    c_kv = [c for c in _flat(cache) if hasattr(c, "c_kv")]
    return {"logits": out, "split": sorted(info["model"].ctx.tp.split),
            "latent_shapes": [tuple(c.c_kv.shape) for c in c_kv]}


def _a2a_prefill_job(rank, device, tp_size, cfg, params_np, batch):
    """The a2a form through the model: a prefill's logits, and the decode
    step's refusal (one token does not split over the ranks)."""

    import torch.distributed as dist
    model = build_model(cfg, Ctx(attn_impl="kernel", moe_impl="a2a",
                                 cache_dtype=torch.float32), device=device)
    mesh_cfg = MeshConfig(data=1, model=tp_size, fsdp=False)
    prefill, info = lm_engine.make_prefill_step(
        model, dist.group.WORLD, mesh_cfg,
        ShapeConfig("p", PROMPT, B, "prefill"), PROMPT + 1)
    params = shard_params(lm_params_from_numpy(params_np, device),
                          info["pspecs"], mesh_cfg, rank)
    logits, cache = prefill(params, batch)
    try:
        with torch.inference_mode():
            info["model"].decode(params, cache, logits.argmax(-1), PROMPT)
        raised = None
    except ValueError as err:
        raised = str(err)
    return {"logits": logits.numpy(), "decode": raised}


def _flat(cache):
    for sub in cache.values():
        if isinstance(sub, dict):
            yield from _flat(sub)
        else:
            yield sub


def _ep_rank(rank, device, jobs):
    fns = {"psum": _psum_job, "a2a": _a2a_job, "steps": _steps_job,
           "a2a_prefill": _a2a_prefill_job}
    return [fns[kind](rank, device, *args) for kind, args in jobs]


# ---------------------------------------------------------------------------
# JAX's one-device steps and the grids
# ---------------------------------------------------------------------------


def _step_cfgs(name):
    arch, tp, over = STEP_CASES[name]
    return (dataclasses.replace(j_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over), tp)


@functools.lru_cache(maxsize=None)
def jax_steps(name):
    """JAX's prefill + STEPS greedy decode steps on a one-device mesh
    (float32 cache): (numpy params, batch, logits per step, tokens fed)."""

    jcfg, _, _ = _step_cfgs(name)
    mcfg = JMesh(pod=1, data=1, model=1, fsdp=False)
    mesh = make_mesh_from_config(mcfg)
    model = j_build(jcfg, JCtx(attn_impl="flashref",
                               cache_dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0))
    max_len = PROMPT + STEPS
    batch = {"tokens": np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)}
    prefill, _ = JE.make_prefill_step(
        model, mesh, mcfg, JShape("p", PROMPT, B, "prefill"), max_len)
    decode, _ = JE.make_serve_step(model, mesh, mcfg,
                                   JShape("d", max_len, B, "decode"))
    logits, cache = prefill(params, batch)
    out, fed = [np.asarray(logits)], []
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        fed.append(np.asarray(tok))
        logits, cache = decode(params, cache, tok, PROMPT + i)
        out.append(np.asarray(logits))
    return jax.tree.map(np.asarray, params), batch, out, fed


@functools.lru_cache(maxsize=None)
def grid_run(tp):
    """Every case of ``tp`` ranks in one grid: {(kind, name): [rank
    results]}."""

    jobs, keys = [], []
    for name, (E, k, pad_to, shared, n) in BODIES.items():
        if n == tp:
            _, tcfg, jp, x = _moe_setup(E, k, pad_to, shared)
            jobs.append(("psum", (tp, tcfg, jp, x)))
            keys.append(("psum", name))
    for name, (E, k, shared, n, cf, collapsed) in A2A.items():
        if n == tp:
            _, tcfg, jp, x = _moe_setup(E, k, 0, shared, collapsed)
            jobs.append(("a2a", (tp, tcfg, jp, x, cf)))
            keys.append(("a2a", name))
    for name in STEP_CASES:
        _, cfg, n = _step_cfgs(name)
        if n == tp:
            npp, batch, _, fed = jax_steps(name)
            jobs.append(("steps", (tp, cfg, npp, batch, fed)))
            keys.append(("steps", name))
            if tp == 2:
                jobs.append(("a2a_prefill", (tp, cfg, npp, batch)))
                keys.append(("a2a_prefill", name))
    ranks = tlaunch.run_on_grid(_ep_rank, (1, tp), jobs, device="cpu",
                                timeout=300)
    return {key: [r[i] for r in ranks] for i, key in enumerate(keys)}


def _close(got, want, scale=None):
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= Y_TOL * scale, (err, Y_TOL * scale)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(BODIES))
def test_psum_body_matches_jax_expert_parallel_body(name):
    E, k, pad_to, shared, n = BODIES[name]
    jcfg, tcfg, jp, x = _moe_setup(E, k, pad_to, shared)
    jy, jaux = jax_psum(jcfg, jp, x, n)
    sy, saux = JMOE.moe_ffn(jp, jnp.asarray(x), jcfg)
    ty, taux = TMOE.moe_ffn(lm_params_from_numpy(jp, "cpu"),
                            torch.from_numpy(x), tcfg)
    # the packages route alike here: the bodies are compared slot for slot
    j_idx, _, _ = JMOE.route(jp, jnp.asarray(x.reshape(-1, D)), jcfg)
    t_idx, _, _ = TMOE.route(lm_params_from_numpy(jp, "cpu"),
                             torch.from_numpy(x.reshape(-1, D)), tcfg)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    ranks = grid_run(n)[("psum", name)]
    assert len(ranks) == n
    for r, res in enumerate(ranks):
        assert res["y"].shape == x.shape
        _close(res["y"], jy[r])
        _close(res["y"], np.asarray(sy))
        _close(res["y"], ty.numpy())
        assert res["aux"] == float(taux)
        np.testing.assert_allclose(res["aux"], float(jaux[r]),
                                   rtol=AUX_RTOL)
        np.testing.assert_allclose(res["aux"], float(saux), rtol=AUX_RTOL)
    if pad_to and E % pad_to:
        assert jp["wi_gate"].shape[0] == 8 and int(t_idx.max()) < E


@pytest.mark.parametrize("name", sorted(A2A))
def test_a2a_body_matches_jax_expert_parallel_body(name):
    E, k, shared, n, cf, collapsed = A2A[name]
    jcfg, tcfg, jp, x = _moe_setup(E, k, 0, shared, collapsed)
    jy, jaux = jax_a2a(jcfg, jp, x, n, cf)
    ranks = grid_run(n)[("a2a", name)]
    scale = float(np.abs(jy).max())
    El = E // n
    Lr = x.shape[1] // n
    want = jy.reshape(-1, D).copy()
    drops = 0
    for r, res in enumerate(ranks):
        assert res["y"].shape == x.shape
        np.testing.assert_allclose(res["aux"], float(jaux[r]),
                                   rtol=AUX_RTOL)
        assert res["l1"] is not None and "does not split" in res["l1"]
        # the port's buckets are JAX's rule on the rank's routing, which
        # is JAX's routing
        xt = _seq_parts(x, n)[r].reshape(-1, D)
        j_idx, j_w, _ = JMOE.route(jp, jnp.asarray(xt), jcfg)
        np.testing.assert_array_equal(res["top_idx"], np.asarray(j_idx))
        want_drop, first = _dropped_by_jax_rule(j_idx, El, res["C"])
        np.testing.assert_array_equal(res["dropped"], want_drop)
        drops += int(want_drop.sum())
        if want_drop.any() and first is not None:
            # the slot JAX loses on this rank: the port's output there is
            # JAX's plus that slot's weighted expert output
            tok = first // k
            e = int(np.asarray(j_idx).reshape(-1)[first])
            ye = JMOE._expert_compute(
                jp["wi_gate"][e:e + 1], jp["wi_up"][e:e + 1],
                jp["wo"][e:e + 1], jnp.asarray(xt[tok:tok + 1]),
                jnp.array([1], jnp.int32))
            row = (tok // Lr) * x.shape[1] + r * Lr + tok % Lr
            want[row] += float(np.asarray(j_w).reshape(-1)[first]) * \
                np.asarray(ye)[0]
    # every rank holds the whole output
    for res in ranks:
        _close(res["y"].reshape(-1, D), want, scale)
    if collapsed:
        assert drops > 0
    else:
        assert drops == 0
        sy, _ = JMOE.moe_ffn(jp, jnp.asarray(x), jcfg)
        for res in ranks:
            _close(res["y"], np.asarray(sy))


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_ep_steps_match_jax(name):
    _, cfg, tp = _step_cfgs(name)
    _, _, want, fed = jax_steps(name)
    ranks = grid_run(tp)[("steps", name)]
    assert len(ranks) == tp
    for r, res in enumerate(ranks):
        assert {f"moe.{w}" for w in EXPERTS} <= set(res["split"])
        assert "attn.wo" in res["split"]
        if cfg.mla is not None:
            # the latent cache is whole on every rank
            assert res["latent_shapes"]
            for shape in res["latent_shapes"]:
                assert shape[-1] == cfg.mla.kv_lora_rank
                assert shape[-3] == B
        assert len(res["logits"]) == STEPS + 1
        for step, (got, ref) in enumerate(zip(res["logits"], want)):
            assert got.shape == (B, cfg.vocab_size)
            bound = LOGIT_TOL * float(np.abs(ref).max())
            err = float(np.abs(got - ref).max())
            assert err <= bound, (name, r, step, err, bound)
            want_tok = fed[step] if step < STEPS else ref.argmax(-1)
            np.testing.assert_array_equal(got.argmax(-1), want_tok)


@pytest.mark.parametrize("name", sorted(n for n in STEP_CASES
                                         if STEP_CASES[n][1] == 2))
def test_a2a_form_prefill_matches_jax(name):
    """``Ctx(moe_impl="a2a")`` through the model at tp = 2: each rank
    routes its 40 of the prompts' 80 positions, C = 80 holds every slot
    (no drop), and the logits are JAX's one-device prefill's; decode's
    one token raises."""

    _, cfg, tp = _step_cfgs(name)
    _, _, want, _ = jax_steps(name)
    ranks = grid_run(tp)[("a2a_prefill", name)]
    for res in ranks:
        assert res["logits"].shape == (B, cfg.vocab_size)
        bound = LOGIT_TOL * float(np.abs(want[0]).max())
        assert float(np.abs(res["logits"] - want[0]).max()) <= bound
        np.testing.assert_array_equal(res["logits"].argmax(-1),
                                      want[0].argmax(-1))
        assert "does not split" in res["decode"]


@pytest.mark.parametrize("arch,tp", [("granite-moe-3b-a800m", 2),
                                     ("granite-moe-3b-a800m", 4),
                                     ("deepseek-v2-lite-16b", 2),
                                     ("deepseek-v2-lite-16b", 4)])
def test_init_shard_of_moe_concatenates_to_one_rank(arch, tp):
    cfg = get_smoke_config(arch)
    ctx = Ctx(ep_pad_to=tp)
    one = MeshConfig(data=1, model=1, fsdp=False)
    mesh_cfg = MeshConfig(data=1, model=tp, fsdp=False)
    full = init_shard(7, cfg, ctx, one, 0, "cpu")
    shapes = api.param_specs(build_model(cfg, ctx, device="cpu"))
    specs = S.param_pspecs(cfg, shapes, mesh_cfg)
    experts = 0
    for r in range(tp):
        got = init_shard(7, cfg, ctx, mesh_cfg, r, "cpu")
        want = shard_params(full, specs, mesh_cfg, r)
        pairs = []
        tree_map_with_path(lambda p, g, w, s: pairs.append((p, g, w, s)),
                           got, want, specs)
        for path, g, w, spec in pairs:
            assert g.dtype == w.dtype and torch.equal(g, w), path
            experts += "'moe'" in path and spec[-3] == "model"
    assert experts == 3 * tp
    assert full["units"]["s0"]["moe"]["router"].dtype == torch.float32


def test_init_shard_of_moe_follows_init_distributions():
    for arch in ("granite-moe-3b-a800m", "deepseek-v2-lite-16b"):
        cfg = get_smoke_config(arch)
        ref = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        got = init_shard(0, cfg, None, MeshConfig(data=1, model=1,
                                                   fsdp=False), 0, "cpu")
        pairs = []
        tree_map_with_path(lambda p, g, w: pairs.append((p, g, w)), got, ref)
        assert len(pairs) > 10
        for path, g, w in pairs:
            assert g.shape == w.shape and g.dtype == w.dtype, path
            if not w.any():
                assert not g.any(), path
                continue
            ratio = float(g.std()) / float(w.std())
            assert 0.85 < ratio < 1.15, (arch, path, ratio)
            assert abs(float(g.mean())) < 0.1 * float(w.std()), path


def test_padded_experts_shard_by_expert_and_unpadded_ones_are_refused():
    """E = 6 on 4 ranks: padded to 8, the rules split the experts by
    expert (2 a rank); unpadded, they fall to the TP-within-expert branch,
    which ``model_split`` refuses naming ``ep_pad_to``."""

    from repro_torch.train.shard import model_split

    cfg = get_smoke_config("granite-moe-3b-a800m")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           num_experts=6))
    mesh_cfg = MeshConfig(data=1, model=4, fsdp=False)
    padded = api.param_specs(build_model(cfg, Ctx(ep_pad_to=4),
                                         device="meta"))
    assert padded["units"]["s0"]["moe"]["wi_gate"].shape[1] == 8
    split = model_split(padded, S.param_pspecs(cfg, padded, mesh_cfg))
    assert {"moe.wi_gate", "moe.wi_up", "moe.wo"} <= split
    plain = api.param_specs(build_model(cfg, device="meta"))
    with pytest.raises(NotImplementedError, match="ep_pad_to"):
        model_split(plain, S.param_pspecs(cfg, plain, mesh_cfg))
    # the steps pad it themselves, as the JAX launcher does
    model = build_model(dataclasses.replace(cfg, num_kv_heads=4),
                        Ctx(attn_impl="kernel"), device="cpu")
    _, info = lm_engine.make_serve_step(
        model, None, MeshConfig(data=1, model=1, fsdp=False),
        ShapeConfig("d", 8, 2, "decode"))
    assert info["model"].ctx.ep_pad_to == 0
    assert lm_engine.with_ep(model, mesh_cfg).ctx.ep_pad_to == 4


def test_launcher_tp2_prints_the_tp1_tokens_for_moe(monkeypatch, capsys):
    monkeypatch.setattr(serve, "get_model_config", get_smoke_config)
    argv = ["--arch", "granite-moe-3b-a800m", "--batch", "2", "--seq-len",
            "16", "--steps", "3", "--device", "cpu"]
    one = serve.main(argv + ["--tp", "1"])
    two = serve.main(argv + ["--tp", "2"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "greedy tokens" in ln]
    assert len(lines) == 2 and lines[0] == lines[1]
    assert one["ranks"][0]["tokens"] == two["ranks"][1]["tokens"]
    assert len(two["ranks"]) == 2 and two["backend"] == "gloo"
    # rank 0's collectives: the psum form's all-reduce a MoE layer, the
    # attention's, the embedding's; the logits' all-gather
    stats = two["ranks"][0]["collectives"]
    cfg = get_smoke_config("granite-moe-3b-a800m")
    assert stats["all_reduce"][0] == 3 * (2 * cfg.num_layers + 1)
    assert stats["all_gather"][0] == 3 and "all_to_all" not in stats
    assert "rank 0 all_reduce" in out and "ms a step" in out
