"""Tensor-parallel serving of MQA/GQA models whose KV heads do not divide
the ranks, against the JAX package, on the CPU: ranks of ``gloo``
processes (``launch/gossip.py::run_on_grid(..., device="cpu")``), at
smoke sizes.

Where the KV heads do not divide the model axis, JAX's rules cut the k/v
projections on their flat width (in parts of a head) where it divides
and put ``"model"`` on the KV cache's sequence where the length divides.
The port's rank gathers k and v whole, holds every KV head over its slice
of the positions, and decodes by a masked partial softmax.

Cases (a prompt of 28 tokens and 4 decode steps, which write positions
28-31 after any patch tokens; every sequence-cut case's cache depth puts
a boundary between two ranks' slices among them):

* granite-34b's smoke config (8 query heads, 1 KV head of 16) at tp = 2
  (cache 60 deep: slices of 30) and tp = 4 (40: slices of 10); at tp = 4
  with a depth of 34, which does not split 4 ways (the cache whole on
  every rank, k and v still gathered); with 6 query heads at tp = 3
  (depth 45: slices of 15), where the 16 k/v columns do not split 3 ways
  and the rules keep ``wk``/``wv`` whole (no gather of k and v, q
  gathered for the decode);
* internlm2-20b's smoke config with 6 query heads over its 2 KV heads at
  tp = 3 (depth 44, which does not split 3 ways: the cache whole): a
  rank's 2 query heads straddle the edge of a GQA group of 3 on rank 1,
  which reads a KV head for each query head (``_rank_kv``), in the
  prefill and in decode;
* internvl2-76b's smoke config unmodified (2 KV heads) at tp = 4, 8 stub
  patch tokens first (depth 52: slices of 13, the boundary at 39);
* gemma2-2b's smoke config (2 KV heads, a window of 16, attention and
  logit softcaps) at tp = 4 (depth 40): its first rank's whole slice lies
  before the window in every decode step, so the mask and the softcap
  cross the partial softmax;
* granite-moe-3b-a800m's smoke config (2 KV heads) at tp = 4 (depth 40)
  through the expert-parallel steps.

Held:

* **Steps.** The port's ``make_prefill_step`` and 4 ``make_serve_step``
  steps on each rank against JAX's, on a one-device CPU mesh with
  ``attn_impl="flashref"``, both with a float32 cache; the port is fed
  JAX's greedy tokens.  Every rank's logits within 1e-5 x max|JAX logit|
  (the repo's f32 pin), its greedy tokens JAX's.
* **Cache.** With a bfloat16 cache, each rank's cache shard equals the
  slice, by ``cspecs``, of the one-process port's cache at the bounds of
  ``tests/test_torch_tp_serve.py``: one unit in bfloat16's last place
  (floored at 1e-5 x the leaf's max|value|), and 2^-7 x max|value| at
  the positions the decode steps wrote.  A rank's slice holds zeros where
  no position was written, so a write at the wrong rank or offset shows.
* **Layout.** ``kv_cache_layout`` is ``"sequence"`` exactly where JAX's
  ``cache_pspecs_tree`` puts ``"model"`` on the KV cache's length, and
  the rank's cache has that many positions; the decode steps' positions
  lie in two ranks' slices.
* **The combine.** ``softmax_pv`` over n stacked slices, combined by the
  same code the ranks run, equals the whole-cache softmax (float32 and
  bfloat16 caches, a slice past ``pos``, a window).
* **Shards.** ``init_shard`` of granite-34b at tp = 2 and 4 is, rank by
  rank, the slice of ``init_shard`` at tp = 1, bit for bit.
* **Launcher.** ``launch.serve.main --arch granite-34b`` at ``--tp 1``,
  ``2`` and ``4`` prints the same greedy tokens.
"""

import dataclasses
import functools

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
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.optim.optimizers import tree_map_with_path  # noqa: E402
from repro_torch.train import sharding as S  # noqa: E402
from repro_torch.train.shard import (  # noqa: E402
    init_shard,
    kv_cache_layout,
    rank_cache_pspecs,
    shard_cache,
    shard_params,
)

torch.set_num_threads(2)

B, PROMPT, STEPS = 4, 28, 4
LOGIT_TOL = 1e-5      # x max|JAX logit|: the repo's f32 pin
CASES = {             # name -> (arch, tp, cache depth, config overrides)
    "granite-tp2": ("granite-34b", 2, 60, {}),
    "granite-tp4": ("granite-34b", 4, 40, {}),
    "granite-whole-cache-tp4": ("granite-34b", 4, 34, {}),
    "granite-h6-whole-kv-tp3": ("granite-34b", 3, 45, {"num_heads": 6}),
    "internlm2-h6-straddle-tp3": ("internlm2-20b", 3, 44, {"num_heads": 6}),
    "internvl2-tp4": ("internvl2-76b", 4, 52, {}),
    "gemma2-tp4": ("gemma2-2b", 4, 40, {}),
    "granite-moe-tp4": ("granite-moe-3b-a800m", 4, 40, {}),
}
# the layout each case's specs give, and whether its k/v are gathered
LAYOUT = {"granite-whole-cache-tp4": "whole",
          "internlm2-h6-straddle-tp3": "whole"}
WHOLE_KV = ("granite-h6-whole-kv-tp3", "internlm2-h6-straddle-tp3")


def _cfgs(name):
    arch, tp, max_len, over = CASES[name]
    return (dataclasses.replace(j_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over), tp,
            max_len)


def _patches(cfg):
    return cfg.num_patch_tokens if cfg.family == "vlm" else 0


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT))
             .astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_patch_tokens, 1024)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """JAX's prefill + STEPS greedy decode steps on a one-device mesh
    (float32 cache): (numpy params, batch, logits per step, tokens fed)."""

    jcfg, _, _, max_len = _cfgs(name)
    mcfg = JMesh(pod=1, data=1, model=1, fsdp=False)
    mesh = make_mesh_from_config(mcfg)
    model = j_build(jcfg, JCtx(attn_impl="flashref",
                               cache_dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0))
    P = _patches(jcfg)
    batch = _batch(jcfg)
    prefill, _ = JE.make_prefill_step(
        model, mesh, mcfg, JShape("p", PROMPT, B, "prefill"), max_len)
    decode, _ = JE.make_serve_step(
        model, mesh, mcfg, JShape("d", max_len - P, B, "decode"))
    logits, cache = prefill(params, batch)
    out, fed = [np.asarray(logits)], []
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        fed.append(np.asarray(tok))
        logits, cache = decode(params, cache, tok, P + PROMPT + i)
        out.append(np.asarray(logits))
    return jax.tree.map(np.asarray, params), batch, out, fed


def _np(cache):
    return tree_map_with_path(lambda _, x: x.float().numpy().copy(), cache)


def _serve(model, group, mesh_cfg, cfg, params_np, batch, fed, rank,
           max_len):
    """Prefill + decode steps fed ``fed`` on one rank: logits (numpy) of
    every step, the cache shard after the prefill and at the end, the
    rank's cspecs, its TP's KV cache layout and split leaves."""

    P = _patches(cfg)
    shape = ShapeConfig("p", PROMPT, B, "prefill")
    prefill, info = lm_engine.make_prefill_step(model, group, mesh_cfg,
                                                shape, max_len)
    decode, dinfo = lm_engine.make_serve_step(
        model, group, mesh_cfg, ShapeConfig("d", max_len - P, B, "decode"))
    full = lm_params_from_numpy(params_np, "cpu")
    params = shard_params(full, info["pspecs"], mesh_cfg, rank)
    logits, cache = prefill(params, batch)
    after_prefill = _np(cache)
    out = [logits.float().numpy()]
    for i, tok in enumerate(fed):
        logits, cache = decode(params, cache, tok, P + PROMPT + i)
        out.append(logits.float().numpy())
    tp = dinfo["model"].ctx.tp
    return {"logits": out, "prefill_cache": after_prefill,
            "cache": _np(cache), "cspecs": info["cspecs"],
            "layout": None if tp is None else (
                info["model"].ctx.tp.kv_cache, tp.kv_cache),
            "split": None if tp is None else sorted(tp.split)}


def _mqa_rank(rank, device, jobs):
    import torch.distributed as dist
    out = []
    for cfg, cache_dtype, params_np, batch, fed, tp, max_len in jobs:
        model = build_model(cfg, Ctx(attn_impl="kernel",
                                     cache_dtype=cache_dtype), device=device)
        mesh_cfg = MeshConfig(data=1, model=tp, fsdp=False)
        out.append(_serve(model, dist.group.WORLD, mesh_cfg, cfg, params_np,
                          batch, fed, rank, max_len))
    return out


@functools.lru_cache(maxsize=None)
def grid_run(tp):
    """Every case of ``tp`` ranks, both cache dtypes, in one grid:
    {(case, dtype): [rank results]}."""

    jobs, names = [], []
    for name in CASES:
        _, cfg, case_tp, max_len = _cfgs(name)
        if case_tp != tp:
            continue
        npp, batch, _, fed = jax_run(name)
        for dtype in (torch.float32, torch.bfloat16):
            jobs.append((cfg, dtype, npp, batch, fed, tp, max_len))
            names.append((name, str(dtype)[6:]))
    ranks = tlaunch.run_on_grid(_mqa_rank, (1, tp), jobs, device="cpu",
                                timeout=300)
    return {key: [r[i] for r in ranks] for i, key in enumerate(names)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_mqa_steps_match_jax(name):
    _, cfg, tp, _ = _cfgs(name)
    _, _, want, fed = jax_run(name)
    ranks = grid_run(tp)[(name, "float32")]
    assert len(ranks) == tp
    for r, res in enumerate(ranks):
        # the rules cut wk/wv in parts of a head, or keep them whole
        assert ("attn.wk" in res["split"]) == (name not in WHOLE_KV)
        assert "attn.wo" in res["split"]
        assert len(res["logits"]) == STEPS + 1
        for step, (got, ref) in enumerate(zip(res["logits"], want)):
            assert got.shape == (B, cfg.vocab_size)
            bound = LOGIT_TOL * float(np.abs(ref).max())
            err = float(np.abs(got - ref).max())
            assert err <= bound, (name, r, step, err, bound)
            want_tok = fed[step] if step < STEPS else ref.argmax(-1)
            np.testing.assert_array_equal(got.argmax(-1), want_tok)


def _ulp_bf16(x):
    """One unit in bfloat16's last place at each value of ``x``."""

    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _kv_leaves(tree):
    out = []
    tree_map_with_path(lambda p, x: out.append(x) if S.leaf_name(p) in
                       ("k", "v") else None, tree)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_mqa_cache_shards_are_slices_of_the_unsharded_cache(name):
    _, cfg, tp, max_len = _cfgs(name)
    npp, batch, _, fed = jax_run(name)
    mesh_cfg = MeshConfig(data=1, model=tp, fsdp=False)
    one = _serve(build_model(cfg, Ctx(attn_impl="kernel"), device="cpu"),
                 None, MeshConfig(data=1, model=1, fsdp=False), cfg, npp,
                 batch, fed, 0, max_len)
    ranks = grid_run(tp)[(name, "bfloat16")]
    P = _patches(cfg)
    layout = LAYOUT.get(name, "sequence")
    n = max_len // tp if layout == "sequence" else max_len
    for key in ("prefill_cache", "cache"):
        full = tree_map_with_path(lambda _, x: torch.from_numpy(x),
                                  one[key])
        for r, res in enumerate(ranks):
            assert res["layout"] == (layout, layout)
            want = shard_cache(full, res["cspecs"], mesh_cfg, r)
            got = []
            tree_map_with_path(lambda _, g, w: got.append((g, w.numpy())),
                               res[key], want)
            assert got
            for g, w in got:
                assert g.shape == w.shape
                scale = float(np.abs(w).max())
                tol = np.maximum(_ulp_bf16(w), LOGIT_TOL * scale)
                # positions the decode steps wrote: computed from the
                # bfloat16 cache, held at the repo's rule for such values
                lo = r * n if layout == "sequence" else 0
                wrote = max(P + PROMPT - lo, 0)
                tol[..., wrote:, :] = 2.0 ** -7 * scale
                assert np.all(np.abs(g - w) <= tol), (name, key, r)
            # every KV head, over the rank's positions
            for leaf in _kv_leaves(res[key]):
                assert leaf.shape[-3] == cfg.num_kv_heads
                assert leaf.shape[-2] == n


@pytest.mark.parametrize("name", sorted(n for n in CASES
                                         if LAYOUT.get(n) != "whole"))
def test_mqa_decode_crosses_a_slice_boundary(name):
    """The decode steps write positions of two ranks' slices, and after
    them each rank holds nonzero keys exactly at the positions written
    into its slice."""

    _, cfg, tp, max_len = _cfgs(name)
    P = _patches(cfg)
    n = max_len // tp
    written = range(P + PROMPT, P + PROMPT + STEPS)
    owners = {pos // n for pos in written}
    assert len(owners) == 2, (name, owners)
    ranks = grid_run(tp)[(name, "float32")]
    for r, res in enumerate(ranks):
        k = _kv_leaves(res["cache"])[0]         # (n_scan, B, Hkv, n, D)
        live = np.abs(k).reshape(-1, n, k.shape[-1]).max(axis=(0, 2)) > 0
        want = np.arange(r * n, (r + 1) * n) < P + PROMPT + STEPS
        np.testing.assert_array_equal(live, want)


def _layout_of_jax_specs(cache_shapes, cache_specs):
    """The layout JAX's cache specs give its KV leaves."""

    seen = set()
    leaves = jax.tree_util.tree_flatten_with_path(cache_shapes)[0]
    specs = jax.tree_util.tree_leaves(
        cache_specs,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for (path, _), spec in zip(leaves, specs):
        if jax.tree_util.keystr(path).endswith((".k", ".v")):
            on = [e == "model" or (isinstance(e, tuple) and "model" in e)
                  for e in tuple(spec)]
            seen.add("heads" if on[-3] else "sequence" if on[-2]
                     else "whole")
    assert len(seen) == 1
    return seen.pop()


@pytest.mark.parametrize("arch,tp,max_len,want", [
    ("granite-34b", 2, 60, "sequence"),
    ("granite-34b", 3, 45, "sequence"),
    ("granite-34b", 4, 40, "sequence"),
    ("granite-34b", 4, 34, "whole"),
    ("internlm2-20b", 3, 45, "sequence"),
    ("internvl2-76b", 2, 52, "heads"),
    ("internvl2-76b", 4, 52, "sequence"),
    ("gemma2-2b", 4, 39, "whole"),
])
def test_kv_cache_layout_is_where_jax_cuts_the_cache(arch, tp, max_len,
                                                     want):
    # 6 query heads split 3 ways; the smoke config's 8 do not
    over = {"num_heads": 6} if tp == 3 else {}
    jcfg = dataclasses.replace(j_smoke(arch), **over)
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    P = _patches(cfg)
    jm, tm = j_build(jcfg), build_model(cfg, device="meta")
    jc, tc = JA.cache_specs(jm, B, max_len), api.cache_specs(tm, B, max_len)
    jspecs = JS.cache_pspecs_tree(jcfg, JShape("d", max_len - P, B, "decode"),
                                  JMesh(data=1, model=tp, fsdp=False), jc)
    tspecs = rank_cache_pspecs(tc, S.cache_pspecs_tree(
        cfg, ShapeConfig("d", max_len - P, B, "decode"),
        MeshConfig(data=1, model=tp, fsdp=False), tc))
    assert _layout_of_jax_specs(jc, jspecs) == want
    assert kv_cache_layout(tc, tspecs) == want
    # the rank's model holds its cache as the specs cut it
    shapes = api.param_specs(tm)
    mesh_cfg = MeshConfig(data=1, model=tp, fsdp=False)
    from repro_torch.models.layers import TP
    from repro_torch.train.shard import model_split
    split = model_split(shapes, S.param_pspecs(cfg, shapes, mesh_cfg))
    rank_tp = TP(group=None, rank=0, size=tp, staged=False, split=split,
                 kv_cache=want)
    rank_model = build_model(cfg, Ctx(tp=rank_tp), device="cpu")
    lm_engine._check_cache(rank_model, tc, tspecs, mesh_cfg, B, max_len)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,pos,window", [(4, 13, 0), (4, 29, 8),
                                          (2, 31, 0), (8, 5, 4)])
def test_partial_softmax_combine_equals_the_whole_softmax(dtype, n, pos,
                                                          window):
    """One decode step's attention over a cache of 32 positions, whole
    and as n stacked slices combined by the ranks' own code (a reduce
    over the slices' dim), at 1e-6 x max|o| (float32 sums in another
    order); with a bfloat16 cache each p may round to the neighbouring
    bfloat16 where its float32 value sits at a rounding boundary, so
    2^-8 x sum p |v| is added."""

    g = torch.Generator().manual_seed(n * 100 + pos)
    Bq, H, hkv, D, Lmax = 2, 8, 2, 16, 32
    q = torch.randn((Bq, H, 1, D), generator=g)
    ck = torch.randn((Bq, hkv, Lmax, D), generator=g).to(dtype)
    cv = torch.randn((Bq, hkv, Lmax, D), generator=g).to(dtype)
    kw = dict(head_dim=D, window=window, attn_softcap=20.0)
    logits = A.decode_logits(q, ck, torch.arange(Lmax), pos, **kw)
    whole = A.softmax_pv(logits, cv)
    m = Lmax // n

    def slices(x):                             # (n, B, hkv, m, D)
        return torch.stack(x.split(m, dim=2))

    kpos = torch.arange(Lmax).reshape(n, 1, 1, 1, m)

    def reduce(x, op):
        return (x.amax if op == "max" else x.sum)(dim=0, keepdim=True)

    parts = A.softmax_pv(A.decode_logits(q, slices(ck), kpos, pos, **kw),
                         slices(cv), reduce)[0]
    assert parts.shape == whole.shape and torch.isfinite(parts).all()
    tol = 1e-6 * float(whole.abs().max())
    if dtype == torch.bfloat16:
        # each p may round to the neighbouring bfloat16: 2^-8 x p x |v|
        tol = tol + 2.0 ** -8 * (torch.softmax(logits, dim=-1)
                                 @ cv.float().abs())
    assert torch.all((parts - whole).abs() <= tol)


@pytest.mark.parametrize("tp", [2, 4])
def test_init_shard_of_granite_concatenates_to_one_rank(tp):
    cfg = get_smoke_config("granite-34b")
    one = MeshConfig(data=1, model=1, fsdp=False)
    mesh_cfg = MeshConfig(data=1, model=tp, fsdp=False)
    full = init_shard(7, cfg, None, one, 0, "cpu")
    shapes = api.param_specs(build_model(cfg, device="cpu"))
    specs = S.param_pspecs(cfg, shapes, mesh_cfg)
    # the k/v projections are cut in parts of the one head
    wk = specs["units"]["s0"]["attn"]["wk"]
    assert tuple(wk) == (None, None, "model")
    cut = 0
    for r in range(tp):
        got = init_shard(7, cfg, None, mesh_cfg, r, "cpu")
        assert got["units"]["s0"]["attn"]["wk"].shape[-1] == \
            cfg.resolved_head_dim // tp
        want = shard_params(full, specs, mesh_cfg, r)
        pairs = []
        tree_map_with_path(lambda p, g, w, s: pairs.append((p, g, w, s)),
                           got, want, specs)
        for path, g, w, spec in pairs:
            assert g.dtype == w.dtype and torch.equal(g, w), path
            cut += "model" in spec
    assert cut > 0


def test_launcher_serves_granite_on_2_and_4_ranks(monkeypatch, capsys):
    monkeypatch.setattr(serve, "get_model_config", get_smoke_config)
    argv = ["--arch", "granite-34b", "--batch", "2", "--seq-len", "16",
            "--steps", "3", "--device", "cpu"]
    runs = [serve.main(argv + ["--tp", str(tp)]) for tp in (1, 2, 4)]
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "greedy tokens" in ln]
    assert len(lines) == 3 and lines[0] == lines[1] == lines[2]
    for run, tp in zip(runs[1:], (2, 4)):
        assert len(run["ranks"]) == tp
        # every KV head over a 1/tp slice of the positions
        for res in run["ranks"]:
            assert res["cache_bytes"] * tp == run["one_process_cache_bytes"]
        assert "all_reduce_max" in run["ranks"][0]["collectives"]
    assert "(one process: " in out


def test_roofline_record_counts_the_partial_softmax():
    """``roofline_bench.lm_record`` of a granite-34b smoke decode step on 4
    ranks: the cache layout from the specs (a quarter of the positions a
    rank), and a layer's collectives counted on ``meta`` as the rank runs
    them: one all-gather of q with the k/v columns, an all-reduce of the
    maxima (B·H floats), of the sums, of the partial outputs and of the
    row-parallel ``wo`` and MLP products."""

    from repro_torch.launch import roofline_bench as RB

    cfg = get_smoke_config("granite-34b")
    n, max_len, layers = 4, 40, cfg.num_layers
    H, D, d = cfg.num_heads, cfg.resolved_head_dim, cfg.d_model
    one = RB.lm_record(cfg, "decode", B, PROMPT, max_len, 1)
    rec = RB.lm_record(cfg, "decode", B, PROMPT, max_len, n)
    assert rec["cache_bytes"] * n == one["cache_bytes"]
    coll = rec["collectives"]
    assert coll["all_reduce_max"] == {"calls": layers,
                                      "bytes": layers * B * H * 4}
    # q (H/n heads) and k, v (D/n columns each) of B tokens, then logits
    assert coll["all_gather"] == {
        "calls": layers + 1,
        "bytes": layers * B * (H * D // n + 2 * D // n) * 4
        + B * cfg.vocab_size // n * 4}
    # the embedding's, then per layer the sums, P·V, wo and the MLP
    assert coll["all_reduce"] == {
        "calls": 1 + 4 * layers,
        "bytes": B * d * 4 + layers * B * (H * 4 + H * D * 4 + 2 * d * 4)}
    ar = coll["all_reduce"]["bytes"] + coll["all_reduce_max"]["bytes"]
    ag = coll["all_gather"]["bytes"] * n
    assert rec["collective_bytes_per_device"] == (2.0 * ar + ag) * (n - 1) / n
