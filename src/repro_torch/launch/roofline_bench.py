"""Roofline lines from the port's records of one step, on the H100's peaks.

The port's twin of ``benchmarks/roofline_bench.py``: :func:`load_records`
reads JSONL records (the same fields as the JAX dry run's, plus
``chips``; the last record per (arch, shape, mesh) wins, later files
win), and :func:`main` prints one line per record::

    roofline_<arch>_<shape>_<mesh>,<dominant µs>,compute_s=…;memory_s=…;
        collective_s=…;bottleneck=…;frac=…;useful=…

The JAX records come from ``launch/dryrun.py``, which lowers to 256 or
512 placeholder TPU devices and has no twin.  The port writes its own
(``--write PATH``), each marked ``"counted": "computed"``: flops and bytes
counted from shapes, never measured.

* **The fit round** (:func:`gossip_records`): one FullGD round of the
  Table 3 cell (``movielens_proxy()``, 6040 × 3706, 5 × 5 blocks, r = 15,
  its ~800k training entries) on one card, and one ``Gossip`` round of a
  rank of the 2 × 2 grid on the 4 × 4 blocks (5 does not split over 2
  ranks; the ``[gossip]`` phase runs ML-1M at 4 × 4 on that grid).  The
  segment kernel's work, as PERF.md's bound column counts it: each real
  entry's index and value words read once, the factors in, both
  gradients and the loss out; 6r + 4 flops an entry.  The grid rank holds
  the busiest tile's entries, and its collective bytes are its share of
  ``core.gossip.halo_bytes_per_round`` (0 on one card).
* **The LM harness** (:func:`lm_records`): the ``[tp]`` cell, internvl2-76b
  at its published widths and 8 of 80 layers, a prefill of 4 × (256
  patches + 1792 tokens) and one decode step against a 2080-deep cache,
  at ``model`` = 1 and 4.  The rank's model runs on ``meta`` tensors
  under ``torch.utils.flop_counter.FlopCounterMode`` (the torch matmuls;
  nothing is allocated); the flash kernel, a ctypes launch the counter
  cannot see, records its geometry on ``meta`` and its work is counted
  as its bound is: 2·(D + Dv) flops per live (q, k) pair.  Bytes: the
  rank's parameters and cache shards (``param_specs``/``cache_specs``
  through the sharding rules).  Collective bytes: the rank's
  ``models.layers.TP`` collectives, counted by a group-less ``TP.dry``,
  with the JAX package's ring formulas (all-reduce 2·b·(n−1)/n,
  all-gather of a result b: b·(n−1)/n; all-to-all of b: b·(n−1)/n, the
  rank's own chunk staying).
* **The expert-parallel cell** (:func:`moe_records`): ``[ep]``'s
  granite-moe-3b-a800m and deepseek-v2-lite-16b at published widths and
  full depth on 4 EP ranks (experts padded to the axis, as the launcher
  pads them), a prefill of 4 × 4000 tokens in the psum form and in the
  a2a form (capacity 2.0), and a psum decode step against a 4096-deep
  cache (the a2a form cannot split one token).  Meta tensors hold no
  routing: the expert run lengths are counted as an even split of the
  slots (``models/moe.py``), and the a2a buffers are counted at their
  capacity, as the form sends them.
* **The sequence-sharded KV cell** (:func:`mqa_records`): ``[tp_mqa]``'s
  granite-34b at its published widths and 5 of 88 layers (one KV head:
  k and v gathered whole, the cache cut on its sequence over the ranks),
  a prefill of 4 × 1024 tokens and one decode step against a 1376-deep
  cache, at ``model`` = 1 and 4; the decode's masked partial softmax
  counts its all-gather of q, its all-reduces of the maxima
  (``all_reduce_max``) and of the sums and partial outputs.
* **The FSDP cell** (:func:`fsdp_records`): ``[fsdp]``'s qwen1.5-32b at
  its published widths and 6 of 64 layers, a prefill of 4 × 1024 tokens
  and one decode step against a 1032-deep cache, in one process and on
  rank 0 of ``data`` 2 × ``model`` 2 (FSDP on, a rank's batch of 2): the
  collectives add the FSDP gathers, one a unit (``FSDP.dry``), counted
  with the all-gather formula, and the logits' all-gather over the batch;
  the bytes add the gathered leaves, written once and read once.
* **The long-context cell** (:func:`long_records`): ``long_500k``'s one
  decode step (B = 1 at position 524,287 of a 524,288-deep bf16 cache) of
  zamba2-2.7b and mamba2-780m at their published widths and full depth,
  in one process and on rank 0 of ``data`` 2 × ``model`` 2 (FSDP on):
  the batch does not split, so it stays whole on every rank and no
  logits are gathered; zamba2's KV cache is cut on its heads over
  ``"model"`` and on its sequence over ``"data"``, and its masked partial
  softmax adds three all-reduces an invocation over the data group
  (``kv_seq_all_reduce_max``, ``kv_seq_all_reduce``).  ::

    python -m repro_torch.launch.roofline_bench [--write PATH] [--path GLOB]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob as _glob
import json
import os

import numpy as np

from repro_torch.roofline.analysis import analyze_record

DEFAULT_PATH = os.path.join("results", "roofline*.jsonl")

# the Table 3 cell and the grid cell of [gossip]
FIT_SHAPE = dict(m=6040, n=3706, r=15)
FIT_CELLS = (((5, 5), (1, 1)), ((4, 4), (2, 2)))
# the [tp] cell (chip_smoke.py's VLM_* and TP_RANKS)
LM_ARCH, LM_LAYERS = "internvl2-76b", 8
LM_BATCH, LM_PROMPT, LM_MAX_LEN = 4, 1792, 2080
LM_MODEL_AXES = (1, 4)
# the [ep] cell (chip_smoke.py's MOE_* and EP_RANKS)
MOE_ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")
MOE_BATCH, MOE_PROMPT, MOE_MAX_LEN, EP_RANKS = 4, 4000, 4096, 4
# the [tp_mqa] cell (chip_smoke.py's MQA_* and TP_RANKS)
MQA_ARCH, MQA_LAYERS = "granite-34b", 5
MQA_BATCH, MQA_PROMPT, MQA_MAX_LEN = 4, 1024, 1376
# the [fsdp] cell (chip_smoke.py's FSDP_*): one process, then 2 x 2 ranks
FSDP_ARCH, FSDP_LAYERS = "qwen1.5-32b", 6
FSDP_BATCH, FSDP_PROMPT, FSDP_MAX_LEN = 4, 1024, 1032
FSDP_MESHES = ((1, 1), (2, 2))
# the long_500k cell (launch/serve.py --shape long_500k --data 2 --tp 2)
LONG_ARCHS = ("zamba2-2.7b", "mamba2-780m")
LONG_BATCH, LONG_MAX_LEN = 1, 524288


def load_records(path=DEFAULT_PATH):
    records = []
    for p in sorted(_glob.glob(path)) or ([path] if os.path.exists(path)
                                         else []):
        with open(p) as f:
            for line in f:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
    # keep last record per cell key (reruns append; later files win)
    by_key = {}
    for r in records:
        by_key[(r["arch"], r["shape"], r["mesh"])] = r
    return list(by_key.values())


def roofline_line(a: dict) -> str:
    dom_s = max(a["compute_s"], a["memory_s"], a["collective_s"])
    return (f"roofline_{a['arch']}_{a['shape']}_{a['mesh']},{dom_s*1e6:.1f},"
            f"compute_s={a['compute_s']:.3e};memory_s={a['memory_s']:.3e};"
            f"collective_s={a['collective_s']:.3e};"
            f"bottleneck={a['bottleneck']};"
            f"frac={a['roofline_fraction']:.3f};"
            f"useful={a.get('useful_flops_ratio', 0):.3f}")


# ---------------------------------------------------------------------------
# the fit round
# ---------------------------------------------------------------------------


def block_nnz(train_mask: np.ndarray, p: int, q: int) -> np.ndarray:
    """(p, q) training entries a block, on the grid ``pad_to_grid`` pads
    the matrix to."""

    m, n = train_mask.shape
    mb, nb = -(-m // p), -(-n // q)
    padded = np.zeros((p * mb, q * nb), bool)
    padded[:m, :n] = train_mask
    return padded.reshape(p, mb, q, nb).sum(axis=(1, 3))


def segment_work(nnz: int, B: int, M: int, N: int, r: int):
    """(flops, bytes) of one ``sddmm_segment_grad`` call over ``B`` blocks
    of M × N holding ``nnz`` entries (chip_smoke.py's bound column)."""

    factor_bytes = 2 * 4 * B * (M + N) * r + 4 * B
    nbytes = nnz * 5 * 4 + 4 * B * (M + N + 2) + factor_bytes
    return nnz * (6 * r + 4), nbytes


def gossip_record(m: int, n: int, r: int, grid, ranks, counts) -> dict:
    """The record of one round on the busiest rank of ``ranks`` (R, C)
    over ``grid`` (p, q) blocks with ``counts`` (p, q) entries a block."""

    from repro_torch.core.gossip import halo_bytes_per_round
    from repro_torch.mesh import MeshPlan

    (p, q), (R, C) = grid, ranks
    mb, nb = -(-m // p), -(-n // q)
    bpr, bpc = p // R, q // C
    tiles = counts.reshape(R, bpr, C, bpc).sum(axis=(1, 3))
    nnz = int(tiles.max())
    flops, nbytes = segment_work(nnz, bpr * bpc, mb, nb, r)
    halo = halo_bytes_per_round(MeshPlan.build(p, q, grid=(R, C)), mb, nb, r)
    return {"arch": "gossip-mc", "shape": f"{m}x{n}_r{r}_grid{p}x{q}",
            "mesh": f"{R}x{C}", "chips": R * C,
            "flops_per_device": float(flops),
            "bytes_accessed_per_device": float(nbytes),
            "collective_bytes_per_device": halo["total_bytes"] / (R * C),
            "counted": "computed", "kernel": "sddmm_segment_grad",
            "step": "FullGD round" if R * C == 1 else "Gossip round",
            "nnz_per_device": nnz, "blocks_per_device": bpr * bpc,
            "block": [mb, nb]}


def gossip_records(train_mask=None) -> list[dict]:
    """The fit round's records at the Table 3 cell (module docstring);
    ``train_mask`` defaults to ``movielens_proxy()``'s."""

    if train_mask is None:
        from repro_torch.data import movielens_proxy

        train_mask = np.asarray(movielens_proxy().train_mask) > 0
    m, n, r = FIT_SHAPE["m"], FIT_SHAPE["n"], FIT_SHAPE["r"]
    return [gossip_record(m, n, r, grid, ranks,
                          block_nnz(train_mask, *grid))
            for grid, ranks in FIT_CELLS]


# ---------------------------------------------------------------------------
# the LM harness
# ---------------------------------------------------------------------------


def live_pairs(Lq: int, Lk: int, causal: bool, window: int = 0,
               q_offset: int = 0) -> int:
    """Unmasked (q, k) pairs of one head: query i sees keys up to
    i + q_offset when causal, no further back than ``window``."""

    i = np.arange(Lq, dtype=np.int64) + q_offset
    hi = np.minimum(Lk - 1, i) if causal else np.full_like(i, Lk - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_flops(calls) -> float:
    return float(sum(2 * (c["D"] + c["Dv"]) * c["B"] * c["Hq"]
                     * live_pairs(c["Lq"], c["Lk"], c["causal"], c["window"],
                                  c["q_offset"]) for c in calls))


def ring_bytes(stats: dict, size: int) -> float:
    """Wire bytes a rank receives for ``TP.dry``'s ``stats`` on a ring of
    ``size``: all-reduce (a sum or a max) 2·b·(n−1)/n; all-gather
    b·(n−1)/n of its result b, n times the input counted; all-to-all
    b·(n−1)/n."""

    if size == 1:
        return 0.0
    ar = (stats.get("all_reduce", [0, 0.0, 0])[2]
          + stats.get("all_reduce_max", [0, 0.0, 0])[2])
    ag = stats.get("all_gather", [0, 0.0, 0])[2] * size
    a2a = stats.get("all_to_all", [0, 0.0, 0])[2]
    return (2.0 * ar + ag + a2a) * (size - 1) / size


def _tree_bytes(tree) -> int:
    from repro_torch.optim.optimizers import tree_map_with_path

    total = []
    tree_map_with_path(lambda _, x: total.append(x.numel() * x.element_size()),
                       tree)
    return sum(total)


def lm_record(cfg, kind: str, batch: int, prompt: int, max_len: int,
              model_axis: int, arch: str | None = None,
              overrides: dict | None = None,
              moe_impl: str = "psum", data_axis: int = 1) -> dict:
    """The record of one ``kind`` step ("prefill" of ``prompt`` tokens, a
    VLM's patches before them, or one "decode" step at the position after
    them, against a ``max_len``-deep cache) on rank 0 of ``data_axis x
    model_axis`` ranks (FSDP on over the data ranks, the batch cut over
    them), counted on ``meta``; a MoE model's experts padded to the model
    axis and combined by ``moe_impl`` (an ``"a2a"`` record's shape ends in
    ``_a2a``).  Over data ranks the collectives add the FSDP gathers
    (``FSDP.dry``) and the logits' gather over the batch, and the bytes
    the gathered leaves, written by the gather and read by the products."""

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.config import MeshConfig
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.api import build_model, param_specs
    from repro_torch.models.layers import TP
    from repro_torch.models.transformer import Ctx
    from repro_torch.train import sharding as S
    from repro_torch.config import ShapeConfig
    from repro_torch.models.api import cache_specs
    from repro_torch.models.layers import FSDP
    from repro_torch.train.shard import (batch_splits, fsdp_split,
                                         kv_cache_layout, model_split,
                                         rank_cache_pspecs, shard_params)

    mesh_cfg = MeshConfig(data=data_axis, model=model_axis,
                          fsdp=data_axis > 1)
    ctx = Ctx(attn_impl="kernel", moe_impl=moe_impl,
              ep_pad_to=model_axis if cfg.moe is not None else 0)
    meta_model = build_model(cfg, ctx, device="meta")
    shapes = param_specs(meta_model)
    pspecs = S.param_pspecs(cfg, shapes, mesh_cfg)
    patches = cfg.num_patch_tokens if cfg.family == "vlm" else 0
    # the cache layout the decode step's specs give (lm_engine's)
    cshapes = cache_specs(meta_model, batch, max_len)
    cspecs = rank_cache_pspecs(cshapes, S.cache_pspecs_tree(
        cfg, ShapeConfig("decode", max_len - patches, batch, "decode"),
        mesh_cfg, cshapes))
    tp = (TP.dry(model_axis, model_split(shapes, pspecs),
                 kv_cache=kv_cache_layout(cshapes, cspecs))
          if model_axis > 1 else None)
    fsdp = (FSDP.dry(data_axis, fsdp_split(shapes, pspecs))
            if data_axis > 1 else None)
    # a batch that does not split stays whole, its KV positions cut over
    # the data ranks where the rules say so
    kv_seq = (TP.dry(data_axis) if data_axis > 1 and kv_cache_layout(
        cshapes, cspecs, "data") == "sequence" else None)
    model = build_model(cfg, dataclasses.replace(ctx, tp=tp, fsdp=fsdp,
                                                 kv_seq=kv_seq),
                        device="meta")
    params = shard_params(shapes, pspecs, mesh_cfg, 0)
    splits = batch_splits(mesh_cfg, batch)
    global_batch, batch = batch, batch // data_axis if splits else batch
    cache = model.init_cache(batch, max_len)
    positions = patches + prompt
    meta = dict(device="meta")
    flash_ops.flash_attention.meta_calls.clear()
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        if kind == "prefill":
            inputs = {"tokens": torch.zeros((batch, prompt), dtype=torch.int32,
                                            **meta)}
            if patches:
                inputs["patches"] = torch.zeros((batch, patches, 1024),
                                                **meta)
            _, cache = model.prefill(params, inputs, max_len)
        elif kind == "decode":
            token = torch.zeros((batch,), dtype=torch.int32, **meta)
            model.decode(params, cache, token, positions)
        else:
            raise ValueError(f"kind {kind!r}: 'prefill' or 'decode'")
    calls = list(flash_ops.flash_attention.meta_calls)
    flash_ops.flash_attention.meta_calls.clear()
    torch_flops = float(fc.get_total_flops())
    kernel_flops = flash_flops(calls)
    param_bytes, cache_bytes = _tree_bytes(params), _tree_bytes(cache)
    stats = dict(tp.stats) if tp is not None else {}
    wire = ring_bytes(stats, model_axis)
    gathered = 0
    if fsdp is not None:
        gathered = fsdp.stats.get("all_gather", [0, 0.0, 0])[2] * data_axis
        wire += ring_bytes(fsdp.stats, data_axis)
        stats.update({f"fsdp_{op}": row for op, row in fsdp.stats.items()})
    if data_axis > 1 and splits:
        # the logits' all-gather over the batch ranks: (B / data, V) f32
        batch_stats = {"all_gather": [1, 0.0, 4 * batch * cfg.vocab_size]}
        wire += ring_bytes(batch_stats, data_axis)
        stats.update({f"batch_{op}": row for op, row in batch_stats.items()})
    if kv_seq is not None:
        wire += ring_bytes(kv_seq.stats, data_axis)
        stats.update({f"kv_seq_{op}": row
                      for op, row in kv_seq.stats.items()})
    # model_flops counts prefill tokens; a decode step's seq_len is its
    # cache's depth in tokens
    seq = positions if kind == "prefill" else max_len - patches
    shape = (f"{kind}_{global_batch}x"
             f"{positions if kind == 'prefill' else max_len}")
    shape += "_a2a" if moe_impl == "a2a" else ""
    return {"arch": arch or cfg.name, "shape": shape,
            "mesh": f"{data_axis}x{model_axis}",
            "chips": data_axis * model_axis,
            "flops_per_device": torch_flops + kernel_flops,
            "bytes_accessed_per_device": float(param_bytes + cache_bytes
                                               + 2 * gathered),
            "collective_bytes_per_device": wire,
            "counted": "computed",
            "overrides": dict(overrides or {}),
            "shape_cfg": {"name": shape, "seq_len": seq,
                          "global_batch": global_batch, "kind": kind},
            "torch_flops": torch_flops, "flash_flops": kernel_flops,
            "flash_calls": len(calls), "param_bytes": param_bytes,
            "cache_bytes": cache_bytes, "fsdp_gathered_bytes": gathered,
            "collectives": {op: {"calls": c, "bytes": b}
                            for op, (c, _, b) in stats.items()}}


def lm_records() -> list[dict]:
    """The ``[tp]`` cell's records (module docstring)."""

    from repro_torch.config import get_model_config

    overrides = {"num_layers": LM_LAYERS}
    cfg = dataclasses.replace(get_model_config(LM_ARCH), **overrides)
    return [lm_record(cfg, kind, LM_BATCH, LM_PROMPT, LM_MAX_LEN, tp,
                      arch=LM_ARCH, overrides=overrides)
            for tp in LM_MODEL_AXES for kind in ("prefill", "decode")]


def moe_records() -> list[dict]:
    """The ``[ep]`` cell's records (module docstring)."""

    from repro_torch.config import get_model_config

    out = []
    for arch in MOE_ARCHS:
        cfg = get_model_config(arch)
        for kind, impl in (("prefill", "psum"), ("prefill", "a2a"),
                           ("decode", "psum")):
            out.append(lm_record(cfg, kind, MOE_BATCH, MOE_PROMPT,
                                 MOE_MAX_LEN, EP_RANKS, moe_impl=impl))
    return out


def mqa_records() -> list[dict]:
    """The ``[tp_mqa]`` cell's records (module docstring)."""

    from repro_torch.config import get_model_config

    overrides = {"num_layers": MQA_LAYERS}
    cfg = dataclasses.replace(get_model_config(MQA_ARCH), **overrides)
    return [lm_record(cfg, kind, MQA_BATCH, MQA_PROMPT, MQA_MAX_LEN, tp,
                      arch=MQA_ARCH, overrides=overrides)
            for tp in LM_MODEL_AXES for kind in ("prefill", "decode")]


def fsdp_records() -> list[dict]:
    """The ``[fsdp]`` cell's records (module docstring)."""

    from repro_torch.config import get_model_config

    overrides = {"num_layers": FSDP_LAYERS}
    cfg = dataclasses.replace(get_model_config(FSDP_ARCH), **overrides)
    return [lm_record(cfg, kind, FSDP_BATCH, FSDP_PROMPT, FSDP_MAX_LEN,
                      model, arch=FSDP_ARCH, overrides=overrides,
                      data_axis=data)
            for data, model in FSDP_MESHES for kind in ("prefill", "decode")]


def long_records() -> list[dict]:
    """The ``long_500k`` cell's decode records (module docstring)."""

    from repro_torch.config import get_model_config

    return [lm_record(get_model_config(arch), "decode", LONG_BATCH,
                      LONG_MAX_LEN - 1, LONG_MAX_LEN, model, data_axis=data)
            for arch in LONG_ARCHS for data, model in FSDP_MESHES]


def write_records(path: str) -> list[dict]:
    records = (gossip_records() + lm_records() + moe_records()
               + mqa_records() + fsdp_records() + long_records())
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return records


def main(argv=None, out=print) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", type=str, default=None,
                    help="count the port's records and append them to this "
                         "JSONL file before reading")
    ap.add_argument("--path", type=str, default=None,
                    help=f"records to read (a glob; default: --write's "
                         f"file, else {DEFAULT_PATH})")
    args = ap.parse_args(argv)
    if args.write:
        write_records(args.write)
    records = load_records(args.path or args.write or DEFAULT_PATH)
    if not records:
        out("roofline,0,no records found — run with --write PATH")
        return []
    analyses = [analyze_record(r) for r in records]
    for a in analyses:
        out(roofline_line(a))
    return analyses


if __name__ == "__main__":
    main()
