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
  all-gather of a result b: b·(n−1)/n).  ::

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
    ``size``: all-reduce 2·b·(n−1)/n; all-gather b·(n−1)/n of its result
    b, n times the input counted."""

    if size == 1:
        return 0.0
    ar = stats.get("all_reduce", [0, 0.0, 0])[2]
    ag = stats.get("all_gather", [0, 0.0, 0])[2] * size
    return 2.0 * ar * (size - 1) / size + ag * (size - 1) / size


def _tree_bytes(tree) -> int:
    from repro_torch.optim.optimizers import tree_map_with_path

    total = []
    tree_map_with_path(lambda _, x: total.append(x.numel() * x.element_size()),
                       tree)
    return sum(total)


def lm_record(cfg, kind: str, batch: int, prompt: int, max_len: int,
              model_axis: int, arch: str | None = None,
              overrides: dict | None = None) -> dict:
    """The record of one ``kind`` step ("prefill" of ``prompt`` tokens, a
    VLM's patches before them, or one "decode" step at the position after
    them, against a ``max_len``-deep cache) on rank 0 of ``model_axis``
    tensor-parallel ranks, counted on ``meta``."""

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.config import MeshConfig
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.api import build_model, param_specs
    from repro_torch.models.layers import TP
    from repro_torch.models.transformer import Ctx
    from repro_torch.train import sharding as S
    from repro_torch.train.shard import model_split, shard_params

    mesh_cfg = MeshConfig(data=1, model=model_axis, fsdp=False)
    shapes = param_specs(build_model(cfg, device="meta"))
    pspecs = S.param_pspecs(cfg, shapes, mesh_cfg)
    tp = (TP.dry(model_axis, model_split(shapes, pspecs))
          if model_axis > 1 else None)
    model = build_model(cfg, Ctx(attn_impl="kernel", tp=tp), device="meta")
    params = shard_params(shapes, pspecs, mesh_cfg, 0)
    cache = model.init_cache(batch, max_len)
    patches = cfg.num_patch_tokens if cfg.family == "vlm" else 0
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
    stats = tp.stats if tp is not None else {}
    # model_flops counts prefill tokens; a decode step's seq_len is its
    # cache's depth in tokens
    seq = positions if kind == "prefill" else max_len - patches
    shape = f"{kind}_{batch}x{positions if kind == 'prefill' else max_len}"
    return {"arch": arch or cfg.name, "shape": shape,
            "mesh": f"1x{model_axis}", "chips": model_axis,
            "flops_per_device": torch_flops + kernel_flops,
            "bytes_accessed_per_device": float(param_bytes + cache_bytes),
            "collective_bytes_per_device": ring_bytes(stats, model_axis),
            "counted": "computed",
            "overrides": dict(overrides or {}),
            "shape_cfg": {"name": shape, "seq_len": seq,
                          "global_batch": batch, "kind": kind},
            "torch_flops": torch_flops, "flash_flops": kernel_flops,
            "flash_calls": len(calls), "param_bytes": param_bytes,
            "cache_bytes": cache_bytes,
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


def write_records(path: str) -> list[dict]:
    records = gossip_records() + lm_records()
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
