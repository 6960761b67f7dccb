"""Three-term roofline from records of one step (port of
``repro.roofline.analysis``, on the H100's peaks).

    compute    = FLOPs_per_device   / peak_FLOPs_per_card
    memory     = bytes_per_device   / HBM_bw_per_card
    collective = coll_bytes_per_dev / link_bw

The records are per device (a rank's shards), so dividing by per-card
peaks equals the global/(cards×peak) form.  The bottleneck is the largest
term; roofline fraction = compute / max(terms) (how close the cell is to
being compute-bound, the best it can do).

MODEL_FLOPS sanity: 6·N·D train / 2·N·D inference with N = matmul params
(active for MoE), D = tokens.  The ratio MODEL_FLOPS / counted FLOPs
exposes work the parameter count does not see (attention, recompute) and
sharding waste.

The functions, their signatures, output keys and arithmetic are the JAX
package's; only ``HW``'s defaults and what :func:`analyze_record` reads
of a record differ: its chip count is the record's ``chips`` where it has
one, and an LM record of the port may name a cut model (``overrides``,
e.g. ``{"num_layers": 8}``) and a shape outside ``SHAPES`` (``shape_cfg``,
the ``ShapeConfig``'s fields).  A record without these keys, such as one
of the JAX dry run, gets the JAX package's answer.
``HW(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)`` gives the JAX
package's numbers for the same records.
"""

from __future__ import annotations

import dataclasses
import re


@dataclasses.dataclass(frozen=True)
class HW:
    # NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit:
    # float32 outside the tensor cores, the rate of the port's f32 GEMMs
    # and f-gradient kernels (TF32 is off, repro_torch/__init__.py)
    peak_flops: float = 67e12           # FLOP/s per card
    hbm_bw: float = 3.35e12             # B/s per card (HBM3, 80 GB)
    # NVLink 4: 900 GB/s per card counting both directions; one direction
    ici_bw: float = 450e9               # B/s per card


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_bytes: float, hw: HW = HW()) -> dict:
    t_c = flops / hw.peak_flops
    t_m = bytes_accessed / hw.hbm_bw
    t_x = collective_bytes / hw.ici_bw
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x}
    dom = max(terms, key=terms.get)
    peak = max(max(terms.values()), 1e-30)
    return {
        **terms,
        "bottleneck": dom.replace("_s", ""),
        "roofline_fraction": t_c / peak,
    }


def model_flops(cfg, shape, active: bool = True) -> float:
    """6·N·D (train) / 2·N·D (one forward over D tokens)."""

    from repro_torch.models.api import active_param_count, matmul_param_count

    n = active_param_count(cfg) if active else matmul_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def record_chips(record: dict) -> int:
    """The cards a record's step runs on: its ``chips``, else the JAX dry
    run's meshes (512 for ``"2x16x16"``, else 256)."""

    if "chips" in record:
        return int(record["chips"])
    return 512 if record["mesh"] == "2x16x16" else 256


def analyze_record(record: dict, hw: HW = HW()) -> dict:
    from repro_torch.config import ShapeConfig, get_model_config, get_shape

    terms = roofline_terms(
        record["flops_per_device"],
        record["bytes_accessed_per_device"],
        record["collective_bytes_per_device"], hw)
    out = {**record, **terms}
    hlo_global = record["flops_per_device"] * record_chips(record)
    if record["arch"] == "gossip-mc":
        # per gossip round: R=M⊙(X−UWᵀ), gU=−2RW, gW=−2RᵀU per block —
        # three (mb×nb×r) matmuls — plus O(edge) consensus terms.
        m_ = re.match(r"(\d+)x(\d+)_r(\d+)_grid(\d+)x(\d+)", record["shape"])
        if m_:
            m, n, r, p, q = map(int, m_.groups())
            mf = 6.0 * m * n * r            # 3·2·mb·nb·r × (p·q blocks)
            out["model_flops"] = mf
            out["useful_flops_ratio"] = mf / hlo_global if hlo_global else 0.0
    else:
        cfg = get_model_config(record["arch"], **record.get("overrides", {}))
        shape = (ShapeConfig(**record["shape_cfg"]) if "shape_cfg" in record
                 else get_shape(record["shape"]))
        mf = model_flops(cfg, shape)
        out["model_flops"] = mf
        out["useful_flops_ratio"] = mf / hlo_global if hlo_global else 0.0
    return out


def render_table(analyses: list[dict]) -> str:
    cols = ("arch", "shape", "mesh", "compute_s", "memory_s", "collective_s",
            "bottleneck", "roofline_fraction", "useful_flops_ratio")
    lines = ["| " + " | ".join(cols) + " |",
             "|" + "|".join(["---"] * len(cols)) + "|"]
    for a in analyses:
        row = []
        for c in cols:
            v = a.get(c, "")
            row.append(f"{v:.3e}" if isinstance(v, float) else str(v))
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)
