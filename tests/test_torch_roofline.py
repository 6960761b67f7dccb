"""The port's roofline module and its records against the JAX package's.

``roofline_terms``, ``model_flops``, ``analyze_record`` and
``render_table`` are arithmetic on equal inputs, so they are held to
exact equality with ``repro.roofline.analysis`` (``HW`` passed
explicitly where the defaults differ: v5e there, H100 here).  The port's
records (``launch/roofline_bench.py``) are counted from shapes on
``meta``; they are held to counts made by hand from the same shapes.
"""

import dataclasses
import importlib.util
import json
import math
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import ARCHS as J_ARCHS  # noqa: E402
from repro.config import SHAPES as J_SHAPES  # noqa: E402
from repro.config import get_model_config as j_get_model_config  # noqa: E402
from repro.config import get_shape as j_get_shape  # noqa: E402
from repro.roofline import analysis as J  # noqa: E402
from repro_torch import roofline as T  # noqa: E402
from repro_torch.config import (ARCHS, SHAPES, get_model_config,  # noqa: E402
                                get_shape, get_smoke_config)
from repro_torch.launch import roofline_bench as RB  # noqa: E402
from repro_torch.models.api import (  # noqa: E402
    active_param_count, build_model, param_specs)
from repro_torch.optim.optimizers import tree_map_with_path  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent

V5E = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)
H100 = dict(peak_flops=67e12, hbm_bw=3.35e12, ici_bw=450e9)
# (flops, bytes, collective bytes): each bottleneck, ties, zeros
TERMS = [(197e12, 0.0, 0.0), (197e10, 819e9, 0.0), (0.0, 0.0, 50e9),
         (1.0, 1.0, 1.0), (0.0, 0.0, 0.0), (6.7e13, 3.35e12, 4.5e11),
         (7.52e7, 2.2045e7, 0.0), (1.2e15, 3.6e10, 6.8e9),
         (3.0e9, 9.1e9, 4.9e6)]


def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "roofline_bench", ROOT / "benchmarks" / "roofline_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hw_defaults_are_the_h100_sheet():
    assert dataclasses.asdict(T.HW()) == H100
    assert [f.name for f in dataclasses.fields(T.HW)] == \
        [f.name for f in dataclasses.fields(J.HW)]


@pytest.mark.parametrize("hw", [V5E, H100], ids=["v5e", "h100"])
def test_roofline_terms_equal_jax(hw):
    bottlenecks = set()
    for flops, nbytes, coll in TERMS:
        got = T.roofline_terms(flops, nbytes, coll, T.HW(**hw))
        want = J.roofline_terms(flops, nbytes, coll, J.HW(**hw))
        assert got == want
        bottlenecks.add(got["bottleneck"])
    assert bottlenecks == {"compute", "memory", "collective"}


def test_roofline_terms_default_hw_is_the_h100():
    got = T.roofline_terms(67e12, 3.35e12, 450e9)
    assert got["compute_s"] == got["memory_s"] == got["collective_s"] == 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_jax_every_shape(arch):
    assert list(ARCHS) == list(J_ARCHS) and list(SHAPES) == list(J_SHAPES)
    cfg, jcfg = get_model_config(arch), j_get_model_config(arch)
    for shape in SHAPES:
        for active in (True, False):
            assert T.model_flops(cfg, get_shape(shape), active) == \
                J.model_flops(jcfg, j_get_shape(shape), active)


RECORDS = [
    {"arch": "gossip-mc", "shape": "6040x3706_r15_grid5x5", "mesh": "16x16",
     "flops_per_device": 7.52e7, "bytes_accessed_per_device": 2.2045e7,
     "collective_bytes_per_device": 0.0},
    {"arch": "gemma2-2b", "shape": "decode_32k", "mesh": "2x16x16",
     "flops_per_device": 3.1e10, "bytes_accessed_per_device": 5.4e9,
     "collective_bytes_per_device": 2.2e7},
    {"arch": "internvl2-76b", "shape": "prefill_32k", "mesh": "16x16",
     "flops_per_device": 9.9e14, "bytes_accessed_per_device": 3.6e10,
     "collective_bytes_per_device": 1.7e9},
]


@pytest.mark.parametrize("hw", [V5E, H100], ids=["v5e", "h100"])
def test_analyze_record_and_render_table_equal_jax(hw):
    got = [T.analyze_record(dict(r), T.HW(**hw)) for r in RECORDS]
    want = [J.analyze_record(dict(r), J.HW(**hw)) for r in RECORDS]
    assert got == want
    assert T.render_table(got) == J.render_table(want)
    assert "model_flops" in got[0] and "model_flops" in got[1]


def test_analyze_record_reads_chips_and_a_cut_model():
    rec = dict(RECORDS[1], chips=4)
    a = T.analyze_record(rec)
    assert a["useful_flops_ratio"] == a["model_flops"] / (4 * 3.1e10)
    # without "chips": the JAX rule (512 for "2x16x16")
    b = T.analyze_record(RECORDS[1])
    assert b["useful_flops_ratio"] == b["model_flops"] / (512 * 3.1e10)
    cut = dict(RECORDS[2], chips=1, overrides={"num_layers": 8},
               shape_cfg={"name": "prefill_4x2048", "seq_len": 2048,
                          "global_batch": 4, "kind": "prefill"})
    cfg = dataclasses.replace(get_model_config("internvl2-76b"),
                              num_layers=8)
    assert T.analyze_record(cut)["model_flops"] == \
        2.0 * active_param_count(cfg) * 4 * 2048


def _weights(cfg):
    """(matmul weights of the units, norm scales) counted from the
    parameter tree by hand, and the unembedding's d·V."""

    mats, norms = 0, 0

    def visit(path, x):
        nonlocal mats, norms
        if "embed" in path or "lm_head" in path:
            return
        if "norm" in path:
            norms += math.prod(x.shape)
        else:
            mats += math.prod(x.shape)

    tree_map_with_path(visit, param_specs(build_model(cfg, device="meta")))
    return mats, norms, cfg.d_model * cfg.vocab_size


def test_lm_prefill_record_counts_by_hand():
    """A small dense LM's prefill: the torch matmuls are every unit weight
    once a token plus the last position's logits; the flash work is
    2·(D + Dv) a causal pair.  Against ``model_flops`` (2·N·T with N from
    ``active_param_count``) the excess is the attention term less what N
    holds that this step does not multiply: the norm scales, the logits
    of the T − B earlier positions, and the untied head counted twice in
    N (once as ``lm_head``, once as the unembedding)."""

    cfg = get_smoke_config("internlm2-20b")
    B, L = 1, 512
    rec = RB.lm_record(cfg, "prefill", B, L, L + 8, 1)
    mats, norms, dv = _weights(cfg)
    T_ = B * L
    hd = cfg.resolved_head_dim
    attention = (cfg.num_layers * B * cfg.num_heads * 2 * (hd + hd)
                 * L * (L + 1) // 2)
    assert rec["flash_calls"] == cfg.num_layers
    assert rec["flash_flops"] == attention
    assert rec["torch_flops"] == 2 * T_ * mats + 2 * B * dv
    mf = T.model_flops(cfg, dataclasses.replace(
        get_shape("prefill_32k"), seq_len=L, global_batch=B))
    assert active_param_count(cfg) == mats + norms + 2 * dv
    assert rec["flops_per_device"] - mf == (
        attention - 2 * T_ * norms - 2 * (T_ - B) * dv - 2 * T_ * dv)
    assert rec["flops_per_device"] >= mf
    assert rec["counted"] == "computed" and rec["chips"] == 1
    assert rec["collective_bytes_per_device"] == 0.0


def test_lm_decode_record_counts_by_hand():
    cfg = get_smoke_config("internlm2-20b")
    B, L, max_len = 2, 100, 160
    rec = RB.lm_record(cfg, "decode", B, L, max_len, 1)
    mats, _, dv = _weights(cfg)
    hd = cfg.resolved_head_dim
    # plain attention over the whole cache, both products
    attention = cfg.num_layers * B * cfg.num_heads * 2 * 2 * hd * max_len
    assert rec["flash_calls"] == 0
    assert rec["torch_flops"] == 2 * B * mats + 2 * B * dv + attention
    cache = 2 * cfg.num_layers * B * cfg.num_kv_heads * max_len * hd * 2
    assert rec["cache_bytes"] == cache                   # bf16 k and v
    assert rec["param_bytes"] == 4 * (mats + _weights(cfg)[1] + 2 * dv)


def test_lm_record_on_two_ranks_counts_its_collectives():
    cfg = get_smoke_config("internlm2-20b")
    B, L = 2, 64
    one = RB.lm_record(cfg, "prefill", B, L, L, 1)
    two = RB.lm_record(cfg, "prefill", B, L, L, 2)
    coll = two["collectives"]
    # an all-reduce after each row-parallel product (attn.wo, mlp.wo) and
    # the vocab-parallel embedding's; one all-gather of the logits
    assert coll["all_reduce"]["calls"] == 2 * cfg.num_layers + 1
    assert coll["all_reduce"]["bytes"] == \
        (2 * cfg.num_layers + 1) * B * L * cfg.d_model * 4
    assert coll["all_gather"] == {"calls": 1,
                                  "bytes": B * cfg.vocab_size // 2 * 4}
    b_ar, b_ag = coll["all_reduce"]["bytes"], 2 * coll["all_gather"]["bytes"]
    assert two["collective_bytes_per_device"] == \
        2.0 * b_ar * 1 / 2 + b_ag * 1 / 2
    assert two["flash_flops"] * 2 == one["flash_flops"]
    assert two["param_bytes"] < one["param_bytes"]
    assert two["chips"] == 2 and two["mesh"] == "1x2"


def test_tp_dry_counts_all_to_all():
    from repro_torch.models.layers import TP, all_to_all

    tp = TP.dry(4)
    x = torch.empty((4, 6, 8), device="meta")
    y = all_to_all(x, tp)
    assert y.shape == x.shape and y.device.type == "meta"
    all_to_all(torch.empty((4, 6), dtype=torch.int32, device="meta"), tp)
    assert tp.stats == {"all_to_all": [2, 0.0, 4 * 6 * 8 * 4 + 4 * 6 * 4]}
    # the rank keeps its own chunk: (n - 1) / n of the bytes cross
    assert RB.ring_bytes(tp.stats, 4) == tp.stats["all_to_all"][2] * 3 / 4
    with pytest.raises(ValueError, match="leading dim"):
        all_to_all(torch.empty((3, 6), device="meta"), tp)
    with pytest.raises(RuntimeError, match="meta"):
        all_to_all(torch.empty((4, 6)), tp)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_moe_records_count_both_expert_parallel_forms(arch):
    """Four EP ranks: the psum form all-reduces each MoE layer's (T, d)
    output; the a2a form sends each rank's (n, C, d) rows and (n, C) ids
    and takes its rows back, then all-gathers its (T/n, d) part."""

    from repro_torch.models.moe import a2a_capacity

    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, num_kv_heads=4)
    B, L, n = 2, 16, 4
    psum = RB.lm_record(cfg, "prefill", B, L, L, n)
    a2a = RB.lm_record(cfg, "prefill", B, L, L, n, moe_impl="a2a")
    assert a2a["shape"] == psum["shape"] + "_a2a"
    n_moe = cfg.num_layers - (1 if cfg.mla is not None else 0)
    d, k = cfg.d_model, cfg.moe.num_experts_per_tok
    act = B * L * d * 4
    p_ar, a_ar = (r["collectives"]["all_reduce"] for r in (psum, a2a))
    assert "all_to_all" not in psum["collectives"]
    C = a2a_capacity(B * L // n, k, n, 2.0)
    assert a2a["collectives"]["all_to_all"] == {
        "calls": 3 * n_moe, "bytes": n_moe * (2 * n * C * d * 4 + n * C * 4)}
    assert a2a["collectives"]["all_gather"]["calls"] >= n_moe
    # the a2a form drops the MoE layers' all-reduces of the activations
    # (an aux scalar a layer stays; a shared expert keeps its own)
    shared = cfg.moe.num_shared_experts > 0
    assert p_ar["calls"] - a_ar["calls"] == (-n_moe if shared else 0)
    assert p_ar["bytes"] - a_ar["bytes"] == (n_moe * act * (0 if shared
                                                             else 1)
                                             - 4 * n_moe)
    assert psum["flash_calls"] == a2a["flash_calls"] == cfg.num_layers


def test_gossip_record_counts_by_hand():
    rng = np.random.default_rng(3)
    m, n, r = 40, 30, 5
    mask = rng.random((m, n)) < 0.3
    counts = RB.block_nnz(mask, 4, 4)
    assert counts.sum() == mask.sum()
    rec = RB.gossip_record(m, n, r, (4, 4), (2, 2), counts)
    mb, nb = 10, 8                          # 30 pads to 32 over 4 blocks
    tiles = [counts[i:i + 2, j:j + 2].sum() for i in (0, 2) for j in (0, 2)]
    nnz = max(tiles)
    assert rec["nnz_per_device"] == nnz and rec["block"] == [mb, nb]
    assert rec["flops_per_device"] == nnz * (6 * r + 4)
    B = 4
    assert rec["bytes_accessed_per_device"] == (
        nnz * 20 + 4 * B * (mb + nb + 2) + 8 * B * (mb + nb) * r + 4 * B)
    # 2x2 ranks: one U edge and one W edge each way between neighbours
    u_msg, w_msg = 2 * mb * r * 4, 2 * nb * r * 4
    total = 2 * 2 * 1 * u_msg + 2 * 2 * 1 * w_msg
    assert rec["collective_bytes_per_device"] == total / 4
    one = RB.gossip_record(m, n, r, (4, 4), (1, 1), counts)
    assert one["collective_bytes_per_device"] == 0
    assert one["nnz_per_device"] == mask.sum()


def test_table3_fit_round_record():
    rec = RB.gossip_records()[0]
    # PERF.md's row 1a bound: 75 MFLOP and 22.0 MB at the 5 x 5 stack
    assert rec["nnz_per_device"] == 800_000
    assert rec["flops_per_device"] == 75.2e6
    assert round(rec["bytes_accessed_per_device"] / 1e6, 1) == 22.0
    assert (rec["shape"], rec["mesh"], rec["chips"]) == \
        ("6040x3706_r15_grid5x5", "1x1", 1)


def test_roofline_bench_reads_as_the_jax_bench(tmp_path):
    """The same records through both benches: the same cells survive
    (last record per key wins), and the lines have the JAX format with
    the port's numbers."""

    jb = _jax_bench()
    first = tmp_path / "a.jsonl"
    second = tmp_path / "b.jsonl"
    stale = dict(RECORDS[0], flops_per_device=1.0)
    first.write_text("".join(json.dumps(r) + "\n"
                             for r in (stale, RECORDS[1])))
    second.write_text(json.dumps(RECORDS[0]) + "\n")
    glob = str(tmp_path / "*.jsonl")
    assert RB.load_records(glob) == jb.load_records(glob)
    assert RB.load_records(glob)[0] == RECORDS[0]
    lines_t, lines_j = [], []
    RB.main(["--path", glob], out=lines_t.append)
    jb.main(out=lines_j.append, path=glob)
    assert len(lines_t) == len(lines_j) == 2
    pat = re.compile(r"roofline_[^,]+,[0-9.]+,compute_s=[^;]+;memory_s=[^;]+;"
                     r"collective_s=[^;]+;bottleneck=\w+;frac=[0-9.]+;"
                     r"useful=[0-9.]+$")
    for t, j in zip(lines_t, lines_j):
        assert pat.match(t) and pat.match(j)
        assert t.split(",")[0] == j.split(",")[0]
    a = T.analyze_record(RECORDS[0])
    assert lines_t[0] == RB.roofline_line(a)
    empty = []
    RB.main(["--path", str(tmp_path / "none*.jsonl")], out=empty.append)
    assert empty and empty[0].startswith("roofline,0,")


def test_roofline_bench_writes_the_fit_records(tmp_path):
    path = tmp_path / "rec.jsonl"
    out = []
    got = RB.main(["--write", str(path)], out=out.append)
    assert [(a["arch"], a["mesh"]) for a in got] == [
        ("gossip-mc", "1x1"), ("gossip-mc", "2x2")] + [
        ("internvl2-76b", m) for m in ("1x1", "1x1", "1x4", "1x4")] + [
        (arch, "1x4") for arch in RB.MOE_ARCHS for _ in range(3)] + [
        ("granite-34b", m) for m in ("1x1", "1x1", "1x4", "1x4")] + [
        ("qwen1.5-32b", m) for m in ("1x1", "1x1", "2x2", "2x2")] + [
        (arch, m) for arch in RB.LONG_ARCHS for m in ("1x1", "2x2")]
    # the expert-parallel cell: psum and a2a prefills, a psum decode step
    assert [a["shape"] for a in got[-15:-12]] == [
        "prefill_4x4000", "prefill_4x4000_a2a", "decode_4x4096"]
    # the sequence-sharded KV cell: a prefill and a decode step a mesh
    assert [a["shape"] for a in got[-12:-8]] == [
        "prefill_4x1024", "decode_4x1376"] * 2
    # the FSDP cell: the same, the 2 x 2 records counting the gathers
    assert [a["shape"] for a in got[-8:-4]] == [
        "prefill_4x1024", "decode_4x1032"] * 2
    assert [a["chips"] for a in got[-8:-4]] == [1, 1, 4, 4]
    # the long_500k cell: one decode step a mesh, B = 1 whole on a rank
    assert [a["shape"] for a in got[-4:]] == ["decode_1x524288"] * 4
    assert [a["chips"] for a in got[-4:]] == [1, 4, 1, 4]
    assert all(json.loads(x)["counted"] == "computed"
               for x in path.read_text().splitlines())
    assert out[0].startswith("roofline_gossip-mc_6040x3706_r15_grid5x5_1x1,")
    assert got[0]["bottleneck"] == "memory"
