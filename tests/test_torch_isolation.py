"""The port stands alone: it imports no JAX and nothing of ``repro``, its
entry points refuse to run on the CPU unless asked, on CPU tensors its
kernel wrappers run the plain versions without counting a launch, and a
kernel build that fails leaves no compiler running."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_imports_no_jax_and_no_reference():
    mods = list(_modules())
    assert "repro_torch.kernels.sddmm.ops" in mods and len(mods) > 25
    assert {"repro_torch.kernels.quant.ops", "repro_torch.serve.quant",
            "repro_torch.serving.engine", "repro_torch.serving.queue",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.models.transformer",
            "repro_torch.launch.lm_engine",
            "repro_torch.mesh.plan", "repro_torch.core.compress",
            "repro_torch.core.gossip", "repro_torch.configs.gossip_mc",
            "repro_torch.launch.gossip",
            "repro_torch.launch.paper_tables",
            "repro_torch.faults.plan", "repro_torch.faults.recovery",
            "repro_torch.checkpoint.manager", "repro_torch.obs.spans",
            "repro_torch.launch.gossip_faults",
            "repro_torch.launch.gossip_async",
            "repro_torch.optim.optimizers", "repro_torch.train.step",
            "repro_torch.train.gossip_dp",
            "repro_torch.launch.train", "repro_torch.launch.serve",
            "repro_torch.train.sharding",
            "repro_torch.train.shard"} <= set(mods)
    code = (
        "import sys\n"
        f"for m in {mods!r}: __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")] + ["chip_smoke.py"]))
def test_no_jax_or_reference_import_statement(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.mc import CompletionProblem

    x = np.ones((4, 4), np.float32)
    for build in (
        lambda: CompletionProblem.from_dense(x, x, 2, 2, 1),
        lambda: CompletionProblem.from_entries([0], [1], [1.0], (4, 4),
                                               2, 2, 1),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()


def test_build_model_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.config import get_smoke_config
    from repro_torch.models import build_model

    cfg = get_smoke_config("gemma2-2b")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_model(cfg)
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_cpu_tensors_run_plain_versions_without_launching():
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.masked_factor_grad import ops as mfg
    from repro_torch.kernels.quant import ops as quant
    from repro_torch.kernels.sddmm import ops as sddmm
    from repro_torch.sparse.store import from_blocks

    rng = np.random.default_rng(0)
    mask = (rng.random((1, 2, 6, 5)) < 0.5).astype(np.float32)
    x = (rng.normal(size=mask.shape) * mask).astype(np.float32)
    sp = from_blocks(x, mask, bucket=8, device="cpu")
    u = torch.randn(1, 2, 6, 3)
    w = torch.randn(1, 2, 5, 3)
    codes = torch.ones((4, 3), dtype=torch.int8)
    scales = torch.ones(4)

    def launches():
        return (sddmm.sddmm_segment_grad.launches,
                sddmm.sddmm_factor_grad.launches,
                mfg.masked_factor_grad.launches, quant.dequant_score.launches,
                flash.flash_attention.launches)

    before = launches()
    sddmm.sddmm_segment_grad(sp.entries, u, w)
    sddmm.sddmm_factor_grad(sp.entries, u, w)
    mfg.masked_factor_grad(torch.from_numpy(x), torch.from_numpy(mask), u, w)
    for method in ("fused", "dequant", None):
        quant.dequant_score(codes, scales, codes, scales, method=method)
    q = torch.randn(1, 4, 5, 16)
    kv = torch.randn(1, 2, 5, 16)
    out = flash.flash_attention(q, kv, kv, window=3, softcap=5.0)
    assert out.shape == (1, 4, 5, 16)
    assert launches() == before
    with pytest.raises(ValueError, match="one device"):
        sddmm.sddmm_factor_grad(sp.entries, u.to("meta"), w)


def test_failed_build_stops_the_other_compilers(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    # a stand-in compiler: fails on csrc/sddmm.cu, hangs on the others
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        'case "$*" in *sddmm.cu*) echo "error: bad source"; exit 1;; esac\n'
        "exec sleep 120\n")
    fake.chmod(0o755)
    started, real_popen = [], subprocess.Popen

    def popen(*args, **kw):
        started.append(real_popen(*args, **kw))
        return started[-1]

    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "_OUT", tmp_path / "out")
    monkeypatch.setattr(_build.subprocess, "Popen", popen)
    names = ["sddmm", "masked_factor_grad", "dequant_score"]
    with pytest.raises(RuntimeError, match="nvcc failed on csrc/sddmm.cu"):
        _build.build(names)
    assert len(started) == len(names)
    # every compiler has ended and been reaped, none is left running
    assert [proc.returncode for proc in started][1:] == [-9, -9]
    for proc in started:
        with pytest.raises(ProcessLookupError):
            os.kill(proc.pid, 0)
    assert list((tmp_path / "out").iterdir()) == []
