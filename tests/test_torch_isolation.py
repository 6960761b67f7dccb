"""The port stands alone: it imports no JAX and nothing of ``repro``, its
entry points refuse to run on the CPU unless asked, and on CPU tensors its
kernel wrappers run the plain versions without counting a launch."""

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


def test_cpu_tensors_run_plain_versions_without_launching():
    from repro_torch.kernels.masked_factor_grad import ops as mfg
    from repro_torch.kernels.sddmm import ops as sddmm
    from repro_torch.sparse.store import from_blocks

    rng = np.random.default_rng(0)
    mask = (rng.random((1, 2, 6, 5)) < 0.5).astype(np.float32)
    x = (rng.normal(size=mask.shape) * mask).astype(np.float32)
    sp = from_blocks(x, mask, bucket=8, device="cpu")
    u = torch.randn(1, 2, 6, 3)
    w = torch.randn(1, 2, 5, 3)
    before = (sddmm.sddmm_segment_grad.launches,
              sddmm.sddmm_factor_grad.launches, mfg.masked_factor_grad.launches)
    sddmm.sddmm_segment_grad(sp.entries, u, w)
    sddmm.sddmm_factor_grad(sp.entries, u, w)
    mfg.masked_factor_grad(torch.from_numpy(x), torch.from_numpy(mask), u, w)
    assert (sddmm.sddmm_segment_grad.launches,
            sddmm.sddmm_factor_grad.launches,
            mfg.masked_factor_grad.launches) == before
    with pytest.raises(ValueError, match="one device"):
        sddmm.sddmm_factor_grad(sp.entries, u.to("meta"), w)
