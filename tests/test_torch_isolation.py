"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports jax or the JAX package, importing the port loads
neither jax nor triton, and nothing falls back to the CPU when no GPU is
there."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_import_loads_no_jax_or_triton():
    code = ("import sys, repro_torch, repro_torch.serving, "
            "repro_torch.runtime, repro_torch.launch.serve, "
            "repro_torch.kernels.paged_attention, repro_torch.bridge, "
            "repro_torch.configs; "
            "print(sorted(m for m in ('jax', 'triton', 'repro') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_no_device_without_gpu_raises(monkeypatch):
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.runtime import TorchTensorBackend
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-0.6b").reduced(n_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchTensorBackend(cfg, params, n_slots=1, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    """Here (no GPU), and in a directory holding chip_smoke.py and nothing
    else of the repository, it exits non-zero and prints no result."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    elif torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=_env() if not alone else None,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
