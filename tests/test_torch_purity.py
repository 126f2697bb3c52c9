"""Port purity: the PyTorch package and chip_smoke.py import neither JAX nor
the reference package, importing the port leaves JAX unloaded, and the entry
points refuse to fall back to the CPU when no CUDA device exists."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "from repro_torch.serving.engine import Engine, EngineConfig\n"
        "from repro_torch.models.transformer import TransformerLM\n"
        "import repro_torch.launch.serve, repro_torch.kernels.build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.engine import Engine, EngineConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen3_8b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TransformerLM(cfg)
    model = TransformerLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(model, {}, EngineConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--requests", "2"])


def test_kernels_build_for_sm90a_from_the_checkout():
    from repro_torch.kernels import build

    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()
    assert build.BUILD_DIR == ROOT / "build" / "kernels"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
