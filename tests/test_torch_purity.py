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
        "from repro_torch.models.recurrentgemma import RecurrentGemma\n"
        "import repro_torch.launch.serve, repro_torch.launch.generate, repro_torch.kernels.build\n"
        "import repro_torch.kernels.rglru, repro_torch.launch.profile_step\n"
        "import repro_torch.obs, repro_torch.serving.sampler, repro_torch.serving.threefry\n"
        "import repro_torch.train, repro_torch.train.train_loop, repro_torch.checkpoint\n"
        "import repro_torch.launch.train, repro_torch.kernels.flash_attention_bwd\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.recurrentgemma import RecurrentGemma
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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RecurrentGemma(get_smoke_config("recurrentgemma_9b"))
    from repro_torch.launch import train as train_launcher
    from repro_torch.train.train_loop import TrainConfig, train

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(cfg, TrainConfig(steps=1, batch=2, seq=8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_launcher.main(["--arch", "qwen3_8b", "--smoke", "--steps", "1"])


def test_flash_backward_timer_needs_the_card(monkeypatch):
    """The script that times a checkout's flash backward measures the card
    only: without CUDA it raises before it builds or imports a kernel."""
    from repro_torch.launch import time_flash_backward

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        time_flash_backward.main(["--iters", "1"])
    assert set(time_flash_backward.SHAPES) == {"b1", "b2"}


def test_train_launcher_offers_the_transformer_archs_and_names_the_rest(capsys):
    """``--arch`` takes the archs whose loss the port has (the TransformerLM
    families); RecurrentGemma, xLSTM and Whisper are refused with the
    ROADMAP item that brings them."""
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_launcher

    assert train_launcher.TRAIN_ARCHS == serve.ENGINE_ARCHS
    for arch, item in (("recurrentgemma_9b", "item 11"), ("xlstm_350m", "item 9"),
                       ("whisper_small", "item 9")):
        with pytest.raises(SystemExit):
            train_launcher.main(["--arch", arch, "--smoke", "--device", "cpu"])
        err = capsys.readouterr().err
        assert "cannot train it yet" in err and item in err, err
    out = train_launcher.main(["--arch", "qwen3_8b", "--smoke", "--steps", "2", "--batch", "2",
                               "--seq", "8", "--device", "cpu"])
    assert out["steps_run"] == 2 and "done: arch=qwen3-8b-smoke device=cpu" in capsys.readouterr().out


def test_serve_launcher_offers_only_the_archs_the_engine_serves(capsys):
    """The reference launcher's archs (``repro/launch/serve.py:53``) less what
    the port's Engine cannot take: RecurrentGemma has no fused
    ``decode_steps``, so the Engine's launcher refuses it (the reference's
    offers it and crashes at the first decode stage; ``generate_waves``
    serves it), and xLSTM is not ported. LLaMA-65B is off both lists."""
    from repro_torch.configs import ARCH_IDS, EXTRA_IDS
    from repro_torch.launch import serve

    assert "recurrentgemma_9b" in ARCH_IDS and EXTRA_IDS == ["llama_65b"]
    assert serve.ENGINE_ARCHS == ("mixtral_8x22b", "olmoe_1b_7b", "qwen3_8b", "starcoder2_7b",
                                  "granite_3_8b", "nemotron_4_15b", "qwen2_vl_7b")
    for arch in ("recurrentgemma_9b", "llama_65b"):
        with pytest.raises(SystemExit):
            serve.main(["--arch", arch, "--device", "cpu"])
        assert "invalid choice" in capsys.readouterr().err


def test_kernels_build_for_sm90a_from_the_checkout():
    from repro_torch.kernels import build

    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()
    assert build.BUILD_DIR == ROOT / "build" / "kernels"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
