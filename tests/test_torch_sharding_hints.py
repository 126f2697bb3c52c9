"""The GSPMD hints of ``repro_torch.distributed.sharding`` against the
reference's (``repro.distributed.sharding``: ``constrain_batch_dim``,
``constrain_kv_for_cache``, ``constrain_logits``, ``constrain_residual``,
``set_sequence_parallel``).

* On plain tensors each hint is the identity (the same object), and the
  smoke models' logits (training forward, prefill, decode) are bit-equal
  with the hints and the DTensor paths of ``distributed.spmd`` replaced by
  nothing at all: the serving and training paths never reach them.
* On DTensors over a fake world of 8 ((2, 4) data x model and (2, 2, 2)
  pod x data x model), each hint gives the placements of the spec the
  reference's constraint names for the same shape and mesh. The
  reference's specs come from one subprocess on 8 fake XLA devices, its
  ``with_sharding_constraint`` recorded instead of applied.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.distributed import sharding, spmd
from repro_torch.distributed.sharding import placements
from repro_torch.launch.dryrun import FakeArgs
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models.registry import get_model

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x4": ((2, 4), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# (hint, shape, extra argument)
CASES = [
    ("constrain_batch_dim", (8, 16, 64), 0),
    ("constrain_batch_dim", (2, 8, 64), 1),
    ("constrain_batch_dim", (3, 16), 0),
    ("constrain_batch_dim", (8,), 1),
    ("constrain_kv_for_cache", (8, 32, 2, 16), 2),
    ("constrain_kv_for_cache", (8, 32, 4, 16), 4),
    ("constrain_kv_for_cache", (8, 30, 2, 16), 2),
    ("constrain_kv_for_cache", (3, 32, 2, 16), 2),
    ("constrain_logits", (8, 16, 256), None),
    ("constrain_logits", (3, 256), None),
    ("constrain_logits", (8, 250), None),
    ("constrain_residual", (8, 32, 64), "on"),
    ("constrain_residual", (8, 30, 64), "on"),
    ("constrain_residual", (8, 32, 64), "off"),
]

REF_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from jax.sharding import Mesh
    import repro.distributed.sharding as sh

    meshes, cases = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    seen = []
    jax.lax.with_sharding_constraint = lambda x, spec: (seen.append(spec), x)[1]
    out = {}
    for name, (shape, axes) in meshes.items():
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), tuple(axes))
        for i, (hint, shp, arg) in enumerate(cases):
            x = jax.ShapeDtypeStruct(tuple(shp), jax.numpy.float32)
            seen.clear()
            with mesh:
                if hint == "constrain_residual":
                    sh.set_sequence_parallel(arg == "on")
                    sh.constrain_residual(x)
                    sh.set_sequence_parallel(False)
                elif hint == "constrain_logits":
                    sh.constrain_logits(x)
                else:
                    getattr(sh, hint)(x, arg)
            spec = None if not seen else [list(e) if isinstance(e, tuple) else e for e in seen[0]]
            out[f"{name}/{i}"] = spec
    print(json.dumps(out))
    print("OK")
""")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, json.dumps(MESHES), json.dumps(CASES)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-2])


@pytest.fixture(scope="module")
def meshes():
    fake_world(8)
    yield {name: make_mesh(shape, axes, "cpu") for name, (shape, axes) in MESHES.items()}
    dist.destroy_process_group()


def _apply(hint, x, arg):
    if hint == "constrain_residual":
        sharding.set_sequence_parallel(arg == "on")
        try:
            return sharding.constrain_residual(x)
        finally:
            sharding.set_sequence_parallel(False)
    if hint == "constrain_logits":
        return sharding.constrain_logits(x)
    return getattr(sharding, hint)(x, arg)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_identity_on_plain_tensors(i):
    hint, shape, arg = CASES[i]
    x = torch.zeros(shape)
    assert _apply(hint, x, arg) is x


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("i", range(len(CASES)))
def test_placements_match_the_reference_spec(reference, meshes, mesh_name, i):
    hint, shape, arg = CASES[i]
    mesh = meshes[mesh_name]
    fa = FakeArgs(mesh)
    x = fa.tensor(shape, torch.float32, ())                    # replicated to start
    with fa.mode:
        y = _apply(hint, x, arg)
    spec = reference[f"{mesh_name}/{i}"]
    if spec is None:                                          # the reference applies no constraint
        assert y is x
        return
    want = placements(tuple(tuple(e) if isinstance(e, list) else e for e in spec), mesh)
    assert tuple(y.placements) == want


def test_sequence_parallel_toggle():
    assert not sharding.sequence_parallel_enabled()
    sharding.set_sequence_parallel(True)
    assert sharding.sequence_parallel_enabled()
    sharding.set_sequence_parallel(False)
    assert not sharding.sequence_parallel_enabled()


def test_gradient_takes_the_constraint(meshes):
    """A hint binds the gradient too: a partial gradient arriving at a
    constrained value is reduced there (one all-reduce over the TP axis)."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    from repro_torch.launch.trace_analysis import analysing

    mesh = meshes["2x4"]
    fa = FakeArgs(mesh)
    x = fa.tensor((8, 16, 64), torch.float32, ("data",)).detach().requires_grad_(True)
    with fa.mode, analysing() as m:
        y = sharding.constrain_batch_dim(x, 0)
        g = DTensor.from_local(y.to_local().detach().clone(), mesh, (Shard(0), Partial()),
                               run_check=False)
        y.backward(g)
    assert tuple(x.grad.placements) == tuple(x.placements)
    assert m.totals.collective_counts["all-reduce"] == 1


def _run_models(device="cpu"):
    """Logits of the smoke models' training forward, prefill and decode."""
    out = {}
    rng = np.random.default_rng(0)
    for arch in ("qwen3_8b", "olmoe_1b_7b", "recurrentgemma_9b", "whisper_small"):
        cfg = get_smoke_config(arch)
        model = get_model(cfg, device=device)
        params = model.init_params(seed=1)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32))
        if cfg.family == "audio":
            frames = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32))
            out[f"{arch}/forward"] = model.forward(params, {"frames": frames, "tokens": tokens})[0]
            cache = model.cache_init(2, 16, enc_len=16)
            out[f"{arch}/prefill"] = model.prefill(params, tokens, cache, patch_embeds=frames)[0]
        else:
            out[f"{arch}/forward"] = model.forward(params, tokens)[0]
            cache = model.cache_init(2, 16)
            out[f"{arch}/prefill"] = model.prefill(params, tokens, cache)[0]
        out[f"{arch}/decode"] = model.decode_step(params, tokens[:, -1], cache)[0]
        with torch.enable_grad():
            leaves = torch.utils._pytree.tree_map(lambda t: t.detach().requires_grad_(True), params)
            loss = model.loss(leaves, {"tokens": tokens, "labels": tokens,
                                       **({"frames": frames} if cfg.family == "audio" else {})})
            loss.backward()
            out[f"{arch}/grad"] = torch.utils._pytree.tree_leaves(leaves)[0].grad
    return out


def test_models_are_bit_equal_without_the_hints(monkeypatch):
    with_hints = _run_models()
    ident = lambda x, *a, **k: x
    for mod_name in ("repro_torch.models.layers", "repro_torch.models.transformer",
                     "repro_torch.models.recurrentgemma", "repro_torch.models.whisper",
                     "repro_torch.models.attention", "repro_torch.models.moe",
                     "repro_torch.models.cache", "repro_torch.train.optimizer"):
        mod = sys.modules[mod_name]
        for name in ("constrain_batch_dim", "constrain_logits", "constrain_kv_for_cache",
                     "constrain_residual", "gather_fsdp"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, ident)
        if hasattr(mod, "is_dtensor"):
            monkeypatch.setattr(mod, "is_dtensor", lambda x: False)
    for name in dir(spmd):
        if not name.startswith("_") and callable(getattr(spmd, name)) and name not in (
                "Callable", "Dict", "List", "Optional", "Tuple", "annotations", "math", "torch"):
            monkeypatch.setattr(spmd, name, lambda *a, **k: pytest.fail("a DTensor path ran"))
    without = _run_models()
    assert with_hints.keys() == without.keys()
    for key in with_hints:
        assert torch.equal(with_hints[key], without[key]), key
