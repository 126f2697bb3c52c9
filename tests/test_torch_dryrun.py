"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``) on smoke cells.

For the smoke config of each family — dense (Qwen3-8B), MoE (OLMoE),
VLM (Qwen2-VL), hybrid (RecurrentGemma), audio (Whisper) — on each cell
kind (a train step, a prefill, a decode step) over a fake world of 8
((2, 4) data x model), with one microbatch:

* the cell's trace is ok;
* argument bytes a device equal the reference's
  ``memory_analysis().argument_size_in_bytes`` for the same cell and mesh,
  but for the arguments XLA's buffer assignment leaves out because the
  reference's step never reads them: the cache leaves a prefill replaces
  whole (every ``length``, a ring's K/V and positions, Whisper's cross K/V)
  and, in Whisper's decode step, the encoder's parameters and the cross
  attention's K/V projections (the cross K/V come from the cache);
* the registered FLOPs a device (dots and the kernels' ops) are within 2%
  of the reference's HLO dot FLOPs, summed through
  ``repro.launch.hlo_analysis``'s parser and loop trip counts, but for
  RecurrentGemma's train step, within 3%: the port checkpoints every layer,
  the reference its (rec, rec, attn) periods and not its tail layers, and
  PyTorch's checkpoint recomputes no further than the last tensor the
  backward reads;
* a train step's collective bytes are above 0.

The reference's side runs in one subprocess on 8 fake XLA devices, started
before the port's traces so that the two overlap. The command line writes
``experiments/dryrun_torch/`` (here a temporary directory).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch.distributed as dist
from torch.utils._pytree import tree_flatten_with_path

from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.launch.plan import plan_for

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("qwen3_8b", "olmoe_1b_7b", "qwen2_vl_7b", "recurrentgemma_9b", "whisper_small")
KINDS = {"train_4k": ("train", 32), "prefill_32k": ("prefill", 32), "decode_32k": ("decode", 64)}
BATCH = 8
CELLS = [(a, n, k, s, BATCH) for a in FAMILIES for n, (k, s) in KINDS.items()]
#: the port's FLOP count over the reference's, where a cell's differs by design
FLOP_TOLERANCE = {("recurrentgemma_9b", "train_4k"): 0.03}

REF_SCRIPT = textwrap.dedent("""
    import json, re, sys
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_smoke_config
    from repro.configs.shapes import ShapeCell
    from repro.launch import dryrun, hlo_analysis as ha
    from repro.launch.plan import plan_for

    def dot_flops(text):
        comps, entry = ha.parse_hlo(text)
        total = [0.0]
        def walk(name, mult, stack=()):
            comp = comps.get(name)
            if comp is None or name in stack:
                return
            stack = stack + (name,)
            for op_name in comp.order:
                op = comp.ops[op_name]
                oc = op.opcode
                if oc == "while":
                    m = re.search(r"condition=%?([\\w.\\-]+)", op.line)
                    b = re.search(r"body=%?([\\w.\\-]+)", op.line)
                    trips = ha._trip_count(comps, m.group(1)) if m else 1.0
                    if b:
                        walk(b.group(1), mult * trips, stack)
                    continue
                if oc in ("fusion", "call", "custom-call", "conditional", "async-start", "map",
                          "reduce", "reduce-window", "sort", "scatter", "select-and-scatter"):
                    for cm in ha._ATTR_CALLS.finditer(op.line):
                        walk(cm.group(1), mult, stack)
                if oc == "dot":
                    total[0] += mult * ha._dot_flops(comp, op)
        walk(entry, 1.0)
        return total[0]

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    out = {}
    for arch, name, kind, seq, batch in json.loads(sys.argv[1]):
        cfg = get_smoke_config(arch)
        dryrun.get_config = lambda a, cfg=cfg: cfg
        plan = plan_for(arch, name, False, {"microbatches": 1})
        fn, args, shards, outs, donate = dryrun.build_cell(
            arch, ShapeCell(name, seq, batch, kind), mesh, plan)
        with mesh:
            comp = jax.jit(fn, in_shardings=shards, out_shardings=outs,
                           donate_argnums=donate).lower(*args).compile()
        out[f"{arch}/{name}"] = {
            "argument_bytes": int(comp.memory_analysis().argument_size_in_bytes),
            "dot_flops": dot_flops(comp.as_text()),
        }
    print(json.dumps(out))
    print("OK")
""")


@pytest.fixture(scope="module")
def reference_proc():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, json.dumps(CELLS)], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def mesh():
    fake_world(8)
    yield make_mesh((2, 4), ("data", "model"), "cpu")
    dist.destroy_process_group()


def _unread_by_the_reference(arch: str, kind: str, args) -> int:
    """Bytes a device of the arguments the reference's step never reads."""
    total = 0
    for path, t in tree_flatten_with_path(args)[0]:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        names = [k for k in keys if isinstance(k, str)]
        local = t._local_tensor
        n = local.numel() * local.element_size()
        if kind == "prefill" and keys[0] == 2 and (
                names[-1] in ("length", "pos", "cross_k", "cross_v") or names[0] == "attn"):
            total += n
        if kind == "decode" and arch == "whisper_small" and keys[0] == 0 and (
                names[0] in ("encoder", "norm_enc_final")
                or names[1:] in (["cross_attn", "wk"], ["cross_attn", "wv"], ["cross_attn", "bv"])):
            total += n
    return total


@pytest.fixture(scope="module")
def port(mesh, reference_proc):
    out = {}
    for arch, name, kind, seq, batch in CELLS:
        cell = ShapeCell(name, seq, batch, kind)
        plan = plan_for(arch, name, False, {"microbatches": 1})
        step, args, fake = dryrun.build_cell(arch, cell, mesh, plan, cfg=get_smoke_config(arch))
        r = dryrun.trace_step(step, args, fake)
        r["unread"] = _unread_by_the_reference(arch, kind, args)
        out[f"{arch}/{name}"] = r
    return out


@pytest.fixture(scope="module")
def reference(reference_proc):
    try:
        stdout, stderr = reference_proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        reference_proc.kill()
        pytest.fail("the reference's subprocess ran past 300 s")
    assert reference_proc.returncode == 0 and "OK" in stdout, stderr[-3000:]
    return json.loads(stdout.splitlines()[-2])


@pytest.mark.parametrize("cell", [f"{a}/{n}" for a, n, *_ in CELLS])
def test_argument_bytes_equal_the_reference(port, reference, cell):
    p, r = port[cell], reference[cell]
    assert p["memory"]["argument_bytes"] - p["unread"] == r["argument_bytes"]
    assert p["peak_bytes"] >= p["memory"]["argument_bytes"] > 0


@pytest.mark.parametrize("cell", [f"{a}/{n}" for a, n, *_ in CELLS])
def test_dot_flops_near_the_reference(port, reference, cell):
    arch, name = cell.split("/")
    got, want = port[cell]["cost"]["registered_flops"], reference[cell]["dot_flops"]
    assert abs(got / want - 1) <= FLOP_TOLERANCE.get((arch, name), 0.02), (got, want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_cells_account_collectives(port, arch):
    r = port[f"{arch}/train_4k"]
    assert r["collective_bytes_total"] > 0
    assert r["collectives"]["all-gather"]["count"] > 0      # the FSDP gathers
    assert r["op_calls"]["flash_attention_backward"] > 0


def test_run_cell_writes_the_ports_directory(mesh, tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path / "dryrun_torch")
    r = dryrun.run_cell("qwen3_8b", "decode_32k", False, save=True, mesh=mesh,
                        cfg=get_smoke_config("qwen3_8b"), cell=ShapeCell("decode_32k", 64, 8, "decode"))
    assert r["status"] == "ok" and r["mesh"] == "2x4" and r["chips"] == 8
    saved = json.loads(Path(r["saved_to"]).read_text())
    assert saved["memory"]["temp_bytes"] == saved["peak_bytes"] - saved["memory"]["argument_bytes"]
    for key in ("cost", "collectives", "collective_bytes_total", "trace_s", "op_calls"):
        assert key in saved
    assert saved["op_calls"] == {"decode_attention": 2}
    assert Path(r["saved_to"]).parent.name == "dryrun_torch"


def test_a_failed_cell_is_recorded(mesh):
    """A cell that raises is recorded with its error and traceback (here a
    bounded cell shorter than two time chunks)."""
    r = dryrun.run_cell("xlstm_350m", "train_4k", False, save=False, mesh=mesh,
                        cfg=get_smoke_config("xlstm_350m"), cell=ShapeCell("train_4k", 32, 8, "train"))
    assert r["status"] == "failed" and "ValueError" in r["error"] and r["traceback"]
    r = dryrun.run_cell("qwen3_8b", "long_500k", False, save=False, mesh=mesh)
    assert r["status"] == "skipped"


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_bounded_trace_holds_to_a_full_trace(mesh, monkeypatch, kind):
    """xLSTM's long cells are traced at one and two time chunks and
    extrapolated (``trace_bounded``): at smoke size (one pair of blocks,
    chunks of 4 tokens, 3 chunks) the FLOPs, collectives and arguments equal
    a full trace's, and the peak is within 5% of it."""
    import dataclasses

    monkeypatch.setattr(dryrun, "TIME_CHUNK", 4)
    cfg = dataclasses.replace(get_smoke_config("xlstm_350m"), n_layers=2)
    name = "train_4k" if kind == "train" else "prefill_32k"
    cell = ShapeCell(name, 12, BATCH, kind)
    plan = plan_for("xlstm_350m", name, False)
    full = dryrun.trace_step(*dryrun.build_cell("xlstm_350m", cell, mesh, plan, cfg=cfg))
    got = dryrun.trace_bounded("xlstm_350m", cell, mesh, plan, cfg)
    assert got["bounded"] == {"traced_tokens": [4, 8], "chunks": 3}
    assert got["cost"]["registered_flops"] == full["cost"]["registered_flops"]
    assert got["collectives"] == full["collectives"]
    assert got["memory"]["argument_bytes"] == full["memory"]["argument_bytes"]
    assert abs(got["peak_bytes"] / full["peak_bytes"] - 1) < 0.05
