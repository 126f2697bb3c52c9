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
  reference's step never reads them (``torch_port_dryrun.
  unread_by_the_reference``);
* the registered FLOPs a device (dots and the kernels' ops) are within 2%
  of the reference's HLO dot FLOPs, summed through
  ``repro.launch.hlo_analysis``'s parser and loop trip counts (RecurrentGemma
  checkpoints its (rec, rec, attn) periods and not its tail layers in both
  packages);
* a train step's collective bytes are above 0.

The reference's side runs in one subprocess on 8 fake XLA devices, started
before the port's traces so that the two overlap (``torch_port_dryrun``).
The command line writes ``experiments/dryrun_torch/`` (here a temporary
directory). The other archs, and the mesh whose model axis is wider than
the heads, are in ``test_torch_dryrun_archs.py``.
"""
import json
from pathlib import Path

import pytest
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.launch.plan import plan_for
from torch_port_dryrun import BATCH, cells_for, reference_results, start_reference, stop, trace_cells

FAMILIES = ("qwen3_8b", "olmoe_1b_7b", "qwen2_vl_7b", "recurrentgemma_9b", "whisper_small")
CELLS = cells_for(FAMILIES)
#: the port's FLOP count over the reference's, where a cell's differs by design
FLOP_TOLERANCE = {}


@pytest.fixture(scope="module")
def reference_proc():
    proc = start_reference(CELLS, (2, 4))
    yield proc
    stop(proc)


@pytest.fixture(scope="module")
def mesh():
    fake_world(8)
    yield make_mesh((2, 4), ("data", "model"), "cpu")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port(mesh, reference_proc):
    return trace_cells(CELLS, mesh)


@pytest.fixture(scope="module")
def reference(reference_proc):
    return reference_results(reference_proc)


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
