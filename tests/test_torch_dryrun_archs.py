"""The port's dry-run against the reference's on the archs and the mesh
``test_torch_dryrun.py`` leaves out.

* On (2, 4) (data x model): the five archs that file does not hold —
  Mixtral-8x22B, StarCoder2-7B (6 query and 2 KV heads: the query heads
  do not divide the model axis), Granite-3-8B, Nemotron-4-15B and xLSTM —
  on every cell kind.
* On (1, 8): Whisper, Qwen2-VL, Qwen3 and xLSTM, whose smoke heads (4) do
  not divide a model axis of 8, as at full size StarCoder2's 36, Qwen2-VL's
  28, Whisper's 12 and xLSTM's 4 heads do not divide the production model
  axis of 16.
* On (2, 8), a world of 16: Whisper, Qwen3 and xLSTM, whose heads divide
  neither axis while the model axis is a multiple of the data axis (the
  production mesh's case: 16 x 16), so the attention weights' gradients
  split into the FSDP blocks.

The bars are ``test_torch_dryrun.py``'s: argument bytes a device equal the
reference's (less what its step never reads), dot FLOPs a device within 2%.

Mixtral's serve cells are compared at the reference's plan, FSDP-sharded
weights (``fsdp_weights=True`` in both packages): the reference shards them
because its 16 GB v5e cannot hold TP-only weights, while the port's own plan
keeps them TP-only on the 80 GB H100 (``launch/plan.py``, ``FSDP_AT_SERVE``
empty), which changes the argument bytes by design.

Each mesh's reference cells compile in a subprocess of their own on as many
fake XLA devices, all started before the port's traces.
"""
import pytest
import torch.distributed as dist

from repro_torch.launch.mesh import fake_world, make_mesh
from torch_port_dryrun import cells_for, reference_results, start_reference, stop, trace_cells

CELLS = {
    (2, 4): cells_for(("mixtral_8x22b", "starcoder2_7b", "granite_3_8b", "nemotron_4_15b",
                       "xlstm_350m"), fsdp_at_serve=("mixtral_8x22b",)),
    (1, 8): cells_for(("whisper_small", "qwen2_vl_7b", "qwen3_8b", "xlstm_350m")),
    (2, 8): [c for c in cells_for(("whisper_small", "qwen3_8b", "xlstm_350m")) if c[2] != "decode"],
}
IDS = [(shape, f"{a}/{n}") for shape, cells in CELLS.items() for a, n, *_ in cells]


def _id(case) -> str:
    shape, cell = case
    return f"{shape[0]}x{shape[1]}-{cell}"


@pytest.fixture(scope="module")
def reference_procs():
    procs = {shape: start_reference(cells, shape) for shape, cells in CELLS.items()}
    yield procs
    for proc in procs.values():
        stop(proc)


@pytest.fixture(scope="module")
def port(reference_procs):
    out = {}
    for world in (8, 16):
        fake_world(world)
        try:
            out.update({shape: trace_cells(cells, make_mesh(shape, ("data", "model"), "cpu"))
                        for shape, cells in CELLS.items() if shape[0] * shape[1] == world})
        finally:
            dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def reference(reference_procs):
    return {shape: reference_results(proc) for shape, proc in reference_procs.items()}


@pytest.mark.parametrize("case", IDS, ids=_id)
def test_argument_bytes_equal_the_reference(port, reference, case):
    shape, cell = case
    p, r = port[shape][cell], reference[shape][cell]
    assert p["memory"]["argument_bytes"] - p["unread"] == r["argument_bytes"]
    assert p["peak_bytes"] >= p["memory"]["argument_bytes"] > 0


@pytest.mark.parametrize("case", IDS, ids=_id)
def test_dot_flops_near_the_reference(port, reference, case):
    shape, cell = case
    got, want = port[shape][cell]["cost"]["registered_flops"], reference[shape][cell]["dot_flops"]
    assert abs(got / want - 1) <= 0.02, (got, want)


@pytest.mark.parametrize("shape", list(CELLS), ids=lambda s: f"{s[0]}x{s[1]}")
def test_train_cells_account_collectives(port, shape):
    for arch, name, kind, *_ in CELLS[shape]:
        if kind == "train":
            r = port[shape][f"{arch}/{name}"]
            assert r["collective_bytes_total"] > 0, arch
            assert r["collectives"]["all-reduce"]["count"] > 0, arch
