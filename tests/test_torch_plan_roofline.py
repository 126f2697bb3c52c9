"""``repro_torch.launch.{plan,roofline,mesh}`` against the reference's
(``repro.launch.{plan,roofline,mesh}``).

* ``model_flops_per_chip`` equals the reference's for every arch x shape x
  chips in {1, 256, 512}.
* ``Roofline`` and ``roofline_for`` follow the reference's algebra with the
  H100's constants in place of the v5e's; ``table`` prints the reference's
  columns from the port's results directory.
* ``plan_for``'s FSDP and multi-pod decisions equal the reference's
  everywhere but the tables the port re-derived for 80 GB:
  ``MICROBATCHES`` (the port's own) and ``FSDP_AT_SERVE`` (empty: the
  reference keeps Mixtral-8x22B's weights FSDP-sharded at serve because
  its 17.6 GB of TP-only weights a chip overflow a 16 GB v5e, and they fit
  an 80 GB H100).
* The production meshes' shapes and axis names, over fake worlds of 256
  and 512.
"""
import json

import pytest
import torch.distributed as dist

import repro.launch.plan as ref_plan
import repro.launch.roofline as ref_roofline
from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import plan as port_plan
from repro_torch.launch import roofline as port_roofline


@pytest.mark.parametrize("chips", [1, 256, 512])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_per_chip_equal_the_reference(arch, chips):
    for cell in SHAPES:
        assert port_roofline.model_flops_per_chip(arch, cell.name, chips) == \
            ref_roofline.model_flops_per_chip(arch, cell.name, chips)


def test_h100_constants():
    assert port_mesh.PEAK_FLOPS_BF16 == 989e12
    assert port_mesh.HBM_BW == 3.35e12
    assert port_mesh.HBM_BYTES == 80e9
    assert port_mesh.ICI_BW_PER_LINK == port_mesh.INTER_NODE_BW == 50e9
    assert port_mesh.NVLINK_BW == 450e9


def _result(arch="qwen3_8b", shape="train_4k", mesh="16x16", chips=256, **kw):
    r = {"arch": arch, "shape": shape, "mesh": mesh, "chips": chips, "status": "ok", "tag": "",
         "memory": {"argument_bytes": 3e9, "output_bytes": 2e9, "temp_bytes": 5e9,
                    "alias_bytes": 1.5e9},
         "cost": {"flops": 4e14}, "collective_bytes_total": 2e10}
    r.update(kw)
    return r


@pytest.mark.parametrize("case", [
    {},
    {"cost": {"flops": 1e12}},
    {"collective_bytes_total": 1e12},
    {"shape": "decode_32k", "cost": {"flops": 1e11}},
    {"arch": "mixtral_8x22b", "shape": "prefill_32k", "mesh": "2x16x16", "chips": 512},
])
def test_roofline_follows_the_reference_algebra(case):
    r = _result(**case)
    p, q = port_roofline.roofline_for(r), ref_roofline.roofline_for(r)
    mem = r["memory"]
    hbm = mem["argument_bytes"] + mem["temp_bytes"] + max(0, mem["output_bytes"] - mem["alias_bytes"])
    assert p.compute_s == r["cost"]["flops"] / 989e12
    assert p.memory_s == hbm / 3.35e12
    assert p.collective_s == r["collective_bytes_total"] / 50e9
    assert p.fit_gb == q.fit_gb
    assert p.model_flops_per_chip == q.model_flops_per_chip
    assert p.hlo_flops_per_chip == q.hlo_flops_per_chip
    assert p.useful_ratio == q.useful_ratio
    assert p.bound_s == max(p.compute_s, p.memory_s, p.collective_s)
    assert p.dominant == max({"compute": p.compute_s, "memory": p.memory_s,
                              "collective": p.collective_s}.items(), key=lambda kv: kv[1])[0]
    assert p.roofline_fraction == p.model_flops_per_chip / (p.bound_s * 989e12)
    assert port_roofline.roofline_for({**r, "status": "failed"}) is None


def test_table_reads_the_ports_directory(tmp_path):
    assert port_roofline.RESULTS_DIR.name == "dryrun_torch"
    for name, r in {"a": _result(), "b": _result(shape="prefill_32k"),
                    "c": {"arch": "xlstm_350m", "shape": "train_4k", "mesh": "16x16",
                          "status": "failed", "error": "NotImplementedError: deferred"}}.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(r))
    (tmp_path / "broken.json").write_text("{")
    out = port_roofline.table(tmp_path)
    lines = out.splitlines()
    assert lines[0] == ("| arch | shape | compute (s) | memory (s) | collective (s) | dominant | "
                        "MODEL/HLO | roofline frac | fit GB/chip |")
    assert len(lines) == 5
    assert "| xlstm_350m | train_4k | failed | NotImplementedError: deferred |" in lines
    assert port_roofline.table(tmp_path, mesh="2x16x16").strip().count("\n") == 1


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_decisions_match_the_reference(arch, multi_pod):
    for cell in SHAPES:
        p = port_plan.plan_for(arch, cell.name, multi_pod)
        q = ref_plan.plan_for(arch, cell.name, multi_pod)
        assert p["remat"] == q["remat"]
        assert p["sharding"].dp_axes == q["sharding"].dp_axes
        assert p["sharding"].tp_axis == q["sharding"].tp_axis
        re_derived = arch in ref_plan.FSDP_AT_SERVE and cell.name != "train_4k"
        if re_derived:
            assert q["sharding"].fsdp_weights and not p["sharding"].fsdp_weights
        else:
            assert p["sharding"].fsdp_weights == q["sharding"].fsdp_weights
        mb = port_plan.MICROBATCHES.get((arch, cell.name), 1)
        assert p["microbatches"] == (min(mb, 8) if multi_pod and mb > 1 else mb)
        if cell.kind != "train":
            assert p["microbatches"] == q["microbatches"] == 1
    assert port_plan.WHISPER_DECODER_PROMPT == ref_plan.WHISPER_DECODER_PROMPT
    assert port_plan.WHISPER_CROSS_LEN == ref_plan.WHISPER_CROSS_LEN
    assert port_plan.NEVER_FSDP == ref_plan.NEVER_FSDP
    assert port_plan.FSDP_AT_SERVE == set()


def test_plan_overrides_and_the_microbatch_table():
    p = port_plan.plan_for("qwen3_8b", "train_4k", overrides={"microbatches": 3, "remat": False})
    assert p["microbatches"] == 3 and not p["remat"]
    for (arch, cell), mb in port_plan.MICROBATCHES.items():
        assert arch in ARCH_IDS and cell == "train_4k" and 256 % mb == 0 and mb >= 1


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes(multi_pod):
    n = 512 if multi_pod else 256
    port_mesh.fake_world(n)
    try:
        mesh = port_mesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod else ("data", "model"))
        assert port_mesh.dp_axes_for(mesh) == (("pod", "data") if multi_pod else ("data",))
        with pytest.raises(RuntimeError):
            port_mesh.fake_world(8)
    finally:
        dist.destroy_process_group()
