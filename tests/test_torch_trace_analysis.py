"""``repro_torch.launch.trace_analysis`` on the CPU (the port's counterpart
of ``repro.launch.hlo_analysis``).

* The reference's ``test_hlo_analyzer_counts_nested_loops``: 5 x 10 nested
  products of 128 x 128 count 5 * 10 * 2 * 128**3 FLOPs (the port's loops
  unroll in the trace, so no trip counts are read).
* Collectives by kind with their result buffers' bytes, for redistributes
  whose traffic is known, on a fake world of 8 (2 x 4 data x model); the
  global-shape runs of DTensor's sharding propagation are not counted. Their
  elements, the same in any dtype (what the full-size parity compares), and
  the registered FLOPs by operation.
* Live and peak bytes: arguments, an allocation and its release.
* ``registered_flops`` equals ``FlopCounterMode``'s total over the same
  step: the smoke Qwen3 train step, real tensors under the counter and fake
  ones under the trace.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_smoke_config
from repro_torch.launch.dryrun import FakeArgs
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.launch.trace_analysis import COLLECTIVE_KINDS, TraceAnalysis, analysing
from repro_torch.models.registry import get_model
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_train_step


@pytest.fixture(scope="module")
def mesh():
    fake_world(8)
    yield make_mesh((2, 4), ("data", "model"), "cpu")
    dist.destroy_process_group()


def test_nested_products_count_every_iteration():
    mode = FakeTensorMode()
    with mode:
        x = torch.empty(128, 128)
        ws = torch.empty(10, 128, 128)
    with mode, analysing() as m:
        h = x
        for _ in range(5):
            for i in range(10):
                h = h @ ws[i]
    expected = 5 * 10 * 2 * 128 ** 3
    assert m.totals.registered_flops == expected
    assert m.totals.flops == expected


def test_extrapolate_is_affine_in_the_iterations():
    from repro_torch.launch.trace_analysis import extrapolate

    one = {"trace_s": 1.0, "peak_bytes": 100, "cost": {"flops": 10.0}, "op_calls": {"x": 1.0}, "mesh": "2x4"}
    two = {"trace_s": 2.0, "peak_bytes": 150, "cost": {"flops": 16.0}, "op_calls": {"x": 2.0}, "mesh": "2x4"}
    got = extrapolate(one, two, 5)
    assert got == {"trace_s": 3.0, "peak_bytes": 300, "cost": {"flops": 34.0}, "op_calls": {"x": 5.0},
                   "mesh": "2x4"}


def test_elementwise_transcendental_and_reduction_classes():
    mode = FakeTensorMode()
    with mode:
        x = torch.empty(10, 20)
    with mode, analysing() as m:
        y = x + x              # 200 FLOPs
        z = torch.exp(y)       # 200 FLOPs, 200 transcendentals
        z.sum(dim=-1)          # 200 FLOPs (input elements)
    assert m.totals.flops == 600
    assert m.totals.transcendentals == 200


def _kinds(m):
    return {k: (m.totals.collective_counts[k], m.totals.collective_bytes[k]) for k in COLLECTIVE_KINDS}


def test_collectives_by_kind_with_bytes(mesh):
    from torch.distributed.tensor import Partial, Replicate, Shard

    fa = FakeArgs(mesh)
    # (16, 64) float32 sharded (data, model): local (8, 16)
    x = fa.tensor((16, 64), torch.float32, ("data", "model"))
    with fa.mode, analysing() as m:
        y = x.redistribute(mesh, (Shard(0), Replicate()))          # all-gather over model
    assert y.to_local().shape == (8, 64)
    got = _kinds(m)
    assert got["all-gather"] == (1, 8 * 64 * 4)
    assert all(got[k] == (0, 0) for k in COLLECTIVE_KINDS if k != "all-gather")

    with fa.mode, analysing() as m:
        x.redistribute(mesh, (Shard(0), Shard(0)))                  # shard to shard over model
    assert _kinds(m)["all-to-all"] == (1, 2 * 64 * 4)

    p = fa.tensor((16, 64), torch.float32, ("data",))
    from torch.distributed.tensor import DTensor

    part = DTensor.from_local(p.to_local(), mesh, (Shard(0), Partial()), run_check=False)
    with fa.mode, analysing() as m:
        part.redistribute(mesh, (Shard(0), Replicate()))            # all-reduce over model
        part.redistribute(mesh, (Shard(0), Shard(1)))               # reduce-scatter over model
    got = _kinds(m)
    assert got["all-reduce"] == (1, 8 * 64 * 4)
    assert got["reduce-scatter"] == (1, 8 * 16 * 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_collective_elements_do_not_depend_on_the_dtype(mesh, dtype):
    from torch.distributed.tensor import Replicate, Shard

    fa = FakeArgs(mesh)
    x = fa.tensor((16, 64), dtype, ("data", "model"))
    w = fa.tensor((64, 32), dtype, ())
    with fa.mode, analysing() as m:
        x.redistribute(mesh, (Shard(0), Replicate())) @ w          # all-gather over model
    c = m.totals.as_dict()["collectives"]["all-gather"]
    assert (c["count"], c["elements"], c["bytes"]) == (1, 8 * 64, 8 * 64 * x.element_size())
    assert m.totals.registered_by_op == {"aten.mm": 2 * 8 * 64 * 32}


def test_sharded_product_counts_local_shapes_only(mesh):
    """A DTensor product counts the rank's local product; the sharding
    propagation's global-shape run is not the device's work."""
    fa = FakeArgs(mesh)
    x = fa.tensor((32, 64), torch.bfloat16, ("data",))
    w = fa.tensor((64, 128), torch.bfloat16, (None, "model"))
    with fa.mode, analysing() as m:
        y = x @ w
    assert y.to_local().shape == (16, 32)
    assert m.totals.registered_flops == 2 * 16 * 64 * 32


def test_live_and_peak_bytes():
    mode = FakeTensorMode()
    with mode:
        a = torch.empty(1000, dtype=torch.float32)
    with mode, analysing() as m:
        assert m.add_arguments({"a": a}) == 4000
        b = torch.empty(2000, dtype=torch.float32)
        c = b * 2
        del b, c
        d = torch.empty(10, dtype=torch.float32)
    assert m.peak_bytes == 4000 + 8000 + 8000
    assert m.live_bytes == 4000 + 40
    del d


def test_registered_flops_equal_the_flop_counter_over_a_train_step():
    cfg = get_smoke_config("qwen3_8b")
    model = get_model(cfg, device="cpu")
    params = model.init_params(seed=0)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32))
             for k in ("tokens", "labels")}
    step = make_train_step(model, AdamWConfig(), microbatches=2, remat=True)

    with FlopCounterMode(display=False) as fc:
        step(params, adamw_init(params), batch)

    mode = FakeTensorMode()
    fake = lambda t: mode.from_tensor(t)
    fparams = {k: v for k, v in torch.utils._pytree.tree_map(fake, params).items()}
    fbatch = {k: fake(v) for k, v in batch.items()}
    with mode:
        fopt = adamw_init(fparams)
    with mode, analysing() as m:
        step(fparams, fopt, fbatch)
    assert m.totals.registered_flops == fc.get_total_flops() > 0
    assert m.totals.op_calls == {"flash_attention": 8, "flash_attention_backward": 4}


def test_the_mode_leaves_nothing_patched():
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    from repro_torch.kernels import scratch

    before = (ShardingPropagator._propagate_tensor_meta_non_cached,
              placement_types.shard_dim_alltoall, list(scratch.watchers))
    with analysing():
        pass
    assert (ShardingPropagator._propagate_tensor_meta_non_cached,
            placement_types.shard_dim_alltoall, list(scratch.watchers)) == before
    assert isinstance(TraceAnalysis(), TraceAnalysis)
