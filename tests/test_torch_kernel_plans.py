"""Host-side plans of the attention kernels, on the CPU: the split count and
heads a CTA of paged decode attention (kernel 1), its scratch sizing and
reuse, flash attention's (kernel 2) dispatch table and CTA tile, dense
decode attention's (kernel 3) body, split count and heads a CTA, with the
split scratch it shares with kernel 1, and the flash backward's plan (body,
grids, launch order, group split, scratch, device kernels).
None of these reads a device tensor; they decide from shapes alone."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.kernels import paged_decode_attention as pda
from torch_port_arrays import shuffled_tables

H100_SMS = 132


# --------------------------------------------------------------------------- #
# Kernel 1: split count, heads a CTA, scratch                                 #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b,h,kv,mb,bs", [
    (8, 32, 8, 40, 16),       # Qwen3-8B paged serve: 8 slots x 640 keys
    (8, 4, 2, 8, 16),         # the smoke model
    (1, 16, 1, 2, 16),        # one slot, one page pair
    (64, 32, 8, 40, 16),      # many slots: one wave already
    (8, 32, 8, 256, 16),      # 4096 keys
    (2, 8, 8, 1, 1),          # one key a row
    (0, 32, 8, 40, 16),       # no slot at all
    (4, 12, 4, 7, 5),         # g = 3, ragged pages
])
def test_decode_plan_bounds(b, h, kv, mb, bs):
    plan = pda.decode_plan(b, h, kv, mb, bs, H100_SMS)
    tiles = -(-(mb * bs) // pda.SPLIT_TILE)
    assert 1 <= plan.splits <= max(1, tiles)
    assert plan.split_keys % pda.SPLIT_TILE == 0 and plan.split_keys * plan.splits >= mb * bs
    assert (plan.split_keys - pda.SPLIT_TILE) * plan.splits < max(1, mb * bs)
    g = h // kv
    assert plan.group in (1, 2, 4, 8) and plan.group >= min(g, 8)
    assert plan.parts * plan.group >= g and (plan.parts - 1) * plan.group < g
    if plan.splits < max(1, tiles):
        # short of the key tiles only where the CTA target is met
        assert plan.splits == max(1, round(1.5 * H100_SMS / max(1, b * kv * plan.parts)))


def test_decode_plan_at_the_serving_shape():
    """8 slots x 8 KV heads over 640 keys: 3 splits of 224 keys, 192 CTAs
    on 132 SMs."""
    plan = pda.decode_plan(8, 32, 8, 40, 16, H100_SMS)
    assert plan == pda.DecodePlan(splits=3, split_keys=224, group=4, parts=1)
    assert plan.scratch(8, 8, 128) == (64 * 3 * 4 * 130, 64)


@pytest.mark.parametrize("g,group,parts", [(1, 1, 1), (2, 2, 1), (3, 4, 1), (4, 4, 1), (8, 8, 1),
                                           (12, 8, 2), (16, 8, 2)])
def test_decode_plan_splits_large_groups(g, group, parts):
    plan = pda.decode_plan(8, 2 * g, 2, 40, 16, H100_SMS)
    assert (plan.group, plan.parts) == (group, parts)


def test_decode_plan_uses_shapes_only():
    """The plan is the same whatever the lengths: it takes none."""
    assert pda.decode_plan(8, 32, 8, 40, 16, H100_SMS) == pda.decode_plan(8, 32, 8, 40, 16, H100_SMS)
    assert pda.decode_plan(8, 32, 8, 40, 16, 66).splits < pda.decode_plan(8, 32, 8, 40, 16, H100_SMS).splits


def test_decode_scratch_unsplit_is_empty():
    assert pda.DecodePlan(1, 640, 4, 1).scratch(8, 8, 128) == (0, 0)
    assert pda.DecodePlan(3, 224, 8, 2).scratch(2, 1, 64) == (2 * 2 * 3 * 8 * 66, 4)


@pytest.mark.parametrize("splits,keys,split_keys", [
    (1, 640, 640), (3, 640, 224), (5, 640, 128), (9, 640, 96), (20, 640, 32),
    (1, 1, 32), (2, 33, 32), (4, 0, 32),
])
def test_plan_with_splits_covers_the_row(splits, keys, split_keys):
    """A split covers an equal share of the row rounded up to SPLIT_TILE
    keys; together the splits cover the whole row."""
    plan = pda.plan_with_splits(splits, keys, 4, 1)
    assert plan == pda.DecodePlan(splits, split_keys, 4, 1)
    assert plan.splits * plan.split_keys >= keys


def test_workspace_reused_per_device_and_grown_once():
    dev = torch.device("cpu")
    pda._workspaces.pop((dev.type, dev.index), None)
    f1, c1 = pda.workspace(dev, 1000, 16)
    assert f1.dtype == torch.float32 and c1.dtype == torch.int32
    assert bool((c1 == 0).all())
    f2, c2 = pda.workspace(dev, 1000, 16)
    f3, c3 = pda.workspace(dev, 10, 2)                 # a smaller plan fits
    assert f2 is f1 and c2 is c1 and f3 is f1 and c3 is c1
    f4, c4 = pda.workspace(dev, 5000, 8)               # a larger one replaces it
    assert f4.numel() == 5000 and c4.numel() == 16 and bool((c4 == 0).all())
    assert pda.workspace(dev, 1000, 16)[0] is f4
    meta = torch.device("meta")
    fm, _ = pda.workspace(meta, 10, 1)                 # another device, its own pair
    assert fm.device == meta and pda.workspace(dev, 10, 1)[0] is f4
    pda._workspaces.pop((meta.type, meta.index), None)
    pda._workspaces.pop((dev.type, dev.index), None)


def test_cpu_decode_touches_no_workspace():
    """The plain path on CPU tensors plans nothing and counts no launch."""
    rng = np.random.default_rng(0)
    b, h, kv, d, p, bs, mb = 3, 4, 2, 16, 12, 4, 4
    lengths = np.array([5, 0, 16], np.int32)
    tables = torch.from_numpy(shuffled_tables(rng, b, mb, p, bs, lengths))
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((kv, p, bs, d)).astype(np.float32)) for _ in range(2))
    before = dict(pda._workspaces)
    pda.reset_launch_count()
    out = pda.paged_decode_attention(q, k, v, tables, torch.from_numpy(lengths))
    assert out.shape == q.shape and pda.launch_count == 0 and pda._workspaces == before
    assert torch.equal(out[1], torch.zeros_like(out[1]))


# --------------------------------------------------------------------------- #
# Kernel 2: dispatch table and CTA tile                                       #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_variant_table(dtype, d):
    want = "tensor_cores" if dtype == torch.bfloat16 and d >= 64 else "cuda_cores"
    assert fa.variant(dtype, d) == want
    assert want in fa.VARIANTS


@pytest.mark.parametrize("units,n_rows,max_keys,d,want", [
    (64, 128 * 4, 128, 128, 0),    # Qwen3 dense prefill: 256 CTAs of 128 rows, past a wave
    (64, 32 * 4, 640, 128, 2),     # Qwen3 paged chunk: one wave, 640 keys: the key split
    (8, 128 * 16, 128, 256, 1),    # RecurrentGemma prefill: 128 CTAs of 128 rows
    (8, 128 * 16, 2048, 256, 1),   # no key split at head_dim 256
    (132, 128, 64, 64, 1),         # exactly one wave
    (133, 128, 64, 64, 0),
    (1, 1, 1, 64, 1),
])
def test_flash_tensor_core_tile(units, n_rows, max_keys, d, want):
    assert fa.tensor_core_tile(units, n_rows, max_keys, d, H100_SMS) == want
    assert len(fa.TILES) == 3


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 128, 2), (torch.bfloat16, 256, 1), (torch.bfloat16, 64, 2),
    (torch.bfloat16, 32, fa.CUDA_CORES), (torch.float32, 128, fa.CUDA_CORES),
])
def test_flash_plan_sends_the_variant_to_the_kernel(dtype, d, want):
    """The launch's tile argument: the CUDA-core body where the dispatch
    table says so, else the tensor-core tile (the paged chunk's shape)."""
    assert fa.plan(dtype, 64, 32 * 4, 640, d, H100_SMS) == want
    if want != fa.CUDA_CORES:
        assert want == fa.tensor_core_tile(64, 32 * 4, 640, d, H100_SMS)


def test_flash_reset_clears_variant_counts():
    fa.launch_count_by_variant["tensor_cores"] = 3
    fa.reset_launch_count()
    assert fa.launch_count == 0 and set(fa.launch_count_by_variant.values()) == {0}
    assert set(fa.launch_count_by_variant) == set(fa.VARIANTS)


# --------------------------------------------------------------------------- #
# Kernel 3: body, split count, heads a CTA, shared scratch                    #
# --------------------------------------------------------------------------- #
DENSE_SHAPES = [
    # (dtype, B, H, KV, S, D)
    (torch.bfloat16, 8, 32, 8, 640, 128),     # Qwen3-8B dense decode round
    (torch.bfloat16, 8, 16, 1, 640, 256),     # RecurrentGemma-9B decode step (MQA ring)
    (torch.float32, 8, 16, 1, 640, 256),      # the same in float32
    (torch.float32, 4, 4, 2, 64, 16),         # the smoke model
    (torch.bfloat16, 1, 16, 1, 640, 256),     # one slot
    (torch.bfloat16, 0, 32, 8, 640, 128),     # no slot at all
    (torch.bfloat16, 8, 32, 8, 4096, 128),    # 4096 keys
    (torch.bfloat16, 2, 8, 8, 1, 64),         # one key a row
    (torch.bfloat16, 8, 64, 64, 640, 128),    # LLaMA-65B (MHA, g = 1)
    (torch.bfloat16, 8, 48, 8, 640, 128),     # Nemotron-4-15B, Mixtral-8x22B (g = 6)
    (torch.bfloat16, 8, 28, 4, 640, 128),     # Qwen2-VL-7B (g = 7)
    (torch.bfloat16, 8, 36, 4, 640, 128),     # StarCoder2-7B (g = 9)
    (torch.float32, 8, 36, 4, 640, 128),      # the same in float32: two head parts
]


@pytest.mark.parametrize("h,kv", [(48, 8), (28, 4), (36, 4)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dense_decode_plan_at_groups_that_are_not_powers_of_two(h, kv, dtype):
    """g = 6, 7 and 9 at head_dim 128: the tensor-core body holds the whole
    group in one CTA; the CUDA-core body rounds a CTA up to 8 heads, in one
    part for g = 6 and 7 and two for g = 9 (the second holding one head).
    The split scratch holds a (D + 2)-float partial for every head slot of
    every part: B x KV x parts x splits x group x (D + 2) floats and one
    ticket a (slot, KV head, part)."""
    from repro_torch.kernels import decode_attention as da

    b, s, d, g = 8, 640, 128, h // kv
    p = da.plan(dtype, b, h, kv, s, d, H100_SMS)
    sp = p.split
    if dtype == torch.bfloat16:
        assert p.body == da.TENSOR_CORES and (sp.group, sp.parts) == (g, 1)
    else:
        assert p.body == da.CUDA_CORES and sp.group == 8 and sp.parts == (1 if g <= 8 else 2)
    assert sp.group * sp.parts >= g > sp.group * (sp.parts - 1)
    floats, tickets = sp.scratch(b, kv, d)
    if sp.splits == 1:
        assert (floats, tickets) == (0, 0)
    else:
        assert floats == b * kv * sp.parts * sp.splits * sp.group * (d + 2)
        assert tickets == b * kv * sp.parts
    # forced split counts size the scratch the same way
    for n in (2, 5, 20):
        forced = pda.plan_with_splits(n, s, sp.group, sp.parts)
        assert forced.scratch(b, kv, d) == (b * kv * sp.parts * n * sp.group * (d + 2),
                                            b * kv * sp.parts)


@pytest.mark.parametrize("dtype,b,h,kv,s,d", DENSE_SHAPES)
def test_dense_decode_plan_bounds(dtype, b, h, kv, s, d):
    from repro_torch.kernels import decode_attention as da

    p = da.plan(dtype, b, h, kv, s, d, H100_SMS)
    tc = dtype == torch.bfloat16 and d in (64, 128, 256)
    assert p.body == (da.TENSOR_CORES if tc else da.CUDA_CORES)
    sp, g = p.split, h // kv
    tiles = -(-s // pda.SPLIT_TILE)
    assert 1 <= sp.splits <= max(1, tiles)
    assert sp.split_keys % pda.SPLIT_TILE == 0 and sp.split_keys * sp.splits >= s
    assert (sp.split_keys - pda.SPLIT_TILE) * sp.splits < max(1, s)
    if tc:
        assert (sp.group, sp.parts) == (g, 1)
    else:
        assert sp.group in (1, 2, 4, 8) and sp.group >= min(g, 8)
        assert sp.parts * sp.group >= g and (sp.parts - 1) * sp.group < g
    if tc:
        # no more splits than keep a split within what the ring holds in flight
        tiles = min(tiles, max(1, -(-s // da.TC_SPLIT_KEYS)))
        if sp.splits == tiles:
            assert sp.split_keys <= da.TC_SPLIT_KEYS
    if sp.splits < max(1, tiles):
        target = da.CTAS_PER_SM[p.body] * H100_SMS / max(1, b * kv * sp.parts)
        assert sp.splits == max(1, round(target))


def test_dense_decode_plan_mqa_holds_the_group_in_one_cta():
    """RecurrentGemma's 16 query heads on one KV head: one head part on the
    tensor-core body (each key read once), two parts of 8 on the CUDA cores
    (float32); Qwen3-8B's group of 4 in one CTA of the tensor-core body."""
    from repro_torch.kernels import decode_attention as da

    bf = da.plan(torch.bfloat16, 8, 16, 1, 640, 256, H100_SMS)
    f32 = da.plan(torch.float32, 8, 16, 1, 640, 256, H100_SMS)
    qwen = da.plan(torch.bfloat16, 8, 32, 8, 640, 128, H100_SMS)
    assert bf.body == da.TENSOR_CORES and (bf.split.group, bf.split.parts) == (16, 1)
    assert f32.body == da.CUDA_CORES and (f32.split.group, f32.split.parts) == (8, 2)
    assert qwen.body == da.TENSOR_CORES and (qwen.split.group, qwen.split.parts) == (4, 1)


def test_dense_decode_plan_reads_no_device_tensor(monkeypatch):
    """The plan takes a dtype and ints: it reads nothing off the device (no
    lengths) and gives the same plan whatever the caller's tensors hold."""
    from repro_torch.kernels import decode_attention as da

    def refuse(*args, **kwargs):
        raise AssertionError("the plan read a tensor")

    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    a = da.plan(torch.bfloat16, 8, 32, 8, 640, 128, H100_SMS)
    assert a == da.plan(torch.bfloat16, 8, 32, 8, 640, 128, H100_SMS)
    assert da.plan(torch.bfloat16, 8, 32, 8, 640, 128, 66).split.splits < a.split.splits


def test_dense_decode_scratch_unsplit_is_empty():
    from repro_torch.kernels import decode_attention as da

    p = da.Plan(da.TENSOR_CORES, pda.plan_with_splits(1, 640, 16, 1))
    assert p.split.scratch(8, 1, 256) == (0, 0)
    q = da.Plan(da.TENSOR_CORES, pda.plan_with_splits(20, 640, 16, 1))
    assert q.split.scratch(8, 1, 256) == (8 * 20 * 16 * 258, 8)


def test_workspace_shared_by_kernels_1_and_3_and_grown_once():
    """Kernel 1 and kernel 3 draw their split scratch from one workspace a
    device: the larger plan's scratch serves the smaller, and a plan that
    needs more replaces it once."""
    from repro_torch.kernels import decode_attention as da

    assert da.workspace is pda.workspace
    dev = torch.device("cpu")
    pda._workspaces.pop((dev.type, dev.index), None)
    k1 = pda.decode_plan(8, 32, 8, 40, 16, H100_SMS).scratch(8, 8, 128)
    k3 = da.plan(torch.bfloat16, 8, 16, 1, 640, 256, H100_SMS).split.scratch(8, 1, 256)
    small, large = sorted((k1, k3))
    f1, c1 = pda.workspace(dev, *small)
    f2, c2 = da.workspace(dev, *large)                 # grows once
    assert f2 is not f1 and f2.numel() == large[0] and c2.numel() == max(k1[1], k3[1])
    for need in (small, large, small):
        f, c = pda.workspace(dev, *need)
        assert f is f2 and c is c2
    pda._workspaces.pop((dev.type, dev.index), None)


# --------------------------------------------------------------------------- #
# The flash backward: body, tiles, grids, scratch, kernels                    #
# --------------------------------------------------------------------------- #
BF16, F32 = torch.bfloat16, torch.float32
# (B, H, KV, Sq, Sk, head_dim, dtype, causal, window): chip_smoke.py's
# TRAIN_KERNEL_CASES, then tests/test_torch_cuda.py's backward cases
BACKWARD_SHAPES = [
    (2, 32, 8, 2048, 2048, 128, BF16, True, 0),       # Qwen3-8B, the check's batch
    (1, 32, 8, 2048, 2048, 128, BF16, True, 0),       # Qwen3-8B, the train step's microbatch
    (2, 32, 8, 1024, 1024, 128, BF16, True, 256),     # a window of 256
    (1, 64, 64, 2048, 2048, 128, BF16, True, 0),      # LLaMA-65B's MHA
    (2, 4, 2, 64, 64, 16, F32, True, 0),              # float32 smoke
] + [
    (2, 2 * g, 2, s, s, d, dt, True, 0)
    for g in range(1, 17) for d, s in ((128, 150), (16, 70)) for dt in (BF16, F32)
] + [
    (2, 8, 2, 200, 200, d, dt, causal, w)
    for d in (16, 32, 64, 128) for causal, w in ((True, 0), (True, 64), (True, 1), (False, 0), (False, 40))
    for dt in (BF16, F32)
] + [(2, 8, 2, sq, sk, 128, dt, True, 0) for sq, sk in ((100, 160), (160, 100)) for dt in (BF16, F32)
] + [
    # RecurrentGemma-9B's attention (16 query heads on one KV head, head_dim
    # 256, window 2048) at its training shape, and cross-attention shapes
    (1, 16, 1, 4096, 4096, 256, BF16, True, 2048),
    (2, 16, 1, 300, 300, 256, F32, True, 100),
    (2, 12, 12, 70, 1500, 64, BF16, False, 0),
    (2, 4, 4, 37, 90, 256, BF16, False, 0),
]


def _key_tiles_of_query_tile(i0, sq, sk, causal, window, rows=64):
    """Key tiles the dQ pass runs for the query tile at ``i0`` (its bounds)."""
    hi = min(sk, min(sq, i0 + rows)) if causal else sk
    lo = max(0, i0 - window + 1) // rows * rows if window > 0 else 0
    return -(-(hi - lo) // rows) if hi > lo else 0


@pytest.mark.parametrize("b,h,kv,sq,sk,d,dtype,causal,window", BACKWARD_SHAPES)
def test_backward_plan(b, h, kv, sq, sk, d, dtype, causal, window):
    """Body by the dispatch table, the kernels in launch order, grids that
    cover every query and key tile, heaviest tiles first under a causal
    mask, and the scratch the wrapper allocates."""
    p = fb.backward_plan(b, h, kv, sq, sk, d, dtype, causal=causal, window=window, n_sms=H100_SMS)
    assert p.body == fb.variant(dtype, d) and p.body in fb.VARIANTS
    wgmma = p.body == "tensor_cores"
    assert (p.rows, p.cols) == ((64, 64) if wgmma else (64, 32))
    if wgmma:
        pair = "_d256" if d == 256 else ""                      # two warpgroups a CTA at 256
        want = (f"flash_bwd_dq_wgmma{pair}_kernel", f"flash_bwd_dkv_wgmma{pair}_kernel")
        want += ("flash_bwd_dkv_sum_kernel",) if p.split_group else ()
        assert p.subgroups in fb.subgroup_counts(h // kv, d) and p.split_group is (p.subgroups > 1)
        assert p.grids[0][:2] == (h, b) and p.grids[1][:2] == (kv * p.subgroups, b)
    else:
        want = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
        x = b * fb.column_chunks(p.body, d)                     # two CTAs a row tile at 256
        assert not p.split_group and p.grids[0][:2] == (x, h) and p.grids[1][:2] == (x, kv)
    assert p.kernels == want and len(p.grids) == len(want)
    for (_, _, z), n in ((p.grids[0], sq), (p.grids[1], sk)):
        assert (z - 1) * p.rows < n <= z * p.rows              # every tile, none past the end
    if p.split_group:
        assert p.grids[2][0] * 256 >= b * kv * sk * d // 8 and p.grids[2][1:] == (1, 1)
    assert p.scratch_bytes == b * h * sq * 4 + (2 * b * kv * p.subgroups * sk * d * 4 if p.split_group else 0)
    if wgmma and causal:
        nq, nk = p.grids[0][2], p.grids[1][2]
        dq_work = [_key_tiles_of_query_tile(64 * fb.tile_in_launch_order(p.kernels[0], z, nq, True),
                                            sq, sk, causal, window) for z in range(nq)]
        dkv_work = [fb.query_tiles(64 * fb.tile_in_launch_order(p.kernels[1], z, nk, True),
                                   sq, sk, causal, window) for z in range(nk)]
        assert dq_work == sorted(dq_work, reverse=True) and dkv_work == sorted(dkv_work, reverse=True)
        assert sorted(fb.tile_in_launch_order(p.kernels[0], z, nq, True) for z in range(nq)) == list(range(nq))


@pytest.mark.parametrize("b,h,kv,sq,d,window,split", [
    (2, 32, 8, 2048, 128, 0, False),    # Qwen3-8B at B 2: 512 CTAs already balance the tail
    (1, 32, 8, 2048, 128, 0, True),     # the train step's B 1: the first key tiles' CTAs would rule
    (2, 32, 8, 1024, 128, 256, False),  # a window: every CTA's work is about the same
    (1, 64, 64, 2048, 128, 0, False),   # MHA: no group to split
    (2, 32, 2, 150, 128, 0, True),      # g = 16 on a small grid
])
def test_backward_plan_splits_the_group_where_the_tail_would_rule(b, h, kv, sq, d, window, split):
    assert fb.split_group(b, h, kv, sq, sq, d, True, window, H100_SMS) == (h // kv if split else 1)
    p = fb.backward_plan(b, h, kv, sq, sq, d, BF16, window=window, n_sms=H100_SMS)
    assert p.split_group is split
    other = 1 if split else h // kv
    forced = fb.backward_plan(b, h, kv, sq, sq, d, BF16, window=window, n_sms=H100_SMS, subgroups=other)
    assert forced.subgroups == other and forced.split_group is (other > 1)
    assert len(forced.kernels) == 2 + forced.split_group


@pytest.mark.parametrize("b,sq,sk", [(0, 64, 64), (2, 0, 64), (2, 64, 0), (2, 0, 0)])
def test_backward_plan_launches_nothing_for_an_empty_pass(b, sq, sk):
    p = fb.backward_plan(b, 8, 2, sq, sk, 128, BF16, n_sms=H100_SMS, subgroups=4)
    assert len(p.kernels) == len(p.grids) == (b > 0) * ((sq > 0) + 2 * (sk > 0))


# (B, H, KV, Sq, Sk, causal, window) -> (sub-groups, grids, scratch bytes) of
# the bf16 head_dim 256 plan: RecurrentGemma-9B's training shape, a window
# without causal, ragged S, Sq != Sk both ways, and a batch that fills the
# card unsplit
HEAD_DIM_256_PLANS = [
    ((1, 16, 1, 4096, 4096, True, 2048), 8, ((16, 1, 64), (8, 1, 64), (512, 1, 1)), 67371008),
    ((2, 16, 1, 300, 300, True, 100), 16, ((16, 2, 5), (16, 2, 5), (75, 1, 1)), 19699200),
    ((1, 16, 1, 4096, 4096, True, 0), 4, ((16, 1, 64), (4, 1, 64), (512, 1, 1)), 33816576),
    ((2, 2, 1, 100, 160, True, 0), 2, ((2, 2, 2), (2, 2, 3), (40, 1, 1)), 1312320),
    ((2, 4, 4, 37, 90, False, 0), 1, ((4, 2, 1), (4, 2, 2)), 1184),
    ((8, 16, 1, 4096, 4096, True, 2048), 1, ((16, 8, 64), (1, 8, 64)), 2097152),
]


@pytest.mark.parametrize("shape,subgroups,grids,scratch", HEAD_DIM_256_PLANS)
def test_backward_plan_at_head_dim_256(shape, subgroups, grids, scratch):
    """bf16 at head_dim 256 runs the two-warpgroup wgmma body: the kernels in
    order, their grids (the dK/dV pass over KV x sub-groups CTAs), the
    sub-group count ``split_group`` picks and the scratch (Delta, and the
    float32 partials of dK and dV where split). At RecurrentGemma-9B's
    training shape the group of 16 goes to 8 sub-groups: 512 CTAs where the
    unsplit grid has 64 for 132 SMs."""
    b, h, kv, sq, sk, causal, window = shape
    p = fb.backward_plan(b, h, kv, sq, sk, 256, BF16, causal=causal, window=window, n_sms=H100_SMS)
    assert p.body == "tensor_cores" and (p.rows, p.cols) == (64, 64)
    assert p.subgroups == subgroups and p.split_group is (subgroups > 1)
    assert fb.split_group(b, h, kv, sq, sk, 256, causal, window, H100_SMS) == subgroups
    want = ("flash_bwd_dq_wgmma_d256_kernel", "flash_bwd_dkv_wgmma_d256_kernel")
    assert p.kernels == want + (("flash_bwd_dkv_sum_kernel",) if subgroups > 1 else ())
    assert p.grids == grids and p.scratch_bytes == scratch
    # the pass the count was picked for is within the slack of every other count's
    tiles = [fb.query_tiles(t0, sq, sk, causal, window) for t0 in range(0, sk, 64)]
    length = {n: fb.dkv_pass_length(b, kv, h // kv, n, tiles, H100_SMS)
              for n in fb.subgroup_counts(h // kv, 256)}
    assert length[subgroups] <= fb._SPLIT_SLACK * min(length.values())
    assert all(length[n] > fb._SPLIT_SLACK * min(length.values()) for n in length if n < subgroups)


@pytest.mark.parametrize("g,counts", [(1, (1,)), (2, (1, 2)), (9, (1, 3, 9)), (16, (1, 2, 4, 8, 16))])
def test_subgroup_counts_by_head_dim(g, counts):
    """Any divisor of the group at 256; the group whole or one head a CTA
    at 64 and 128; forcing a count the kernel does not take is refused."""
    assert fb.subgroup_counts(g, 256) == counts
    assert fb.subgroup_counts(g, 128) == fb.subgroup_counts(g, 64) == ((1, g) if g > 1 else (1,))
    for n in counts:
        assert fb.backward_plan(2, g, 1, 128, 128, 256, BF16, subgroups=n).subgroups == n
    if g > 2:
        with pytest.raises(ValueError, match="sub-groups"):
            fb.backward_plan(2, g, 1, 128, 128, 128, BF16, subgroups=counts[1])


def test_dkv_pass_length_hands_ctas_to_the_first_free_slot():
    """Two slots, CTAs of work 3, 3, 2, 1 in launch order: 3 | 3, then 2
    and 1 on the slots freed at 3: the pass takes 5; one CTA alone, its
    work; no CTA, 0."""
    assert fb.dkv_pass_length(1, 1, 2, 2, [3, 1], 2) == 4
    assert fb.dkv_pass_length(1, 1, 1, 1, [3, 3, 2, 1], 2) == 5
    assert fb.dkv_pass_length(1, 1, 4, 1, [5], 132) == 20
    assert fb.dkv_pass_length(1, 1, 4, 1, [], 132) == 0


# (B, H, KV, Sq, Sk, head_dim, causal, window) -> (split, kernels, grids,
# scratch) as the 64 / 128 plans were before the head_dim 256 body: Qwen3-8B
# at B 2 and B 1, a window, LLaMA-65B's MHA, Whisper-small's encoder and
# decoder at its training shape, Sq != Sk, a window at head_dim 64
_DQ, _DKV, _SUM = "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_sum_kernel"
PLANS_AT_64_AND_128 = [
    ((2, 32, 8, 2048, 2048, 128, True, 0), False, (_DQ, _DKV), ((32, 2, 32), (8, 2, 32)), 524288),
    ((1, 32, 8, 2048, 2048, 128, True, 0), True, (_DQ, _DKV, _SUM),
     ((32, 1, 32), (32, 1, 32), (1024, 1, 1)), 67371008),
    ((2, 32, 8, 1024, 1024, 128, True, 256), False, (_DQ, _DKV), ((32, 2, 16), (8, 2, 16)), 262144),
    ((1, 64, 64, 2048, 2048, 128, True, 0), False, (_DQ, _DKV), ((64, 1, 32), (64, 1, 32)), 524288),
    ((2, 12, 12, 256, 256, 64, False, 0), False, (_DQ, _DKV), ((12, 2, 4), (12, 2, 4)), 24576),
    ((8, 12, 12, 256, 256, 64, True, 0), False, (_DQ, _DKV), ((12, 8, 4), (12, 8, 4)), 98304),
    ((2, 8, 2, 100, 160, 128, True, 0), True, (_DQ, _DKV, _SUM), ((8, 2, 2), (8, 2, 3), (40, 1, 1)), 2627840),
    ((1, 16, 4, 300, 300, 64, True, 64), False, (_DQ, _DKV), ((16, 1, 5), (4, 1, 5)), 19200),
]


@pytest.mark.parametrize("shape,split,kernels,grids,scratch", PLANS_AT_64_AND_128)
def test_backward_plans_at_64_and_128_are_unchanged(shape, split, kernels, grids, scratch):
    """The bf16 plans at head_dim 64 and 128 are what they were before the
    sub-group count: split or not by the same rule, one query head a CTA
    where split, the same grids and scratch."""
    b, h, kv, sq, sk, d, causal, window = shape
    p = fb.backward_plan(b, h, kv, sq, sk, d, BF16, causal=causal, window=window, n_sms=H100_SMS)
    assert (p.body, p.split_group, p.kernels, p.grids, p.scratch_bytes) == (
        "tensor_cores", split, kernels, grids, scratch)
    assert p.subgroups == (h // kv if split else 1)
