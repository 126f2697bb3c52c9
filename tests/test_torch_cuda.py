"""The hand-written CUDA kernels on the card, each held against its plain
PyTorch version on the same CUDA inputs (float32 2e-5, bf16 2e-2).

This file imports neither JAX nor the reference package, so it runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test is marked ``cuda`` and skips where there is no CUDA device."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels.decode_split import cta_group, plan_with_splits
from torch_port_arrays import shuffled_tables

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
pytestmark = pytest.mark.cuda


def _tol(dtype):
    return 2e-5 if dtype == "float32" else 2e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_decode_matches_plain(card, d, dtype):
    rng = np.random.default_rng(d)
    b, h, kv, p, bs, mb = 8, 32, 8, 400, 16, 40
    lengths = rng.integers(1, mb * bs + 1, size=b).astype(np.int32)
    lengths[-1] = 0                                   # an idle lane
    tables = torch.from_numpy(shuffled_tables(rng, b, mb, p, bs, lengths)).cuda()
    q = torch.randn(b, 1, h, d, device="cuda").to(TDT[dtype])
    k = torch.randn(kv, p, bs, d, device="cuda").to(TDT[dtype])
    v = torch.randn(kv, p, bs, d, device="cuda").to(TDT[dtype])
    lens = torch.from_numpy(lengths).cuda()
    out = pda.paged_decode_attention(q, k, v, tables, lens)
    torch.cuda.synchronize()
    ref = pda.paged_decode_attention_plain(q, k, v, tables, lens)
    torch.testing.assert_close(out.float(), ref.float(), rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_dense_and_paged_match_plain(card, dtype):
    rng = np.random.default_rng(5)
    for b, h, kv, s, d, causal, w in [(2, 4, 2, 256, 64, True, 0), (1, 4, 4, 128, 128, True, 32),
                                      (2, 2, 1, 96, 16, False, 0)]:
        q = torch.randn(b, h, s, d, device="cuda").to(TDT[dtype])
        k = torch.randn(b, kv, s, d, device="cuda").to(TDT[dtype])
        v = torch.randn(b, kv, s, d, device="cuda").to(TDT[dtype])
        out = fa.flash_attention(q, k, v, causal=causal, window=w)
        ref = fa.flash_attention_plain(q, k, v, causal=causal, window=w)
        torch.testing.assert_close(out.float(), ref.float(), rtol=_tol(dtype), atol=_tol(dtype))
    # the paged chunk entry: rows at ragged offsets, a pad row reading the
    # last row's table
    r, c, h, kv, d, p, bs, mb = 4, 8, 4, 2, 16, 20, 4, 10
    starts = np.array([0, 5, 13, 0], np.int32)
    valid = starts + np.array([8, 3, 7, 0], np.int32)
    tables = shuffled_tables(rng, r - 1, mb, p, bs, valid[:-1])
    tables = np.concatenate([tables, tables[-1:]])
    args = [torch.randn(*shape, device="cuda").to(TDT[dtype])
            for shape in ((r, c, h, d), (kv, p, bs, d), (kv, p, bs, d))]
    args += [torch.from_numpy(x).cuda() for x in (tables, starts, valid)]
    out = fa.paged_chunk_attention(*args)
    ref = fa.paged_chunk_attention_plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=_tol(dtype), atol=_tol(dtype))


def test_cuda_flash_dense_on_strided_bshk_views(card):
    """What the dense prefill passes: (B, S, H, D) tensors seen as
    (B, H, S, D); the output keeps q's strides, so its transpose back to
    bshk is contiguous."""
    b, s, h, kv, d = 2, 96, 8, 2, 128
    q = torch.randn(b, s, h, d, device="cuda").bfloat16().transpose(1, 2)
    k = torch.randn(b, s, kv, d, device="cuda").bfloat16().transpose(1, 2)
    v = torch.randn(b, s, kv, d, device="cuda").bfloat16().transpose(1, 2)
    out = fa.flash_attention(q, k, v, causal=True, window=24)
    assert out.transpose(1, 2).is_contiguous()
    ref = fa.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                                   window=24)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("h,kv,d", [(32, 8, 128), (4, 2, 16), (8, 2, 64), (8, 1, 64), (4, 4, 128),
                                    (8, 4, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_matches_plain(card, h, kv, d, dtype):
    """Kernel 3 over the (B, S, KV, D) cache view, ragged lengths with an
    idle lane (length 0 → 0) and lengths on and off the warp-step edges."""
    b, s = 8, 640
    g = torch.Generator(device="cuda").manual_seed(d + h)
    q = torch.randn(b, h, d, device="cuda", generator=g).to(TDT[dtype])
    k = torch.randn(b, s, kv, d, device="cuda", generator=g).to(TDT[dtype]).transpose(1, 2)
    v = torch.randn(b, s, kv, d, device="cuda", generator=g).to(TDT[dtype]).transpose(1, 2)
    lengths = torch.tensor([1, 17, 330, 640, 0, 255, 256, 513], dtype=torch.int32, device="cuda")
    da.reset_launch_count()
    out = da.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert da.launch_count == 1
    ref = da.decode_attention_plain(q, k, v, lengths)
    torch.testing.assert_close(out.float(), ref.float(), rtol=_tol(dtype), atol=_tol(dtype))
    assert torch.equal(out[4], torch.zeros_like(out[4]))


@pytest.mark.parametrize("b,s,r", [(8, 128, 4096), (2, 512, 256), (1, 256, 128), (3, 128, 384),
                                   (8, 1, 4096), (2, 13, 100)])
def test_cuda_rglru_matches_plain(card, b, s, r):
    """Kernel 4 at the recurrentgemma prefill shape, the reference's test
    cases (tests/test_kernels.py:161), one decode token and a ragged S and R;
    the kernel fuses each step's multiply-add and the plain version does
    not, so the two differ by about one ulp a step, well under 1e-5."""
    from repro_torch.kernels import rglru

    g = torch.Generator(device="cuda").manual_seed(b * s + r)
    a = torch.sigmoid(torch.randn(b, s, r, device="cuda", generator=g))
    x = torch.randn(b, s, r, device="cuda", generator=g)
    h0 = torch.randn(b, r, device="cuda", generator=g)
    rglru.reset_launch_count()
    out, hf = rglru.rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert rglru.launch_count == 1
    ref, ref_hf = rglru.rglru_scan_plain(a, x, h0)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hf, ref_hf, rtol=1e-5, atol=1e-5)


def test_cuda_rglru_state_chains_across_calls(card):
    """The final state of one call seeds the next (tests/test_kernels.py:177)."""
    from repro_torch.kernels import rglru

    g = torch.Generator(device="cuda").manual_seed(7)
    a = torch.sigmoid(torch.randn(1, 256, 128, device="cuda", generator=g))
    x = torch.randn(1, 256, 128, device="cuda", generator=g)
    full, hf_full = rglru.rglru_scan(a, x)
    _, hf1 = rglru.rglru_scan(a[:, :128], x[:, :128])
    h2, hf2 = rglru.rglru_scan(a[:, 128:], x[:, 128:], hf1)
    torch.testing.assert_close(h2, full[:, 128:], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hf2, hf_full, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_mqa_head_dim_256_matches_plain(card, dtype):
    """Kernel 3 at recurrentgemma's decode shape: 16 query heads on one KV
    head (in bf16 one CTA holds the whole group; in float32 two head parts
    of 8), head_dim 256, ragged lengths with an idle lane."""
    b, h, kv, d, s = 8, 16, 1, 256, 640
    g = torch.Generator(device="cuda").manual_seed(256)
    q = torch.randn(b, h, d, device="cuda", generator=g).to(TDT[dtype])
    k = torch.randn(b, s, kv, d, device="cuda", generator=g).to(TDT[dtype]).transpose(1, 2)
    v = torch.randn(b, s, kv, d, device="cuda", generator=g).to(TDT[dtype]).transpose(1, 2)
    lengths = torch.tensor([1, 31, 330, 640, 0, 129, 256, 513], dtype=torch.int32, device="cuda")
    out = da.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    ref = da.decode_attention_plain(q, k, v, lengths)
    torch.testing.assert_close(out.float(), ref.float(), rtol=_tol(dtype), atol=_tol(dtype))
    assert torch.equal(out[4], torch.zeros_like(out[4]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_dense_head_dim_256_matches_plain(card, dtype):
    """Kernel 2's dense entry at recurrentgemma's prefill shape (16 query
    heads, one KV head, head_dim 256) on bshk views, causal with the model's
    window and with a window shorter than the prompt."""
    b, s, h, kv, d = 8, 128, 16, 1, 256
    g = torch.Generator(device="cuda").manual_seed(128)
    q, k, v = (torch.randn(b, s, n, d, device="cuda", generator=g).to(TDT[dtype]).transpose(1, 2)
               for n in (h, kv, kv))
    for window in (2048, 48):
        out = fa.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, causal=True, window=window)
        torch.testing.assert_close(out.float(), ref.float(), rtol=_tol(dtype), atol=_tol(dtype))


def _bshk(b, s, n, d, dtype, g):
    """(B, S, N, D) made contiguous, seen as (B, N, S, D) as the dense
    prefill passes it."""
    return torch.randn(b, s, n, d, device="cuda", generator=g).to(TDT[dtype]).transpose(1, 2)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2), (16, 1)])
def test_cuda_flash_tensor_core_variants(card, d, h, kv):
    """The bf16 tensor-core body at g = 1, 4 and 16: causal, windowed and
    non-causal, with Sq = 96 (not a multiple of the 64- or 128-row tile),
    on strided bshk views; every launch is counted as the tensor-core one."""
    g = torch.Generator(device="cuda").manual_seed(d + h)
    b, s = 2, 96
    q, k, v = (_bshk(b, s, n, d, "bfloat16", g) for n in (h, kv, kv))
    fa.reset_launch_count()
    for causal, window in ((True, 0), (True, 40), (False, 0)):
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
        assert out.transpose(1, 2).is_contiguous()
    assert fa.launch_count_by_variant == {"cuda_cores": 0, "tensor_cores": 3}


@pytest.mark.parametrize("tile", [0, 1, 2])
def test_cuda_flash_tensor_core_tiles(card, tile):
    """Every CTA tile of the tensor-core body (64 rows, 128 rows, 64 rows
    with the keys split between two warpgroups) on the dense and the paged
    entry, whichever the plan would pick."""
    g = torch.Generator(device="cuda").manual_seed(tile)
    q, k, v = (_bshk(2, 160, n, 128, "bfloat16", g) for n in (8, 2, 2))
    out = fa._launch_dense(q, k, v, True, 0, 128 ** -0.5, tile)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    rng = np.random.default_rng(tile)
    r, c, h, kv, d, p, bs, mb = 4, 32, 8, 2, 128, 64, 16, 12
    starts = np.array([0, 64, 150, 0], np.int32)
    valid = starts + np.array([32, 32, 9, 0], np.int32)
    tables = shuffled_tables(rng, r - 1, mb, p, bs, valid[:-1])
    tables = np.concatenate([tables, tables[-1:]])
    args = [torch.randn(*shape, device="cuda", generator=g).bfloat16()
            for shape in ((r, c, h, d), (kv, p, bs, d), (kv, p, bs, d))]
    args += [torch.from_numpy(x).cuda() for x in (tables, starts, valid)]
    out = fa._launch_paged(*args, d ** -0.5, tile)
    torch.cuda.synchronize()
    ref = fa.paged_chunk_attention_plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    assert torch.equal(out[-1], torch.zeros_like(out[-1]))


def test_cuda_flash_paged_chunk_at_serving_shape(card):
    """The paged chunk entry at Qwen3's shape (8 rows x 32, 32/8 heads,
    head_dim 128) over shuffled pages with -1 entries past each row and a
    pad row that reads the last row's table; run twice, bit-identical."""
    rng = np.random.default_rng(11)
    r, c, h, kv, d, bs, mb = 8, 32, 32, 8, 128, 16, 40
    p = r * mb
    starts = (rng.integers(0, (mb * bs - c) // c + 1, size=r) * c).astype(np.int32)
    lens = rng.integers(1, c + 1, size=r).astype(np.int32)
    starts[-1], lens[-1] = 0, 0
    valid = starts + lens
    tables = shuffled_tables(rng, r - 1, mb, p, bs, valid[:-1])
    tables = np.concatenate([tables, tables[-1:]])
    g = torch.Generator(device="cuda").manual_seed(11)
    args = [torch.randn(*shape, device="cuda", generator=g).bfloat16()
            for shape in ((r, c, h, d), (kv, p, bs, d), (kv, p, bs, d))]
    args += [torch.from_numpy(x).cuda() for x in (tables, starts, valid)]
    fa.reset_launch_count()
    out = fa.paged_chunk_attention(*args)
    again = fa.paged_chunk_attention(*args)
    torch.cuda.synchronize()
    assert fa.launch_count_by_variant["tensor_cores"] == 2
    assert torch.equal(out, again)
    ref = fa.paged_chunk_attention_plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    assert torch.equal(out[-1], torch.zeros_like(out[-1]))


@pytest.mark.parametrize("h,kv,d", [(32, 8, 128), (16, 1, 64), (12, 4, 32), (4, 2, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_decode_many_splits(card, h, kv, d, dtype):
    """Kernel 1 over 2048 keys a slot (many splits), lengths 0, 1, on and
    one past a split boundary, and the full row; one launch a call, and two
    calls give bit-identical outputs (tickets reset, merge order fixed)."""
    rng = np.random.default_rng(h * d)
    b, bs, mb = 8, 16, 128
    plan = pda.decode_plan(b, h, kv, mb, bs, torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.splits > 1
    per = plan.split_keys
    lengths = np.array([0, 1, per, per + 1, 2 * per, mb * bs, 777, 31], np.int32)
    p = int(sum(-(-int(x) // bs) for x in lengths)) + 4
    tables = torch.from_numpy(shuffled_tables(rng, b, mb, p, bs, lengths)).cuda()
    g = torch.Generator(device="cuda").manual_seed(h * d)
    q = torch.randn(b, 1, h, d, device="cuda", generator=g).to(TDT[dtype])
    k = torch.randn(kv, p, bs, d, device="cuda", generator=g).to(TDT[dtype])
    v = torch.randn(kv, p, bs, d, device="cuda", generator=g).to(TDT[dtype])
    lens = torch.from_numpy(lengths).cuda()
    pda.reset_launch_count()
    out = pda.paged_decode_attention(q, k, v, tables, lens)
    again = pda.paged_decode_attention(q, k, v, tables, lens)
    torch.cuda.synchronize()
    assert pda.launch_count == 2
    assert torch.equal(out, again)
    ref = pda.paged_decode_attention_plain(q, k, v, tables, lens)
    torch.testing.assert_close(out.float(), ref.float(), rtol=_tol(dtype), atol=_tol(dtype))
    assert torch.equal(out[0], torch.zeros_like(out[0]))


@pytest.mark.parametrize("splits", [1, 3, 9, 20])
def test_cuda_paged_decode_lengths_past_the_table(card, splits):
    """Lengths beyond the block table's MB x page_size keys: the kernel, at
    split counts whose last splits start past the table, drops the keys past
    it as the plain version does."""
    rng = np.random.default_rng(splits)
    b, h, kv, d, bs, mb = 4, 8, 2, 64, 16, 40
    lengths = np.array([mb * bs + 1, 1000, 0, 300], np.int32)
    p = b * mb
    tables = torch.from_numpy(shuffled_tables(rng, b, mb, p, bs, np.minimum(lengths, mb * bs))).cuda()
    g = torch.Generator(device="cuda").manual_seed(splits)
    q = torch.randn(b, 1, h, d, device="cuda", generator=g).bfloat16()
    k = torch.randn(kv, p, bs, d, device="cuda", generator=g).bfloat16()
    v = torch.randn(kv, p, bs, d, device="cuda", generator=g).bfloat16()
    lens = torch.from_numpy(lengths).cuda()
    plan = pda.plan_with_splits(splits, mb * bs, 4, 1)
    out = pda._launch(q, k, v, tables, lens, d ** -0.5, plan)
    torch.cuda.synchronize()
    ref = pda.paged_decode_attention_plain(q, k, v, tables, lens)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    assert torch.equal(out[2], torch.zeros_like(out[2]))


def test_cuda_flash_dense_repeats_bit_identical(card):
    """Kernel 2's dense entry at RecurrentGemma's shape, twice: the same bits."""
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (_bshk(8, 128, n, 256, "bfloat16", g) for n in (16, 1, 1))
    a = fa.flash_attention(q, k, v, causal=True, window=2048)
    b = fa.flash_attention(q, k, v, causal=True, window=2048)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("splits", ["one", "plan", "most"])
@pytest.mark.parametrize("dtype,body", [("float32", da.CUDA_CORES), ("bfloat16", da.TENSOR_CORES)])
@pytest.mark.parametrize("h,kv,d", [(32, 8, 128), (16, 1, 256)])
def test_cuda_decode_split_counts(card, h, kv, d, dtype, body, splits):
    """Kernel 3 at both serving shapes (Qwen3-8B's dense decode round,
    RecurrentGemma-9B's MQA ring) on the body of each dtype, unsplit, at the
    plan's split count and at the most splits (one 32-key tile each):
    lengths 0 (an idle lane, which gives 0), 1, on and one past a split's
    keys, on either side of 1.5 splits (where a row first takes two), twice
    a split less one, the whole cache and past it; one launch a call, and
    two calls give the same bits (tickets reset, merge order fixed)."""
    b, s = 10, 640
    g = h // kv
    group, parts = (g, 1) if body == da.TENSOR_CORES else cta_group(g)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = {"one": 1, "most": s // 32,
         "plan": da.plan(TDT[dtype], b, h, kv, s, d, n_sms).split.splits}[splits]
    plan = da.Plan(body, plan_with_splits(n, s, group, parts))
    per = plan.split.split_keys
    two = -(-3 * per // 2)                 # the shortest row that takes two splits
    lengths = [min(x, s) for x in (0, 1, per, per + 1, two - 1, two, 2 * per - 1, s)] + [s + 100, 257]
    gen = torch.Generator(device="cuda").manual_seed(h * d + n)
    q = torch.randn(b, h, d, device="cuda", generator=gen).to(TDT[dtype])
    k = torch.randn(b, s, kv, d, device="cuda", generator=gen).to(TDT[dtype]).transpose(1, 2)
    v = torch.randn(b, s, kv, d, device="cuda", generator=gen).to(TDT[dtype]).transpose(1, 2)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    da.reset_launch_count()
    out = da._launch(q, k, v, lens, d ** -0.5, plan)
    torch.cuda.synchronize()
    assert da.launch_count == 1
    again = da._launch(q, k, v, lens, d ** -0.5, plan)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref = da.decode_attention_plain(q, k, v, lens)
    torch.testing.assert_close(out.float(), ref.float(), rtol=_tol(dtype), atol=_tol(dtype))
    assert torch.equal(out[0], torch.zeros_like(out[0]))


@pytest.mark.parametrize("kernel", ["dense", "paged"])
def test_cuda_decode_with_no_slot(card, kernel):
    """Kernels 1 and 3 with B = 0 (the plan splits, but no scratch is
    needed): an empty output, no error."""
    h, kv, d = 32, 8, 128
    lens = torch.zeros(0, dtype=torch.int32, device="cuda")
    if kernel == "dense":
        q = torch.zeros(0, h, d, device="cuda", dtype=torch.bfloat16)
        k = torch.zeros(0, 640, kv, d, device="cuda", dtype=torch.bfloat16).transpose(1, 2)
        out = da.decode_attention(q, k, k, lens)
    else:
        q = torch.zeros(0, 1, h, d, device="cuda", dtype=torch.bfloat16)
        k = torch.zeros(kv, 8, 16, d, device="cuda", dtype=torch.bfloat16)
        tables = torch.zeros(0, 40, dtype=torch.int32, device="cuda")
        out = pda.paged_decode_attention(q, k, k, tables, lens)
    torch.cuda.synchronize()
    assert out.shape == q.shape


def test_cuda_decode_bf16_cuda_cores_only_at_head_dim_16(card):
    """bf16 takes the CUDA-core body only at head_dim 16: a plan that sends
    bf16 at head_dim 128 there is refused by the launcher, not run."""
    q = torch.zeros(2, 8, 128, device="cuda", dtype=torch.bfloat16)
    k = torch.zeros(2, 64, 2, 128, device="cuda", dtype=torch.bfloat16).transpose(1, 2)
    lens = torch.full((2,), 64, dtype=torch.int32, device="cuda")
    plan = da.Plan(da.CUDA_CORES, plan_with_splits(1, 64, *cta_group(4)))
    with pytest.raises(RuntimeError, match="launch failed"):
        da._launch(q, k, k, lens, 128 ** -0.5, plan)


def test_cuda_decode_plan_at_the_serving_shapes(card):
    """The wrapper's plan at both serving shapes in bf16, on this card: the
    tensor-core body with the whole group in one CTA, more than one split."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for h, kv, d in ((32, 8, 128), (16, 1, 256)):
        p = da.plan(torch.bfloat16, 8, h, kv, 640, d, n_sms)
        assert p.body == da.TENSOR_CORES and p.split.parts == 1 and p.split.splits > 1


# --------------------------------------------------------------------------- #
# Every GQA group of up to 16 (the decoders' (H, KV) at head_dim 128)         #
# --------------------------------------------------------------------------- #
# g = 6 (Nemotron-4-15B, Mixtral-8x22B), 7 (Qwen2-VL-7B), 9 (StarCoder2-7B),
# 1 (LLaMA-65B, OLMoE-1B-7B), and every other g from 1 to 16 on 16 query heads
# or fewer
GROUPS = [(48, 8), (28, 4), (36, 4), (64, 64), (16, 16)] + [(g, 1) for g in (3, 5, 10, 11, 12, 13, 14, 15)]


@pytest.mark.parametrize("splits", ["one", "plan", "most"])
@pytest.mark.parametrize("dtype,body", [("float32", da.CUDA_CORES), ("bfloat16", da.TENSOR_CORES)])
@pytest.mark.parametrize("h,kv", GROUPS)
def test_cuda_decode_any_group(card, h, kv, dtype, body, splits):
    """Kernel 3 at groups that are not powers of two (the CUDA-core body
    rounds a CTA's heads up to 8 and, at g = 9 to 15, runs a second part of
    1 to 7 heads; the tensor-core body holds the whole group of up to 16
    rows), unsplit, at the plan's split count and at the most splits;
    through the wrapper as well; ragged lengths with an idle lane."""
    b, s, d = 6, 640, 128
    g = h // kv
    group, parts = (g, 1) if body == da.TENSOR_CORES else cta_group(g)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = {"one": 1, "most": s // 32,
         "plan": da.plan(TDT[dtype], b, h, kv, s, d, n_sms).split.splits}[splits]
    plan = da.Plan(body, plan_with_splits(n, s, group, parts))
    gen = torch.Generator(device="cuda").manual_seed(h * kv + n)
    q = torch.randn(b, h, d, device="cuda", generator=gen).to(TDT[dtype])
    k = torch.randn(b, s, kv, d, device="cuda", generator=gen).to(TDT[dtype]).transpose(1, 2)
    v = torch.randn(b, s, kv, d, device="cuda", generator=gen).to(TDT[dtype]).transpose(1, 2)
    lens = torch.tensor([0, 1, 95, 330, 640, 513], dtype=torch.int32, device="cuda")
    out = da._launch(q, k, v, lens, d ** -0.5, plan)
    wrapped = da.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    ref = da.decode_attention_plain(q, k, v, lens)
    for x in (out, wrapped):
        torch.testing.assert_close(x.float(), ref.float(), rtol=_tol(dtype), atol=_tol(dtype))
        assert torch.equal(x[0], torch.zeros_like(x[0]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv", GROUPS)
def test_cuda_paged_decode_any_group(card, h, kv, dtype):
    """Kernel 1 at the same groups over shuffled pages, an idle lane."""
    rng = np.random.default_rng(h * kv)
    b, d, bs, mb = 6, 128, 16, 40
    lengths = np.array([0, 1, 95, 330, 640, 513], np.int32)
    p = b * mb
    tables = torch.from_numpy(shuffled_tables(rng, b, mb, p, bs, lengths)).cuda()
    g = torch.Generator(device="cuda").manual_seed(h * kv)
    q = torch.randn(b, 1, h, d, device="cuda", generator=g).to(TDT[dtype])
    k = torch.randn(kv, p, bs, d, device="cuda", generator=g).to(TDT[dtype])
    v = torch.randn(kv, p, bs, d, device="cuda", generator=g).to(TDT[dtype])
    lens = torch.from_numpy(lengths).cuda()
    out = pda.paged_decode_attention(q, k, v, tables, lens)
    torch.cuda.synchronize()
    ref = pda.paged_decode_attention_plain(q, k, v, tables, lens)
    torch.testing.assert_close(out.float(), ref.float(), rtol=_tol(dtype), atol=_tol(dtype))
    assert torch.equal(out[0], torch.zeros_like(out[0]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv", GROUPS)
def test_cuda_flash_entries_any_group(card, h, kv, dtype):
    """Kernel 2 at the same groups: the dense entry on bshk views (causal,
    and windowed), and the paged chunk entry with a pad row."""
    rng = np.random.default_rng(h + kv)
    d = 128
    g = torch.Generator(device="cuda").manual_seed(h + kv)
    q, k, v = (_bshk(2, 160, n, d, dtype, g) for n in (h, kv, kv))
    for window in (0, 48):
        out = fa.flash_attention(q, k, v, causal=True, window=window)
        ref = fa.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                       causal=True, window=window)
        torch.testing.assert_close(out.float(), ref.float(), rtol=_tol(dtype), atol=_tol(dtype))
    r, c, bs, mb = 4, 32, 16, 20
    p = r * mb
    starts = np.array([0, 64, 256, 0], np.int32)
    valid = starts + np.array([32, 17, 5, 0], np.int32)
    tables = shuffled_tables(rng, r - 1, mb, p, bs, valid[:-1])
    tables = np.concatenate([tables, tables[-1:]])
    args = [torch.randn(*shape, device="cuda", generator=g).to(TDT[dtype])
            for shape in ((r, c, h, d), (kv, p, bs, d), (kv, p, bs, d))]
    args += [torch.from_numpy(x).cuda() for x in (tables, starts, valid)]
    out = fa.paged_chunk_attention(*args)
    torch.cuda.synchronize()
    ref = fa.paged_chunk_attention_plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=_tol(dtype), atol=_tol(dtype))
    assert torch.equal(out[-1], torch.zeros_like(out[-1]))


# --------------------------------------------------------------------------- #
# Page-copy migration and the fleet on the card                               #
# --------------------------------------------------------------------------- #
def _smoke_model(dtype, device):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import TransformerLM

    return TransformerLM(dataclasses.replace(get_smoke_config("qwen3_8b"), dtype=dtype), device=device)


def test_cuda_bf16_slot_export_import_crc_bit_exact(card):
    """A bf16 slot's pages leave one pool and land in another on the card
    with the same bytes: the CRC of the landed pages equals the export's,
    and both equal the CRC of a host copy of the source pages."""
    from repro_torch.serving.kv_slots import PagedSlotManager, page_checksum

    model = _smoke_model("bfloat16", "cuda")
    src, dst = PagedSlotManager(model, 2, 64, 16), PagedSlotManager(model, 2, 64, 16)
    src.reserve(1, 64)
    for key in ("k", "v"):
        src.cache[key].copy_(torch.randn(src.cache[key].shape, device="cuda").bfloat16())
    src.cache["length"][1] = 61
    dst.reserve(0, 30)
    idx = torch.tensor(src.tables[1], device="cuda")
    host = [src.cache[key].index_select(2, idx).cpu() for key in ("k", "v")]
    pages, k, v, length, crc = src.export_pages(1)
    assert crc == page_checksum(host[0], host[1], 61)
    new = dst.import_pages(1, k, v, length, checksum=crc)
    didx = torch.tensor(new, device="cuda")
    landed = [dst.cache[key].index_select(2, didx) for key in ("k", "v")]
    assert torch.equal(landed[0].cpu(), host[0]) and torch.equal(landed[1].cpu(), host[1])
    assert page_checksum(landed[0], landed[1], int(dst.cache["length"][1])) == crc
    dst.check_block_table_mirror()


def test_cuda_two_replica_fleet_shares_one_weight_set(card, monkeypatch):
    """Two replicas of the float32 smoke model on the card: Fleet(...) adds
    the two pools and no weights, every request is served once, and under a
    scripted clock the card gives the CPU fleet's assignment and streams."""
    from repro_torch.core import CostModel, Request
    from repro_torch.models.layers import tree_map
    from repro_torch.serving import EngineConfig, Fleet, FleetConfig, OnlineProfiler
    from repro_torch.serving import engine as engine_mod
    from torch_port_arrays import ScriptedClock

    cm = CostModel(level_caps=(32, 64, 128))
    ecfg = EngineConfig(n_slots=2, max_len=64, kv_layout="paged", page_size=16, prefill_chunk=16)
    fcfg = FleetConfig(n_replicas=2, assign="lpt", work_stealing=True, steal_running=True)
    cpu = _smoke_model("float32", "cpu")
    params_cpu = cpu.init_params(seed=0)
    card_model = _smoke_model("float32", "cuda")
    params = tree_map(lambda x: x.cuda(), params_cpu)
    torch.cuda.synchronize()
    out = []
    for m, p in ((cpu, params_cpu), (card_model, params)):
        before = torch.cuda.memory_allocated()
        fleet = Fleet(m, p, ecfg, fcfg, cost_model=cm, device=m.device,
                      profiler_factory=lambda: OnlineProfiler(initial=cm, refit_every=10**9))
        if m.device.type == "cuda":
            pools = sum(t.numel() * t.element_size() for e in fleet.engines for t in e.slots.cache.values())
            assert abs(torch.cuda.memory_allocated() - before - pools) <= 64 * 1024
            assert all(e.params is p for e in fleet.engines)
        reqs = [Request(rid=i, n_prefill=8 + 3 * i, n_decode=(24 if i % 2 else 5) + i) for i in range(6)]
        monkeypatch.setattr(engine_mod, "time", ScriptedClock())
        report = fleet.serve(reqs)
        report.validate()
        assert sorted(r.rid for t in report.traces for r in t.requests) == list(range(6))
        gen = fleet.generated
        assert all(len(gen[r.rid]) == r.n_decode for r in reqs)
        out.append((fleet._offline_result.assignment, gen, fleet.steal_log, fleet.migration_log))
    assert out[1] == out[0]


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_cuda_engine_replays_every_stage_and_gives_the_cpu_streams(card, monkeypatch, layout):
    """The float32 smoke engine on the card captures every reachable key in
    ``warm_serving_shapes``, replays one graph a stage (the split scratch
    never moves, the launch counts add each graph's launches), and under a
    scripted clock gives the CPU engine's streams and stage list."""
    from repro_torch.core import CostModel, GlobalQueueScheduler, LagrangianPolicy, Request, build_clients
    from repro_torch.models.layers import tree_map
    from repro_torch.serving import Engine, EngineConfig, OnlineProfiler
    from repro_torch.serving import engine as engine_mod
    from torch_port_arrays import ScriptedClock

    cm = CostModel(level_caps=(32, 64, 128))
    kw = dict(n_slots=4, max_len=64, kv_layout=layout, page_size=16, prefill_chunk=16,
              prefill_seq_buckets=(32, 64), straggler_factor=1e9)
    cpu = _smoke_model("float32", "cpu")
    params_cpu = cpu.init_params(seed=0)
    out = []
    for m, p in ((cpu, params_cpu), (_smoke_model("float32", "cuda"),
                                     tree_map(lambda x: x.cuda(), params_cpu))):
        eng = Engine(m, p, EngineConfig(**kw), device=m.device,
                     profiler=OnlineProfiler(initial=cm, refit_every=10**9))
        eng.warm_serving_shapes()
        reqs = [Request(rid=i, n_prefill=8 + 5 * i, n_decode=(20 if i % 2 else 6) + i) for i in range(7)]
        monkeypatch.setattr(engine_mod, "time", ScriptedClock())
        da.reset_launch_count()
        pda.reset_launch_count()
        trace = eng.serve(reqs, build_clients(4, reqs, None), GlobalQueueScheduler(reqs),
                          LagrangianPolicy())
        assert eng.graphs.replays == len(trace.stages)
        assert eng.graphs.keys == eng.serving_keys()
        if m.device.type == "cuda":
            assert eng.graphs.captures == len(eng.graphs.keys)
            rounds = sum(s.rounds for s in trace.stages if s.kind.value == "decode")
            mixed = sum(1 for s in trace.stages if s.kind.value == "mixed")
            launched = pda.launch_count if layout == "paged" else da.launch_count
            assert launched == m.cfg.n_layers * (rounds + mixed)
        out.append((eng.generated, [(s.kind, s.t_start, s.t_end, s.busy, s.tokens) for s in trace.stages]))
    assert out[1] == out[0]


def test_cuda_threefry_and_top_p_draw_equal_the_cpu(card):
    """The sampler is integer threefry work plus float32 ops: on the card
    it gives the CPU's keys and bits exactly, and the same tokens for the
    same logits at Qwen3-8B's vocabulary."""
    from repro_torch.serving import TopPSampler, fold_row_keys
    from repro_torch.serving.threefry import random_bits, seed_key

    b, v = 8, 151936
    rids = torch.tensor([-1, 0, 3, 7, 2**31 - 1, 11, 12, 13], dtype=torch.int32)
    steps = torch.arange(b, dtype=torch.int32) * 5
    keys = {
        dev: fold_row_keys(seed_key(0, dev), rids.to(dev), steps.to(dev))
        for dev in ("cpu", "cuda")
    }
    assert torch.equal(keys["cuda"].cpu(), keys["cpu"])
    bits = random_bits(keys["cuda"], (v,))
    assert torch.equal(bits.cpu(), random_bits(keys["cpu"], (v,)))
    logits = torch.randn(b, v, generator=torch.Generator().manual_seed(0)) * 4
    sampler = TopPSampler(top_p=0.9)
    got = sampler(logits.cuda(), keys["cuda"]).cpu()
    assert torch.equal(got, sampler(logits, keys["cpu"]))


# --------------------------------------------------------------------------- #
# The training path: kernel 2's log-sum-exp and the backward kernel           #
# --------------------------------------------------------------------------- #
def _grad_case(b, h, kv, s, d, dtype, seed):
    """bshk q/k/v and dO seen as (B, H, S, D), the forward's output and
    log-sum-exp from the kernel."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (_bshk(b, s, n, d, dtype, g) for n in (h, kv, kv, h))
    return q, k, v, do


def _backward_matches_plain(q, k, v, do, causal, window, dtype):
    from repro_torch.kernels import flash_attention_bwd as fb

    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    torch.cuda.synchronize()
    ref_lse = fa.flash_attention_lse_plain(q, k, causal=causal, window=window)
    torch.testing.assert_close(lse, ref_lse, rtol=2e-5, atol=2e-5)
    grads = fb.flash_attention_backward(q, k, v, out, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    refs = fb.flash_attention_backward_plain(q, k, v, out, ref_lse, do, causal=causal, window=window)
    tol = _tol(dtype)
    for got, ref in zip(grads, refs):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        # relative to the reference's largest magnitude (bf16 inputs round
        # at other places in the plain version's float32 einsums), but not
        # below 1, the inputs' scale: under a window of 1 each query sees
        # one key, so dS and with it dQ and dK are 0 up to rounding
        err = float((got.float() - ref.float()).abs().max() / max(float(ref.float().abs().max()), 1.0))
        assert err <= tol, err
    again = fb.flash_attention_backward(q, k, v, out, lse, do, causal=causal, window=window)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))     # no atomics: the same bits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", range(1, 17))
def test_cuda_flash_backward_any_group(card, g, dtype):
    """The backward kernel at every GQA group from 1 to 16 (2 KV heads,
    head_dim 128 and 16), causal, against its plain version; two runs equal."""
    for d, s in ((128, 150), (16, 70)):
        _backward_matches_plain(*_grad_case(2, 2 * g, 2, s, d, dtype, g), True, 0, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (True, 1), (False, 0), (False, 40)])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_cuda_flash_backward_masks(card, d, causal, window, dtype):
    _backward_matches_plain(*_grad_case(2, 8, 2, 200, d, dtype, d + window), causal, window, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk", [(100, 160), (160, 100)])
def test_cuda_flash_backward_more_keys_or_queries(card, sq, sk, dtype):
    """The dense entry's positions 0..Sq-1 and 0..Sk-1 with Sq != Sk: keys
    no query sees get zero dK / dV (and queries past the keys, causal, see
    them all)."""
    g = torch.Generator(device="cuda").manual_seed(sq)
    q, do = (_bshk(2, sq, 8, 128, dtype, g) for _ in range(2))
    k, v = (_bshk(2, sk, 2, 128, dtype, g) for _ in range(2))
    _backward_matches_plain(q, k, v, do, True, 0, dtype)


def _plan_matches_plain(q, k, v, do, causal, window, subgroups):
    """The wgmma body under a forced plan (the GQA group in ``subgroups``
    sub-groups of CTAs: 1 keeps it in the CTA) against the plain backward,
    bf16 2e-2 relative to max(|ref|, 1); the plan's kernels ran, and two
    calls give the same bits."""
    from repro_torch.kernels import flash_attention_bwd as fb

    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    plan = fb.backward_plan(b, h, kv, sq, sk, d, q.dtype, causal=causal, window=window, subgroups=subgroups)
    assert plan.body == "tensor_cores"
    assert plan.subgroups == subgroups and plan.split_group is (subgroups > 1)
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    grads = fb._launch(q, k, v, out, lse, do, causal, window, d ** -0.5, plan)
    torch.cuda.synchronize()
    refs = fb.flash_attention_backward_plain(q, k, v, out, lse, do, causal=causal, window=window)
    for got, ref in zip(grads, refs):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        err = float((got.float() - ref.float()).abs().max() / max(float(ref.float().abs().max()), 1.0))
        assert err <= 2e-2, err
    again = fb._launch(q, k, v, out, lse, do, causal, window, d ** -0.5, plan)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", range(1, 17))
def test_cuda_flash_backward_wgmma_both_plans_any_group(card, g, d, split):
    """The wgmma body at every GQA group from 1 to 16 under both dK/dV
    grids (the group split over CTAs and summed in head order, or kept in
    the CTA), causal, S not a multiple of 64, strided bshk views."""
    _plan_matches_plain(*_grad_case(2, 2 * g, 2, 150, d, "bfloat16", g), True, 0, g if split else 1)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (True, 1), (False, 0), (False, 40)])
@pytest.mark.parametrize("sq,sk", [(200, 200), (100, 160), (160, 100), (64, 64)])
def test_cuda_flash_backward_wgmma_both_plans_masks(card, sq, sk, causal, window, split):
    """Both dK/dV grids under causal and windowed masks, with Sq != Sk and
    at a whole number of tiles."""
    g = torch.Generator(device="cuda").manual_seed(sq + sk + window)
    q, do = (_bshk(2, sq, 8, 128, "bfloat16", g) for _ in range(2))
    k, v = (_bshk(2, sk, 2, 128, "bfloat16", g) for _ in range(2))
    _plan_matches_plain(q, k, v, do, causal, window, 4 if split else 1)


@pytest.mark.parametrize("tile", [0, 1, 2])
def test_cuda_flash_lse_on_each_tensor_core_tile(card, tile):
    """The bf16 tensor-core body writes the log-sum-exp at each CTA tile
    (the key split merges its two halves' maxima first)."""
    g = torch.Generator(device="cuda").manual_seed(tile)
    q, k, v = (_bshk(2, 300, n, 128, "bfloat16", g) for n in (16, 4, 4))
    lse = torch.empty(2, 16, 300, dtype=torch.float32, device="cuda")
    out = fa._launch_dense(q, k, v, True, 0, 128 ** -0.5, tile, lse)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, fa.flash_attention_lse_plain(q, k), rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(out.float(), fa.flash_attention_plain(q, k, v).float(),
                               rtol=2e-2, atol=2e-2)


def test_cuda_serving_forward_asks_for_no_lse_and_runs_no_backward(card):
    """``attention_any`` without grad (every serving path) launches the
    forward once and nothing else; with grad, the forward once with the
    log-sum-exp and, in the backward pass, the backward kernel once."""
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.models.attention import attention_any

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 64, n, 128, device="cuda", generator=g).bfloat16() for n in (8, 2, 2))
    fa.reset_launch_count()
    fb.reset_launch_count()
    with torch.no_grad():
        served = attention_any(q, k, v, causal=True)
    assert (fa.launch_count, fb.launch_count) == (1, 0)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    out = attention_any(*leaves, causal=True)
    assert torch.equal(out.detach(), served)
    assert (fa.launch_count, fb.launch_count) == (2, 0)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (fa.launch_count, fb.launch_count) == (2, 1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)


def test_cuda_backward_refuses_what_it_does_not_take(card):
    """A head_dim the kernel has no variant for (48; 256 is taken since the
    CUDA-core body splits its columns) is refused before a launch."""
    from repro_torch.kernels import flash_attention_bwd as fb

    q, k, v, do = _grad_case(1, 2, 1, 32, 48, "bfloat16", 0)
    out, lse = fa.flash_attention_plain(q, k, v), fa.flash_attention_lse_plain(q, k)
    fb.reset_launch_count()
    with pytest.raises(ValueError, match="head_dim 48"):
        fb.flash_attention_backward(q, k, v, out, lse, do)
    assert fb.launch_count == 0


# --------------------------------------------------------------------------- #
# RecurrentGemma training: the RG-LRU backward and the flash backward at 256  #
# --------------------------------------------------------------------------- #
def _model_decays(b, s, r, gen, lo=0.9, hi=0.999):
    """RG-LRU decays in RecurrentGemma's trained range: a_t = base^{r_t},
    base (= sigma(Lambda)^c) uniform in [lo, hi] a channel (Griffin's init
    of Lambda: [0.9, 0.999]), the recurrence gate r_t = sigmoid(N(0, 1)).
    A chunk of 128 steps passes on about 1e-3 to 0.94 of its carry."""
    base = torch.rand((1, 1, r), device="cuda", generator=gen) * (hi - lo) + lo
    return base ** torch.sigmoid(torch.randn((b, s, r), device="cuda", generator=gen))


@pytest.mark.parametrize("b,s,r", [(1, 4096, 4096), (2, 300, 256), (3, 1, 100), (2, 9, 33)])
def test_cuda_rglru_backward_matches_plain(card, b, s, r):
    """The reverse scan (``csrc/rglru_bwd.cu``) against its plain version,
    float32 1e-5 relative to the largest magnitude, decays in the model's
    range, chained across two calls through ``RGLRUScanFn``; its own
    counter moves, the forward's only for the forward."""
    from repro_torch.kernels import rglru, rglru_bwd

    g = torch.Generator(device="cuda").manual_seed(s)
    a = _model_decays(b, s, r, g)
    x, gg = (torch.randn((b, s, r), device="cuda", generator=g) for _ in range(2))
    h0, gf = (torch.randn((b, r), device="cuda", generator=g) for _ in range(2))
    h, _ = rglru.rglru_scan(a, x, h0)
    got = rglru_bwd.rglru_scan_backward(a, h, h0, gg, gf)
    torch.cuda.synchronize()
    for u, ref in zip(got, rglru_bwd.rglru_scan_backward_plain(a, h, h0, gg, gf)):
        assert float((u - ref).abs().max() / ref.abs().max().clamp_min(1e-30)) < 1e-5
    leaves = [t.clone().requires_grad_(True) for t in (a, x, h0)]
    cut = s // 2
    rglru.reset_launch_count()
    rglru_bwd.reset_launch_count()
    h1, f1 = rglru.rglru_scan(leaves[0][:, :cut], leaves[1][:, :cut], leaves[2])
    h2, f2 = rglru.rglru_scan(leaves[0][:, cut:], leaves[1][:, cut:], f1)
    torch.autograd.backward((torch.cat([h1, h2], 1), f2), (gg, gf))
    assert (rglru.launch_count, rglru_bwd.launch_count) == (2, 2)
    for leaf, ref in zip(leaves, got):
        assert float((leaf.grad - ref).abs().max() / ref.abs().max().clamp_min(1e-30)) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 2048), (True, 0), (True, 33), (False, 0)])
def test_cuda_flash_backward_head_dim_256(card, causal, window, dtype):
    """RecurrentGemma-9B's attention (16 query heads on one KV head, head_dim
    256) under its own plan: bf16 on the two-warpgroup wgmma body, float32
    on the CUDA-core body, whose two CTAs a row tile split the accumulator
    columns; against the plain backward, two calls bit-equal."""
    from repro_torch.kernels import flash_attention_bwd as fb

    s = 2200 if window == 2048 else 150
    want = "tensor_cores" if dtype == "bfloat16" else "cuda_cores"
    assert fb.backward_plan(1, 16, 1, s, s, 256, TDT[dtype]).body == want
    _backward_matches_plain(*_grad_case(1, 16, 1, s, 256, dtype, s + window), causal, window, dtype)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (150, 150, True, 0), (200, 200, True, 33), (300, 300, True, 130), (100, 160, True, 0),
    (160, 100, True, 0), (70, 200, False, 0)])
@pytest.mark.parametrize("g", [1, 2, 16])
def test_cuda_flash_backward_wgmma_256_every_subgroup_count(card, g, sq, sk, causal, window):
    """The head_dim 256 wgmma body at groups 1, 2 and 16 (one KV head, batch
    2, strided bshk views) under every dK/dV grid it takes: every divisor of
    g as the sub-group count (1: the group kept in the CTA, g: one head a
    CTA), each against the plain backward, two calls bit-equal."""
    from repro_torch.kernels import flash_attention_bwd as fb

    gen = torch.Generator(device="cuda").manual_seed(g * 1000 + sq + sk + window)
    q, do = (_bshk(2, sq, g, 256, "bfloat16", gen) for _ in range(2))
    k, v = (_bshk(2, sk, 1, 256, "bfloat16", gen) for _ in range(2))
    for n in fb.subgroup_counts(g, 256):
        _plan_matches_plain(q, k, v, do, causal, window, n)


@pytest.mark.parametrize("b,s,r", [(1, 64, 32), (1, 65, 32), (1, 129, 40), (2, 257, 100), (3, 500, 64),
                                   (1, 1, 4096), (4, 1000, 4096)])
def test_cuda_rglru_backward_chunked_plan(card, b, s, r):
    """The chunked reverse scan at chunk edges (S at, one past and not a
    multiple of the chunk), S = 1, B > 1 and a plan of one chunk, decays in
    the model's range: against the sequential plain version (float32 1e-5
    relative to the largest magnitude) and the plain version in the
    kernel's chunk order; two calls give the same bits; two calls chained
    through their state match the plain versions chained."""
    from repro_torch.kernels import rglru, rglru_bwd

    plan = rglru_bwd.scan_plan(b, s, r)
    g = torch.Generator(device="cuda").manual_seed(s + r)
    a = _model_decays(b, s, r, g)
    x, gg = (torch.randn((b, s, r), device="cuda", generator=g) for _ in range(2))
    h0, gf = (torch.randn((b, r), device="cuda", generator=g) for _ in range(2))
    h, _ = rglru.rglru_scan(a, x, h0)
    got = rglru_bwd.rglru_scan_backward(a, h, h0, gg, gf)
    again = rglru_bwd.rglru_scan_backward(a, h, h0, gg, gf)
    torch.cuda.synchronize()
    assert all(torch.equal(u, w) for u, w in zip(got, again))
    for ref in (rglru_bwd.rglru_scan_backward_plain(a, h, h0, gg, gf),
                rglru_bwd.rglru_scan_backward_chunked_plain(a, h, h0, gg, gf, plan.chunk)):
        for u, w in zip(got, ref):
            assert float((u - w).abs().max() / w.abs().max().clamp_min(1e-30)) < 1e-5
    if s < 2:
        return
    cut = s // 2
    h1, f1 = rglru.rglru_scan(a[:, :cut], x[:, :cut], h0)
    h2, _ = rglru.rglru_scan(a[:, cut:], x[:, cut:], f1)
    a1, a2, g1, g2 = (t.contiguous() for t in (a[:, :cut], a[:, cut:], gg[:, :cut], gg[:, cut:]))
    second = rglru_bwd.rglru_scan_backward(a2, h2, f1, g2, gf)
    first = rglru_bwd.rglru_scan_backward(a1, h1, h0, g1, second[2])
    ref2 = rglru_bwd.rglru_scan_backward_plain(a2, h2, f1, g2, gf)
    ref1 = rglru_bwd.rglru_scan_backward_plain(a1, h1, h0, g1, ref2[2])
    for u, w in zip(first + second, ref1 + ref2):
        assert float((u - w).abs().max() / w.abs().max().clamp_min(1e-30)) < 1e-5


@pytest.mark.parametrize("b,s,r,lo,hi", [(2, 2048, 64, 0.999, 0.9999), (1, 4096, 4096, 0.9, 0.999)])
def test_cuda_rglru_backward_carries_across_many_chunks(card, b, s, r, lo, hi):
    """32 chunks whose carry reaches the first chunk at leading order: the
    decays keep more than 1e-2 of g_fin over every step (all channels at
    (2, 2048, 64), the slowest at RecurrentGemma's shape), so a fold that
    skipped a chunk's map, or took another chunk's A, moves the gradients
    far past the tolerance. Against the sequential plain version, float32 1e-5
    relative to the largest magnitude."""
    from repro_torch.kernels import rglru, rglru_bwd

    plan = rglru_bwd.scan_plan(b, s, r)
    assert plan.n_chunks == 32
    g = torch.Generator(device="cuda").manual_seed(r)
    a = _model_decays(b, s, r, g, lo, hi)
    x, gg = (torch.randn((b, s, r), device="cuda", generator=g) for _ in range(2))
    h0, gf = (torch.randn((b, r), device="cuda", generator=g) for _ in range(2))
    assert float(a.prod(1).max()) > 1e-2
    h, _ = rglru.rglru_scan(a, x, h0)
    got = rglru_bwd.rglru_scan_backward(a, h, h0, gg, gf)
    torch.cuda.synchronize()
    ref = rglru_bwd.rglru_scan_backward_plain(a, h, h0, gg, gf)
    # g_fin's share of dh0, carried over all 32 chunks, is 100 times the tolerance
    no_fin = rglru_bwd.rglru_scan_backward_plain(a, h, h0, gg, torch.zeros_like(gf))[2]
    assert float((ref[2] - no_fin).abs().max() / ref[2].abs().max()) > 1e-3
    for u, w in zip(got, ref):
        assert float((u - w).abs().max() / w.abs().max().clamp_min(1e-30)) < 1e-5


@pytest.mark.parametrize("d", [16, 64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_cross_attention_forward_and_backward(card, d, dtype):
    """Whisper's cross-attention shape (causal=False, Sq != Sk): the dense
    entry's forward against the plain version and its backward against the
    plain backward."""
    g = torch.Generator(device="cuda").manual_seed(d)
    q, do = (_bshk(2, 70, 4, d, dtype, g) for _ in range(2))
    k, v = (_bshk(2, 300, 4, d, dtype, g) for _ in range(2))
    out = fa.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(out.float(), fa.flash_attention_plain(q, k, v, causal=False).float(),
                               rtol=_tol(dtype), atol=_tol(dtype))
    _backward_matches_plain(q, k, v, do, False, 0, dtype)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_350m", "whisper_small"])
def test_cuda_new_family_gradients_equal_the_cpu(card, arch):
    """The float32 smoke loss and every gradient leaf (remat on) on the card
    against the CPU, on weights perturbed off their init as every parity
    input here is (at the init, zero biases and unit scales leave some
    leaves ill-conditioned: Whisper's decoder wk gradient differs by 7.2e-4
    of its largest magnitude between the reference and the port's CPU
    path): the loss within 1e-5, each leaf within 5e-4 of its largest
    magnitude; the RG-LRU and flash backward kernels ran once a recurrent
    and an attention layer (the backward pass), for the families that use
    them."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import rglru_bwd
    from repro_torch.models.layers import _leaves, tree_map
    from repro_torch.models.registry import get_model
    from repro_torch.train.train_loop import TrainConfig, synthetic_batches

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    gen = torch.Generator().manual_seed(1)

    def bump(x):
        spread = float(x.std()) if x.numel() > 1 else 0.0
        return x + 0.1 * (spread or 1.0) * torch.randn(x.shape, generator=gen)

    params = tree_map(bump, get_model(cfg, device="cpu").init_params(0))
    batch = next(synthetic_batches(cfg, TrainConfig(batch=2, seq=16)))
    outs = {}
    for dev in ("cpu", "cuda"):
        model = get_model(cfg, device=dev)
        tree = tree_map(lambda t: t.to(dev, copy=True).requires_grad_(True), params)
        rglru_bwd.reset_launch_count()
        fb.reset_launch_count()
        loss = model.loss(tree, {k: v.to(dev) for k, v in batch.items()}, remat=True)
        loss.backward()
        outs[dev] = (float(loss.detach()), {k: v.grad.cpu() for k, v in _leaves(tree)})
    assert abs(outs["cuda"][0] - outs["cpu"][0]) <= 1e-5
    for k, ref in outs["cpu"][1].items():
        got = outs["cuda"][1][k]
        assert float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)) < 5e-4, k
    if arch == "recurrentgemma_9b":
        assert (rglru_bwd.launch_count, fb.launch_count) == (model.n_rec, model.n_periods)
    if arch == "whisper_small":
        assert fb.launch_count == cfg.encoder_layers + 2 * cfg.n_layers


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "qwen3_8b", "xlstm_350m", "whisper_small"])
def test_cuda_replayed_serves_follow_an_in_place_update(card, arch):
    """bf16 smoke model served on the card through captured graphs (the
    Engine, or waves), one in-place ``adamw_update``, served again by
    replaying the same graphs: the tokens moved, and equal a fresh model's
    on the updated tree (a graph captured over float32 views of bf16 leaves
    replays them only as fresh as the refresh before it)."""
    from torch_port_arrays import serve_update_serve

    before, after, fresh = serve_update_serve(arch, "cuda")
    assert after != before
    assert after == fresh


# --------------------------------------------------------------------------- #
# Kernel 4's chunked plan: one pass, each chunk's carry folded from the maps  #
# --------------------------------------------------------------------------- #
def _scan_case(b, s, r, seed, misalign=False):
    """Model-range decays (``_model_decays``), x and h0; with ``misalign``
    a and x start 4 bytes past a 16-byte boundary (the 4-byte copy path)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = _model_decays(b, s, r, g)
    x = torch.randn((b, s, r), device="cuda", generator=g)
    h0 = torch.randn((b, r), device="cuda", generator=g)
    if misalign:
        a, x = (torch.empty(t.numel() + 1, device="cuda")[1:].view(b, s, r).copy_(t) for t in (a, x))
    return a, x, h0


def _close_to(got, ref):
    """Float32 within 1e-5 of (1 + the largest |h|): at the model's decays
    the kernel's fused steps and chunked order round apart from the plain
    versions by ulps of the largest state, as in chip_smoke.py."""
    for u, w in zip(got, ref):
        assert float((u - w).abs().max()) <= 1e-5 * (1 + float(w.abs().max()))


@pytest.mark.parametrize("b,s,r,misalign", [
    (1, 4096, 4096, False), (8, 128, 4096, False), (1, 65, 128, False), (2, 1000, 100, False),
    (3, 300, 37, False), (1, 1000, 256, True), (1, 4096, 100, False)])
def test_cuda_rglru_chunked_matches_both_plain_versions(card, b, s, r, misalign):
    """Shapes whose plan chunks time (the training shape's 64 chunks, the
    prefill's 2, S one past a chunk, ragged S and R, R not a multiple of 4,
    unaligned rows) at the model's decays: against the sequential plain
    version and the plain version in the kernel's chunked order; two calls
    give the same bits; one call counts one launch, on the chunked kernel."""
    from repro_torch.kernels import rglru

    plan = rglru.scan_plan(b, s, r)
    assert plan.kernels == ("rglru_chunked_kernel",) and plan.n_chunks > 1
    a, x, h0 = _scan_case(b, s, r, s + r, misalign)
    rglru.reset_launch_count()
    got = rglru.rglru_scan(a, x, h0)
    again = rglru.rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert rglru.launch_count == 2 and rglru.launch_count_by_kernel == {
        "rglru_kernel": 0, "rglru_chunked_kernel": 2}
    assert all(torch.equal(u, w) for u, w in zip(got, again))
    _close_to(got, rglru.rglru_scan_plain(a, x, h0))
    _close_to(got, rglru.rglru_scan_chunked_plain(a, x, h0, plan.chunk))


@pytest.mark.parametrize("b,s,r", [(1, 4096, 4096), (8, 128, 4096), (8, 1, 4096)])
def test_cuda_rglru_runs_its_plans_device_kernels(card, b, s, r):
    """A call runs exactly its plan's device kernels, in order (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import rglru

    a, x, h0 = _scan_case(b, s, r, 1)
    rglru.rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rglru.rglru_scan(a, x, h0)
        torch.cuda.synchronize()
    names = [e.name for e in sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                                    key=lambda e: e.time_range.start)
             if "emcpy" not in e.name and "emset" not in e.name]
    kernels = rglru.scan_plan(b, s, r).kernels
    assert len(names) == len(kernels) and all(k + ("<" if k == "rglru_chunked_kernel" else "(") in n
                                               for k, n in zip(kernels, names)), names


@pytest.mark.parametrize("b,s,r,cut", [(1, 4096, 4096, 2007), (2, 1000, 100, 130), (8, 300, 4096, 64)])
def test_cuda_rglru_chunked_state_chains_across_calls(card, b, s, r, cut):
    """Two calls, the first's final state seeding the second, the cut inside
    a chunk (or at its edge): equal to one call and to the plain version."""
    from repro_torch.kernels import rglru

    a, x, h0 = _scan_case(b, s, r, cut)
    full = rglru.rglru_scan(a, x, h0)
    h1, f1 = rglru.rglru_scan(a[:, :cut], x[:, :cut], h0)
    h2, f2 = rglru.rglru_scan(a[:, cut:], x[:, cut:], f1)
    torch.cuda.synchronize()
    chained = (torch.cat([h1, h2], 1), f2)
    _close_to(chained, full)
    _close_to(chained, rglru.rglru_scan_plain(a, x, h0))


def test_cuda_rglru_chunked_gradient_matches_the_plain_reverse_scan(card):
    """``RGLRUScanFn`` at a chunked shape (the forward's chunked kernel, the
    backward's chunked reverse scan): the gradients of a, x and h0 against
    the plain reverse scan of the plain forward's states."""
    from repro_torch.kernels import rglru, rglru_bwd

    b, s, r = 2, 1000, 256
    a, x, h0 = _scan_case(b, s, r, 3)
    g = torch.Generator(device="cuda").manual_seed(4)
    gg, gf = torch.randn((b, s, r), device="cuda", generator=g), torch.randn((b, r), device="cuda", generator=g)
    leaves = [t.clone().requires_grad_(True) for t in (a, x, h0)]
    rglru.reset_launch_count()
    h, hf = rglru.rglru_scan(*leaves)
    torch.autograd.backward((h, hf), (gg, gf))
    assert rglru.launch_count_by_kernel["rglru_chunked_kernel"] == 1
    h_plain, _ = rglru.rglru_scan_plain(a, x, h0)
    ref = rglru_bwd.rglru_scan_backward_plain(a, h_plain, h0, gg, gf)
    for leaf, w in zip(leaves, ref):
        assert float((leaf.grad - w).abs().max() / w.abs().max().clamp_min(1e-30)) < 1e-5


@pytest.mark.parametrize("b,s,r", [(8, 1, 4096), (8, 128, 4096)])
def test_cuda_rglru_graph_replay_equals_direct_calls(card, b, s, r):
    """The scan captured in a CUDA graph, as a wave's decode step replays it
    (S = 1; and the chunked prefill shape, whose tickets and flags each
    launch leaves ready for the next): five replays, each seeded with the
    last one's final state and given new inputs, give the bits of direct
    calls on the same inputs."""
    from repro_torch.kernels import rglru

    a, x, h0 = _scan_case(b, s, r, 5)
    rglru.rglru_scan(a, x, h0)                     # sizes the control buffer outside the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rglru.rglru_scan(a, x, h0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, hf = rglru.rglru_scan(a, x, h0)
    state = h0.clone()
    g = torch.Generator(device="cuda").manual_seed(6)
    for _ in range(5):
        a.copy_(_model_decays(b, s, r, g))
        x.normal_(generator=g)
        h0.copy_(state)
        graph.replay()
        want, want_f = rglru.rglru_scan(a, x, state)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(hf, want_f)
        state = want_f
