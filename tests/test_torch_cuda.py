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


@pytest.mark.parametrize("h,kv,d", [(32, 8, 128), (4, 2, 16), (8, 2, 64), (8, 1, 64), (4, 4, 128)])
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


def _plan_matches_plain(q, k, v, do, causal, window, split):
    """The wgmma body under a forced plan (the GQA group split over CTAs or
    kept in the CTA) against the plain backward, bf16 2e-2 relative to
    max(|ref|, 1); the plan's kernels ran, and two calls give the same bits."""
    from repro_torch.kernels import flash_attention_bwd as fb

    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    plan = fb.backward_plan(b, h, kv, sq, sk, d, q.dtype, causal=causal, window=window, split=split)
    assert plan.body == "tensor_cores" and plan.split_group is split
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
    _plan_matches_plain(*_grad_case(2, 2 * g, 2, 150, d, "bfloat16", g), True, 0, split)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (True, 1), (False, 0), (False, 40)])
@pytest.mark.parametrize("sq,sk", [(200, 200), (100, 160), (160, 100), (64, 64)])
def test_cuda_flash_backward_wgmma_both_plans_masks(card, sq, sk, causal, window, split):
    """Both dK/dV grids under causal and windowed masks, with Sq != Sk and
    at a whole number of tiles."""
    g = torch.Generator(device="cuda").manual_seed(sq + sk + window)
    q, do = (_bshk(2, sq, 8, 128, "bfloat16", g) for _ in range(2))
    k, v = (_bshk(2, sk, 2, 128, "bfloat16", g) for _ in range(2))
    _plan_matches_plain(q, k, v, do, causal, window, split)


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
    from repro_torch.kernels import flash_attention_bwd as fb

    q, k, v, do = _grad_case(1, 2, 1, 32, 256, "bfloat16", 0)
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="head_dim 256"):
        fb.flash_attention_backward(q, k, v, out, lse, do)
