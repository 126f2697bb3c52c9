"""The kernels' custom ops (``repro_torch::*``) on the CPU.

* ``torch.library.opcheck`` on each op's CPU implementation (the plain
  version): schema, fake implementation, autograd registration, dispatch.
* Under ``FakeTensorMode`` each wrapper gives outputs of the shapes, dtypes
  and strides its CPU call gives (strided inputs where the model passes
  them: the dense entry on ``bshk`` views, decode on cache views).
* ``FlopCounterMode`` counts each op's stated formula.
* Kernel 3's log-sum-exp: the plain version's against a float64 logsumexp,
  and two halves of a cache merged by their log-sum-exps equal the whole
  (the merge ``distributed.spmd.decode_attention`` runs across devices).
* Each op has a DTensor sharding rule (``distributed.op_rules``).
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.kernels.decode_attention as da
import repro_torch.kernels.flash_attention as fa
import repro_torch.kernels.flash_attention_bwd as fb
import repro_torch.kernels.paged_decode_attention  # noqa: F401  (registers its op)
import repro_torch.kernels.rglru as rg

OPS = torch.ops.repro_torch


def _rand(*shape, seed=0, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(dtype)


B, H, KV, S, D = 2, 4, 2, 16, 16


def _dense():
    return _rand(B, H, S, D, seed=1), _rand(B, KV, S, D, seed=2), _rand(B, KV, S, D, seed=3)


def _pool():
    pages = _rand(KV, 6, 4, D, seed=4)
    tables = torch.tensor([[0, 1, 2, -1], [3, 4, 5, -1]], dtype=torch.int32)
    return pages, pages.clone(), tables


def _scan():
    a = torch.from_numpy(np.random.default_rng(5).uniform(0.5, 1.0, (B, S, 8)).astype(np.float32))
    return a, _rand(B, S, 8, seed=6), _rand(B, 8, seed=7)


def _cases():
    q, k, v = _dense()
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    lengths = torch.tensor([5, 16], dtype=torch.int32)
    kp, vp, tables = _pool()
    a, x, h0 = _scan()
    h, _ = rg.rglru_scan(a, x, h0)
    # the dense entry on bshk views (the model's layout), as attention_any passes them
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    return {
        "flash_attention": (OPS.flash_attention.default, (q, k, v, True, 0, 0.25, False)),
        "flash_attention lse": (OPS.flash_attention.default, (q, k, v, True, 0, 0.25, True)),
        "flash_attention bshk window": (OPS.flash_attention.default, (qs, ks, vs, True, 4, 0.25, True)),
        "flash_attention_backward": (OPS.flash_attention_backward.default,
                                     (q, k, v, out, lse, _rand(B, H, S, D, seed=8), True, 0, 0.25)),
        "decode_attention": (OPS.decode_attention.default,
                             (_rand(B, H, D, seed=9), k, v, lengths, 0.25, False)),
        "decode_attention lse": (OPS.decode_attention.default,
                                 (_rand(B, H, D, seed=9), k, v, lengths, 0.25, True)),
        "decode_attention cache view": (OPS.decode_attention.default,
                                        (_rand(B, H, D, seed=9), ks.transpose(1, 2).contiguous().transpose(1, 2),
                                         vs, lengths, 0.25, True)),
        "paged_decode_attention": (OPS.paged_decode_attention.default,
                                   (_rand(B, 1, H, D, seed=10), kp, vp, tables,
                                    torch.tensor([5, 12], dtype=torch.int32), 0.25)),
        "paged_chunk_attention": (OPS.paged_chunk_attention.default,
                                  (_rand(B, 4, H, D, seed=11), kp, vp, tables,
                                   torch.tensor([0, 4], dtype=torch.int32),
                                   torch.tensor([4, 8], dtype=torch.int32), 0.25)),
        "rglru_scan": (OPS.rglru_scan.default, (a, x, h0)),
        "rglru_scan bf16": (OPS.rglru_scan.default, (a.bfloat16(), x.bfloat16(), h0)),
        "rglru_scan_backward": (OPS.rglru_scan_backward.default,
                                (a, h, h0, _rand(B, S, 8, seed=12), _rand(B, 8, seed=13))),
    }


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_opcheck(name):
    op, args = CASES[name]
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("name", list(CASES))
def test_fake_outputs_match_the_cpu_call(name):
    op, args = CASES[name]
    real = op(*args)
    mode = FakeTensorMode()
    fake_args = tuple(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args)
    with mode:
        fake = op(*fake_args)
    real = real if isinstance(real, (tuple, list)) else (real,)
    fake = fake if isinstance(fake, (tuple, list)) else (fake,)
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        assert (tuple(f.shape), f.dtype, f.stride()) == (tuple(r.shape), r.dtype, r.stride())


def _attention_pairs_formula(q, k, window):
    return fa.attention_pairs(q.shape[2], k.shape[2], window)


@pytest.mark.parametrize("name", list(CASES))
def test_flop_formula(name):
    op, args = CASES[name]
    with FlopCounterMode(display=False) as fc:
        op(*args)
    got = fc.get_total_flops()
    packet = op._overloadpacket.__name__
    if packet == "flash_attention":
        q, k, _, _, window = args[:5]
        want = 4 * q.shape[0] * q.shape[1] * q.shape[3] * _attention_pairs_formula(q, k, window)
    elif packet == "flash_attention_backward":
        q, k = args[:2]
        want = 8 * q.shape[0] * q.shape[1] * q.shape[3] * _attention_pairs_formula(q, k, args[7])
    elif packet == "decode_attention":
        q, k = args[:2]
        want = 4 * q.shape[0] * q.shape[1] * k.shape[2] * q.shape[2]
    elif packet == "paged_decode_attention":
        q, kp, _, tables = args[:4]
        want = 4 * q.shape[0] * q.shape[2] * tables.shape[1] * kp.shape[2] * q.shape[3]
    elif packet == "paged_chunk_attention":
        q, kp, _, tables = args[:4]
        want = 4 * q.shape[0] * q.shape[2] * q.shape[1] * tables.shape[1] * kp.shape[2] * q.shape[3]
    elif packet == "rglru_scan":
        want = 2 * args[0].numel()
    else:
        want = 3 * args[0].numel()
    assert got == want


def test_attention_pairs_follow_the_reference_dispatch():
    """Every pair up to 2048 keys and without a window; a long window's
    band of window + 512 keys a query past them."""
    assert fa.attention_pairs(4096, 4096, 0) == 4096 * 4096
    assert fa.attention_pairs(2048, 2048, 1024) == 2048 * 2048
    assert fa.attention_pairs(32768, 32768, 4096) == 32768 * (4096 + 512)
    assert fa.attention_pairs(4096, 4096, 4096) == 4096 * 4096


def test_wrappers_reach_the_ops():
    """On CPU tensors the wrappers give the plain versions' values through
    the ops (the dispatcher's CPU implementation)."""
    q, k, v = _dense()
    np.testing.assert_array_equal(fa.flash_attention(q, k, v).numpy(),
                                  fa.flash_attention_plain(q, k, v).numpy())
    lengths = torch.tensor([5, 16], dtype=torch.int32)
    qd = _rand(B, H, D, seed=9)
    np.testing.assert_array_equal(da.decode_attention(qd, k, v, lengths).numpy(),
                                  da.decode_attention_plain(qd, k, v, lengths).numpy())
    a, x, h0 = _scan()
    for got, want in zip(rg.rglru_scan(a, x, h0), rg.rglru_scan_plain(a, x, h0)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_backward", "decode_attention",
                                  "paged_decode_attention", "paged_chunk_attention", "rglru_scan",
                                  "rglru_scan_backward"])
def test_ops_dispatch_by_device_only(name):
    """Each op has a CPU implementation (the plain version), a CUDA one (the
    kernel) and nothing that would serve any device: a CUDA tensor gets the
    kernel or raises."""
    qual = f"repro_torch::{name}"
    has = lambda key: torch._C._dispatch_has_kernel_for_dispatch_key(qual, key)
    assert has("CPU") and has("CUDA")
    assert not has("CompositeExplicitAutograd") and not has("CompositeImplicitAutograd")


def test_decode_lse_and_the_split_merge():
    q = _rand(B, H, D, seed=14)
    k, v = _rand(B, KV, 32, D, seed=15), _rand(B, KV, 32, D, seed=16)
    lengths = torch.tensor([20, 32], dtype=torch.int32)
    out, lse = da.decode_attention(q, k, v, lengths, return_lse=True)
    s = torch.einsum("bkgd,bksd->bkgs", q.double().reshape(B, KV, H // KV, D), k.double()) * D ** -0.5
    s = torch.where(torch.arange(32)[None, None, None, :] < lengths.long()[:, None, None, None], s, -np.inf)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).reshape(B, H).numpy(), rtol=1e-5, atol=1e-5)
    # two halves of the cache, each with its own lengths, merged by their lse
    parts = []
    for lo in (0, 16):
        ln = torch.clamp(lengths - lo, 0, 16).to(torch.int32)
        parts.append(da.decode_attention(q, k[:, :, lo:lo + 16], v[:, :, lo:lo + 16], ln, return_lse=True))
    m = torch.maximum(parts[0][1], parts[1][1])
    w = [torch.exp(p[1] - m) for p in parts]
    merged = (parts[0][0] * w[0][..., None] + parts[1][0] * w[1][..., None]) / (w[0] + w[1])[..., None]
    np.testing.assert_allclose(merged.numpy(), out.numpy(), rtol=1e-5, atol=1e-5)


def test_a_slot_without_keys_has_lse_minus_inf():
    q, k, v = _rand(1, H, D, seed=17), _rand(1, KV, 8, D, seed=18), _rand(1, KV, 8, D, seed=19)
    out, lse = da.decode_attention(q, k, v, torch.zeros(1, dtype=torch.int32), return_lse=True)
    assert torch.all(torch.isneginf(lse)) and torch.all(out == 0)


def test_every_op_has_a_sharding_rule():
    from repro_torch.distributed import op_rules

    op_rules.register()
    from torch.distributed.tensor import DTensor

    funcs = DTensor._op_dispatcher.sharding_propagator.op_strategy_funcs
    for name in ("flash_attention", "flash_attention_backward", "decode_attention",
                 "paged_decode_attention", "paged_chunk_attention", "rglru_scan",
                 "rglru_scan_backward"):
        assert getattr(OPS, name).default in funcs, name


def test_the_autograd_functions_call_the_ops():
    """FlashAttentionFn and RGLRUScanFn reach the ops forward and backward
    (the fake trace sees one call each way)."""
    from repro_torch.launch.trace_analysis import TraceAnalysis

    q, k, v = (t.requires_grad_(True) for t in _dense())
    a, x, h0 = (t.requires_grad_(True) for t in _scan())
    mode = TraceAnalysis()
    with mode:
        fb.FlashAttentionFn.apply(q, k, v, True, 0, None).sum().backward()
        h, hf = rg.rglru_scan(a, x, h0)
        (h.sum() + hf.sum()).backward()
    assert mode.totals.op_calls == {"flash_attention": 1, "flash_attention_backward": 1,
                                    "rglru_scan": 1, "rglru_scan_backward": 1}
