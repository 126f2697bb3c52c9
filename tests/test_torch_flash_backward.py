"""The backward of flash attention's dense entry on the CPU: the plain
version (``flash_attention_backward_plain``, the explicit formulas) against
``torch.autograd`` of ``flash_attention_plain`` and against ``jax.grad`` of
the reference's ``repro.models.attention.attention``, which is what the
reference's training path differentiates; the plain log-sum-exp against the
reference's scores; and ``FlashAttentionFn`` / ``attention_any`` on CPU
tensors. Inputs from numpy (seeded), float32.

Tolerance: 2e-5 relative to the reference's largest magnitude (the kernels'
float32 tolerance; the sums run in another order in each framework)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attention as ref_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.models import attention as port_attention

TOL = 2e-5

# (H, KV, head_dim, causal, window): MHA, GQA groups 1, 2, 4 and 9, head_dims
# 12 (the smoke StarCoder2's), 16 (the smoke configs') and 128 (full width)
CASES = [
    (4, 4, 16, True, 0),      # g = 1 (MHA)
    (4, 2, 16, True, 0),      # g = 2
    (8, 2, 12, True, 5),      # g = 4, windowed
    (9, 1, 16, True, 0),      # g = 9
    (4, 1, 128, True, 7),     # g = 4, windowed, head_dim 128
    (6, 3, 128, False, 0),    # g = 2, no causal mask
    (4, 2, 12, False, 6),     # a window without the causal mask
]


def _inputs(h, kv, d, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, kv, d)).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _bhsd(x):
    """numpy bshk → the (B, H, S, D) view the port's attention passes."""
    return torch.from_numpy(x).transpose(1, 2)


def _rel(a, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(a, np.float32) - ref).max() / max(np.abs(ref).max(), 1e-30))


def _jax_grads(q, k, v, do, causal, window):
    pos = jnp.broadcast_to(jnp.arange(q.shape[1], dtype=jnp.int32)[None], q.shape[:2])
    f = lambda q_, k_, v_: ref_attention(q_, k_, v_, q_positions=pos, k_positions=pos,
                                         causal=causal, window=window)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("h,kv,d,causal,window", CASES)
def test_plain_backward_matches_jax_grad_of_the_reference(h, kv, d, causal, window):
    q, k, v, do = _inputs(h, kv, d)
    ref_out, ref_grads = _jax_grads(q, k, v, do, causal, window)
    tq, tk, tv = _bhsd(q), _bhsd(k), _bhsd(v)
    out, lse = fa.flash_attention(tq, tk, tv, causal=causal, window=window, return_lse=True)
    assert _rel(out.transpose(1, 2).numpy(), ref_out) < TOL
    grads = fb.flash_attention_backward(tq, tk, tv, out, lse, _bhsd(do), causal=causal, window=window)
    for name, g, ref in zip("qkv", grads, ref_grads):
        assert g.shape == (tq, tk, tv)["qkv".index(name)].shape
        err = _rel(g.transpose(1, 2).numpy(), ref)
        assert err < TOL, f"d{name}: {err:.3g}"


@pytest.mark.parametrize("h,kv,d,causal,window", CASES)
def test_plain_backward_matches_autograd_of_the_plain_forward(h, kv, d, causal, window):
    q, k, v, do = _inputs(h, kv, d, seed=1)
    leaves = [_bhsd(x).requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention_plain(*leaves, causal=causal, window=window)
    auto = torch.autograd.grad(out, leaves, _bhsd(do))
    tq, tk, tv = (x.detach() for x in leaves)
    lse = fa.flash_attention_lse_plain(tq, tk, causal=causal, window=window)
    grads = fb.flash_attention_backward_plain(tq, tk, tv, out.detach(), lse, _bhsd(do),
                                              causal=causal, window=window)
    for g, ref in zip(grads, auto):
        assert _rel(g.numpy(), ref.numpy()) < TOL


@pytest.mark.parametrize("h,kv,d,causal,window", CASES[:5])
def test_plain_lse_matches_the_reference_scores(h, kv, d, causal, window):
    """logsumexp over the visible keys of the reference's scaled scores,
    (B, H, S); softmax rows rebuilt from it sum to 1."""
    q, k, _, _ = _inputs(h, kv, d, seed=2)
    b, s = q.shape[:2]
    g = h // kv
    scores = np.einsum("bqkgd,bskd->bkgqs", q.reshape(b, s, kv, g, d).astype(np.float64),
                       k.astype(np.float64)) * d ** -0.5
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = np.ones((s, s), bool)
    if causal:
        mask &= j <= i
    if window:
        mask &= i - j < window
    ref = np.asarray(jax.nn.logsumexp(jnp.asarray(np.where(mask, scores, -np.inf)), axis=-1))
    lse = fa.flash_attention_lse_plain(_bhsd(q), _bhsd(k), causal=causal, window=window)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    np.testing.assert_allclose(lse.numpy(), ref.reshape(b, h, s), rtol=1e-6, atol=1e-5)


def test_flash_attention_fn_and_attention_any_on_cpu(monkeypatch):
    """With grad recorded, ``attention_any`` goes through FlashAttentionFn
    (the plain versions on CPU tensors) and its gradients are the plain
    backward's; without it, the serving call, which saves nothing."""
    q, k, v, do = _inputs(8, 2, 16, seed=3)
    calls = []
    real = fb.flash_attention_backward
    monkeypatch.setattr(fb, "flash_attention_backward",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = port_attention.attention_any(*leaves, causal=True, window=5)
    fn = out.grad_fn.next_functions[0][0]            # under the transpose back to bshk
    assert "FlashAttentionFn" in type(fn).__name__
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert calls == [1]
    ref_out, ref_grads = _jax_grads(q, k, v, do, True, 5)
    assert _rel(out.detach().numpy(), ref_out) < TOL
    for g, ref in zip(grads, ref_grads):
        assert _rel(g.numpy(), ref) < TOL
    with torch.no_grad():
        served = port_attention.attention_any(*leaves, causal=True, window=5)
    assert served.grad_fn is None
    np.testing.assert_array_equal(served.numpy(), out.detach().numpy())


def test_backward_checks_its_inputs():
    q, k, v, do = (_bhsd(x) for x in _inputs(4, 2, 16))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        fb.flash_attention_backward(q, k, v, out, lse[:, :, :-1], do)
    with pytest.raises(ValueError, match="d_out"):
        fb.flash_attention_backward(q, k, v, out, lse, do[:, :, :-1])
    with pytest.raises(TypeError):
        fb.flash_attention_backward(q.double(), k, v, out, lse, do)


def test_backward_body_by_dtype_and_head_dim():
    """bf16 at head_dim 64 and 128 runs the tensor-core body; float32 at any
    head_dim and bf16 at 16 and 32 the CUDA-core body."""
    assert [fb.variant(torch.bfloat16, d) for d in (16, 32, 64, 128)] == [
        "cuda_cores", "cuda_cores", "tensor_cores", "tensor_cores"]
    assert {fb.variant(torch.float32, d) for d in (16, 32, 64, 128)} == {"cuda_cores"}
    fb.reset_launch_count()
    assert fb.launch_count == 0 and set(fb.launch_count_by_variant.values()) == {0}


@pytest.mark.parametrize("g", [1, 2, 4, 9, 16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_group_split_sums_to_the_plain_backward(g, causal, window):
    """The split plan's two steps on the CPU: each query head's float32
    share of dK and dV, then the fixed-order sum over the group, equal the
    plain backward's dK and dV (float32, the sums in another order)."""
    kv = 2 if g < 9 else 1
    q, k, v, do = (_bhsd(x) for x in _inputs(g * kv, kv, 16, seed=g))
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    parts = fb.group_partials_plain(q, k, v, out, lse, do, causal=causal, window=window)
    assert all(p.shape == (2, g * kv, 24, 16) and p.dtype == torch.float32 for p in parts)
    dk, dv = fb.group_sum_plain(*parts, kv, q.dtype)
    _, ref_dk, ref_dv = fb.flash_attention_backward_plain(q, k, v, out, lse, do, causal=causal, window=window)
    for got, ref in ((dk, ref_dk), (dv, ref_dv)):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert _rel(got.numpy(), ref.numpy()) < 1e-6


def test_group_sum_adds_in_head_order():
    """Float32 addition is not associative: the sum takes the heads in
    order 0, 1, ..., g - 1, as the device's sum kernel does, so the two
    give the same bits from the same partials."""
    parts = torch.tensor([1.0, 2.0 ** -24, 2.0 ** -24, -1.0]).reshape(1, 4, 1, 1)
    dk, _ = fb.group_sum_plain(parts, parts, 1, torch.float32)
    assert float(dk) == 0.0                      # in float32, 1 + 2^-24 rounds to 1
    assert float(parts.double().sum()) == 2.0 ** -23
    dk, _ = fb.group_sum_plain(parts.flip(1), parts.flip(1), 1, torch.float32)
    assert float(dk) == 2.0 ** -23
