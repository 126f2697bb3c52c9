"""The plain reference against the program on the same seeded weights: the
program's paged prefill in chunks, then its decode steps through the pages,
in float32 on the CPU, give the reference's logits at every position (the
MoE's capacity drops included)."""
import numpy as np
import pytest
import torch

from portbench import smoke_cell
from portbench.reference import decoder
from portbench.weights import make_weights

TOL = 2e-4            # float32 on both sides; different summation orders


def _float32(tree):
    return {k: _float32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def _program_logits(arch, weights, prompt, fed, chunk, page=8):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.transformer import TransformerLM

    model = TransformerLM(ArchConfig(**arch), device="cpu")
    total = len(prompt) + len(fed)
    pages = -(-total // page)
    cache = model.paged_cache_init(pages + 1, page, 1, pages)
    cache["block_tables"][0] = torch.arange(pages, dtype=torch.int32)
    out = []
    for s in range(0, len(prompt), chunk):
        n = min(chunk, len(prompt) - s)
        toks = torch.zeros(1, chunk, dtype=torch.int32)
        toks[0, :n] = torch.as_tensor(prompt[s:s + n])
        logits, cache = model.prefill_chunk(
            weights, toks, cache, torch.tensor([0], dtype=torch.int32),
            torch.tensor([s], dtype=torch.int32), torch.tensor([n], dtype=torch.int32))
    out.append(logits[0])
    for t in fed:
        logits, cache = model.decode_step(weights, torch.tensor([t], dtype=torch.int32), cache,
                                          active=torch.tensor([True]))
        out.append(logits[0])
    return torch.stack(out)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_reference_matches_program_prefill_then_decode(moe):
    arch = smoke_cell.arch(moe, dtype="float32")
    tree = smoke_cell.config(moe)["tree"]
    weights = _float32(make_weights(tree, arch, 2**31 + 11, torch.device("cpu")))
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, arch["vocab_size"], 21)
    fed = rng.integers(1, arch["vocab_size"], 9)
    chunk = 8
    got = _program_logits(arch, weights, prompt, fed, chunk)
    seq = torch.as_tensor(np.concatenate([prompt, fed]))
    pos = torch.arange(len(prompt) - 1, len(seq))
    (want,) = decoder.served_logits(weights, arch, [(seq, len(prompt), pos)], chunk)
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= TOL * max(1.0, want.abs().max().item()), err


def test_moe_groups_follow_the_serving_schedule():
    assert decoder.moe_groups(11, 9, 4) == [(0, 4, 4), (4, 8, 4), (8, 9, 4), (9, 10, 1), (10, 11, 1)]


def test_capacity_drops_are_what_the_program_drops():
    """A prompt chunk of 8 tokens over 8 experts, top-2, whose router
    prefers experts 0 and 1: capacity 4 an expert, so the later tokens'
    choices drop; the reference's kept set is the program's."""
    from repro_torch.models.moe import moe_route

    arch = smoke_cell.arch(True, dtype="float32")
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 8, 64, generator=g)
    router = torch.randn(64, 8, generator=g)
    x[..., 0] = 50.0
    router[0, :2] += 10.0
    r = moe_route(x, router, 8, 2, arch["moe_capacity_factor"])
    probs = torch.softmax(x[0] @ router, -1)
    idx = torch.topk(probs, 2, -1).indices.tolist()
    taken, kept = [0] * 8, []
    cap = max(1, int(arch["moe_capacity_factor"] * 8 * 2 / 8))
    assert cap == r.capacity == 4
    for row in idx:
        for e in row:
            kept.append(taken[e] < cap)
            taken[e] += 1
    assert r.within[0].tolist() == kept
    assert not all(kept)
