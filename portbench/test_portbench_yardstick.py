"""The yardstick's arithmetic on synthetic traces, its frozen bound formula
against chip_smoke.py's, and its replay of kernel 1's calls against the
calls a CPU serve really makes."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace as NS

import pytest
import torch

from portbench import bench, smoke_cell, yardstick

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_bounds", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def req(due, stamps, n_decode=3, n_prefill=4):
    return NS(due=due, stamps=stamps, n_decode=n_decode, n_prefill=n_prefill)


def stage(kind, a, b, busy=(), partial=(), tokens=0, chunk_tokens=0, rounds=0):
    return NS(kind=kind, t_start=a, t_end=b, busy=dict(enumerate(busy)),
              busy_partial={100 + i: r for i, r in enumerate(partial)},
              tokens=tokens, chunk_tokens=chunk_tokens, rounds=rounds)


def test_tokens_in_the_window():
    assert yardstick.output_tokens([[0.5, 1.0, 5.0, 5.5], [6.0]], 5.0) == 3


def test_slot_and_host_shares():
    stages = [stage("prefill", 0.0, 1.0, busy=[1], partial=[2, 3]),
              stage("decode", 2.0, 4.0, busy=[1, 2]),
              stage("decode", 4.5, 6.0, busy=[1])]
    # busy slot-seconds in [0, 5]: 3 x 1 + 2 x 2 + 1 x 0.5 over 4 slots x 5 s
    assert yardstick.slot_util(stages, 4, 5.0) == pytest.approx(7.5 / 20)
    assert yardstick.host_share(stages, 5.0) == pytest.approx(1 - 3.5 / 5)


def test_decode_step():
    stages = [stage("decode", 0.0, 0.08, rounds=8), stage("decode", 0.1, 0.12, rounds=2),
              stage("prefill", 0.2, 0.3, tokens=500), stage("mixed", 0.3, 0.35, chunk_tokens=100),
              stage("decode", 4.9, 5.1, rounds=8)]
    assert yardstick.decode_step_ms(stages, 5.0) == pytest.approx(10.0)


def test_flops_count_routed_experts_only_and_closed_form_pairs():
    arch = dict(n_experts=8, experts_per_token=2, d_model=4, vocab_size=10, head_dim=2,
                n_heads=3, n_layers=5)
    numel = {"embed.embedding": 40, "embed.unembed": 40, "blocks.wq": 100,
             "blocks.moe.router": 32, "blocks.moe.w_up": 800, "norm_final.scale": 4}
    c = yardstick.flop_counts(arch, numel)
    assert c == {"per_token": 2 * (100 + 32 + 800 * 2 / 8), "per_sample": 80.0, "per_pair": 120.0}
    r = req(0.0, [0.1, 0.2, 0.3, 9.0], n_prefill=5)
    brute = c["per_token"] * 5 + c["per_pair"] * 15 + c["per_sample"] * 3
    brute += sum(c["per_token"] + c["per_pair"] * (5 + i) for i in (1, 2))
    assert yardstick.window_flops([r], 1.0, c) == pytest.approx(brute)


def test_frozen_bounds_equal_chip_smokes():
    cs = _chip_smoke()
    b, h, kv, d, pages, page, mb = 6, 36, 4, 128, 64, 16, 12
    q = torch.zeros(b, 1, h, d, dtype=torch.bfloat16)
    k = torch.zeros(kv, pages, page, d, dtype=torch.bfloat16)
    tables = torch.zeros(b, mb, dtype=torch.int32)
    lengths = torch.tensor([0, 17, 130, 0, 191, 3], dtype=torch.int32)
    want, _ = cs.decode_bound(q, k, tables, lengths)
    got = yardstick.decode_bound_ms(b, h, d, kv, 2, tables.numel(), [17, 130, 191, 3])
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("kind", ["backlog"])
def test_kernel_calls_replay_the_serves_calls(kind, monkeypatch):
    """Every kernel 1 call of a CPU serve, recorded at its wrapper with
    chip_smoke's formula, equals the yardstick's replay from the stage
    records and token stamps."""
    from repro_torch.models import transformer

    cs = _chip_smoke()
    cell = smoke_cell.cell(False)
    built = bench.build(cell, 77, torch.device("cpu"))
    seen = []
    dec = transformer.paged_decode_attention

    def k1(q, kc, vc, tables, lengths, **kw):
        seen.append(cs.decode_bound(q, kc, tables, lengths)[0])
        return dec(q, kc, vc, tables, lengths, **kw)

    monkeypatch.setattr(transformer, "paged_decode_attention", k1)
    rec = bench.drive(built["engine"], cell, 77, 2.0, lambda: None)
    n_prefill = {r.rid: r.n_prefill for r in rec.reqs.values()}
    got = []
    for sess in sorted({s.session for s in rec.steps}):
        got += yardstick.kernel_calls([s for s in rec.steps if s.session == sess], n_prefill,
                                      cell.engine, cell.arch)
    assert seen and any(s.stage.kind == "mixed" for s in rec.steps)
    assert got == pytest.approx(seen, rel=1e-9)
