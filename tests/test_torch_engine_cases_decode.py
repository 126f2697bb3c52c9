"""The engine-level greedy cases of the reference's ``tests/test_paged.py``
and ``tests/test_fused_decode.py``, on the port's engine (float32 smoke
Qwen3, 4 slots, the cost model pinned): paged serves give the dense
layout's tokens in fewer KV bytes, the alternating Lagrangian schedule
prices chunks, checkpoints restore the pool, a mid-chunk cursor and the
straggler state, idle slots admit while a long prompt chunks; fused decode
gives the per-token streams on both layouts and on a ring cache, a slot
that stops mid-horizon freezes while its batch-mates decode on, an EOS
mid-horizon ends its stream there, and a checkpoint at a horizon boundary
continues as the original does. Each test keeps the reference's name."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs.base import ArchConfig
from repro_torch.core import (
    BalancedLagrangianPolicy,
    CostModel,
    GlobalQueueScheduler,
    PrefillFirstPolicy,
    Request,
    build_clients,
)
from repro_torch.data import WorkloadSpec, gsm8k_like_workload
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.engine import Engine, EngineConfig
from torch_port_engine import weights
from torch_port_helpers import CFG

CM = CostModel(level_caps=(32, 64, 128))
# mixed prompt lengths (test_paged.py's MIXED_SPEC)
MIXED_SPEC = WorkloadSpec(n_requests=10, input_mean=30, input_std=20, output_mean=10,
                          output_std=6, output_max=16, input_max=60)
# test_fused_decode.py's SPEC: slots stop at different iterations of a horizon
FUSED_SPEC = WorkloadSpec(n_requests=10, input_mean=18, input_std=6, output_mean=12,
                          output_std=8, output_max=24, input_max=28)


def _model():
    return weights()[2:]


def _engine(layout, model=None, params=None, **kw):
    if model is None:
        model, params = _model()
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", 80)
    kw.setdefault("prefill_seq_buckets", (32, 64))
    eng = Engine(model, params, EngineConfig(kv_layout=layout, **kw), device="cpu")
    eng.profiler.cost_model = CM
    return eng


def _paged(**kw):
    return _engine("paged", **{**dict(page_size=16, prefill_chunk=24, num_pages=16), **kw})


def _serve(eng, spec=MIXED_SPEC, seed=3, policy=None, reqs=None):
    reqs = reqs or gsm8k_like_workload(spec, seed=seed, known_lengths=True)
    clients = build_clients(4, reqs, None)
    tr = eng.serve(reqs, clients, GlobalQueueScheduler(reqs), policy or PrefillFirstPolicy())
    tr.validate()
    return tr


def _fused(horizon, layout="dense", model=None, params=None, **kw):
    if layout == "paged":
        kw.update(page_size=16, prefill_chunk=24, num_pages=16)
    return _engine(layout, model, params, max_len=64, prefill_seq_buckets=(32,),
                   decode_horizon=horizon, **kw)


def _same_cache(a, b):
    for k in a.slots.cache:
        np.testing.assert_array_equal(a.slots.cache[k].numpy(), b.slots.cache[k].numpy())


# --------------------------------------------------------------------------- #
# tests/test_paged.py                                                         #
# --------------------------------------------------------------------------- #
def test_engine_paged_matches_dense_tokens():
    eng_d = _engine("dense")
    _serve(eng_d, seed=5)
    eng_p = _paged()
    tr_p = _serve(eng_p, seed=5)
    assert eng_d.generated == eng_p.generated
    dense_bytes = eng_d.slots.cache["k"].nbytes + eng_d.slots.cache["v"].nbytes
    assert eng_p.slots.kv_bytes_capacity() < dense_bytes
    assert eng_p.slots.allocator.num_free == eng_p.slots.allocator.num_pages
    assert any(s.busy_partial for s in tr_p.stages)


def test_engine_paged_lagrangian_chunk_pricing():
    eng = _paged(mixed_schedule=False)
    tr = _serve(eng, seed=6, policy=BalancedLagrangianPolicy())
    assert tr.utilization > 0.2
    kinds = [s.kind.value for s in tr.stages]
    assert "prefill" in kinds and "decode" in kinds


def test_engine_paged_checkpoint_roundtrip(tmp_path):
    eng = _paged()
    _serve(eng, seed=3)
    eng._budget_shift = 2
    eng.straggler_events = 5
    save_checkpoint(tmp_path, 1, eng.state_dict())
    eng2 = _paged()
    restored, _ = restore_checkpoint(tmp_path, 1, eng2.state_dict())
    reqs = gsm8k_like_workload(MIXED_SPEC, seed=3, known_lengths=True)
    eng2.load_state_dict(restored, {r.rid: r for r in reqs})
    assert eng2._budget_shift == 2 and eng2.straggler_events == 5
    _same_cache(eng, eng2)
    assert eng2.slots.tables == eng.slots.tables
    assert eng2.slots.allocator.num_free == eng.slots.allocator.num_free


def test_engine_paged_checkpoint_restores_mid_chunk_state():
    eng = _paged(prefill_chunk=16)
    req = Request(rid=0, n_prefill=40, n_decode=4)
    clients = build_clients(4, [req], None)
    eng._start_chunked_batch([(clients[0], req)], 0, 0.0)
    eng._run_chunk_round()                        # done = 16 < 40
    assert eng._chunking[0].done == 16
    eng2 = _paged(prefill_chunk=16)
    eng2.load_state_dict(eng.state_dict(), {0: req})
    assert eng2._chunking[0].done == 16 and eng2._chunking[0].req is req
    assert eng2.slots.tables[0] == eng.slots.tables[0]
    assert eng2.slots.allocator.num_free == eng.slots.allocator.num_free


def test_engine_paged_admits_while_chunking():
    reqs = [Request(rid=0, n_prefill=60, n_decode=12),   # 3 chunks of 24
            Request(rid=1, n_prefill=10, n_decode=12),
            Request(rid=2, n_prefill=10, n_decode=12)]
    eng = _engine("paged", page_size=16, prefill_chunk=24, num_pages=20)
    tr = eng.serve(reqs, build_clients(4, reqs, None), GlobalQueueScheduler(reqs),
                   PrefillFirstPolicy())
    tr.validate()
    assert any(s.busy and s.busy_partial for s in tr.stages)


def test_engine_dense_checkpoint_keeps_straggler_state():
    eng = _engine("dense")
    eng._budget_shift = 1
    eng.straggler_events = 3
    eng2 = _engine("dense")
    reqs = gsm8k_like_workload(MIXED_SPEC, seed=3, known_lengths=True)
    eng2.load_state_dict(eng.state_dict(), {r.rid: r for r in reqs})
    assert eng2._budget_shift == 1 and eng2.straggler_events == 3


# --------------------------------------------------------------------------- #
# tests/test_fused_decode.py                                                  #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_fused_greedy_matches_per_token(layout):
    base = _fused(1, layout)
    _serve(base, FUSED_SPEC, seed=0)
    fused = _fused(8, layout)
    _serve(fused, FUSED_SPEC, seed=0)
    assert base.generated == fused.generated
    assert fused.decode_dispatches < base.decode_dispatches
    assert fused.decode_dispatches / fused.decoded_tokens < 0.3


def test_fused_ring_cache_matches_per_token():
    cfg = dataclasses.replace(CFG, name="swa", sliding_window=24)
    model = TransformerLM(cfg, device="cpu")
    params = model.init_params(seed=1)
    base = _fused(1, model=model, params=params)
    _serve(base, FUSED_SPEC, seed=0)
    fused = _fused(4, model=model, params=params)
    _serve(fused, FUSED_SPEC, seed=0)
    assert base.generated == fused.generated
    assert isinstance(cfg, ArchConfig) and "pos" in fused.slots.cache


def test_slot_stopping_mid_horizon_is_noop_not_early_exit():
    def run(k):
        reqs = [Request(rid=0, n_prefill=8, n_decode=2),    # stops at iteration 1
                Request(rid=1, n_prefill=9, n_decode=14)]   # spans two horizons
        eng = _fused(k)
        tr = eng.serve(reqs, build_clients(4, reqs, None), GlobalQueueScheduler(reqs),
                       PrefillFirstPolicy())
        tr.validate()
        return eng, tr

    base, _ = run(1)
    fused, tr = run(8)
    assert fused.generated == base.generated
    assert len(fused.generated[0]) == 2 and len(fused.generated[1]) == 14
    decode_stages = [s for s in tr.stages if s.kind.value == "decode"]
    assert len(decode_stages) < 14
    assert any(s.tokens < s.rounds * len(s.busy) for s in decode_stages)


def test_eos_mid_horizon_stops_stream():
    req = Request(rid=0, n_prefill=8, n_decode=12)
    base = _fused(1)
    base.serve([req], build_clients(4, [req], None), GlobalQueueScheduler([req]),
               PrefillFirstPolicy())
    stream = base.generated[0]
    eos = stream[5]                     # force a stop 6 tokens in
    cut = stream.index(eos)
    assert cut >= 1, "the EOS must be a decoded token, not the prefill's"

    req2 = Request(rid=0, n_prefill=8, n_decode=12)
    eng = _fused(8, eos_id=int(eos))
    clients = build_clients(4, [req2], None)
    eng._run_prefill_stage([(clients[0], req2)])
    _, finished, _ = eng._run_decode_stage(8)
    assert eng.generated[0] == stream[: cut + 1]
    assert finished == [0]


def test_checkpoint_restore_at_horizon_boundary(tmp_path):
    reqs = [Request(rid=0, n_prefill=8, n_decode=12), Request(rid=1, n_prefill=6, n_decode=12)]
    eng = _fused(4)
    clients = build_clients(4, reqs, None)
    eng._run_prefill_stage([(clients[0], reqs[0]), (clients[1], reqs[1])])
    eng._run_decode_stage(4)                      # horizon boundary
    save_checkpoint(tmp_path, 1, eng.state_dict())
    eng._run_decode_stage(4)                      # the original continues

    eng2 = _fused(4)
    eng2.warm_serving_shapes()
    restored, _ = restore_checkpoint(tmp_path, 1, eng2.state_dict())
    eng2.load_state_dict(restored, {r.rid: r for r in reqs})
    assert eng2.slots.emitted == [5, 5, 0, 0]     # 1 prefill + 4 decode tokens
    eng2._run_decode_stage(4)                     # the restored one continues
    for rid in (0, 1):
        assert eng2.generated[rid] == eng.generated[rid][5:9]
    _same_cache(eng, eng2)
    assert torch.equal(eng.slots.cache["length"], eng2.slots.cache["length"])
