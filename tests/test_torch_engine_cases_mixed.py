"""The engine-level greedy cases of the reference's ``tests/test_mixed_batch.py``
and ``tests/test_overload.py``, on the port's engine (float32 smoke Qwen3,
the cost model pinned): mixed steps give the alternating schedule's tokens
without its stall, the Lagrangian share drives a valid serve, a chunk lands
in the round a decode row hits EOS, a checkpoint between mixed rounds
restores a mid-chunk cursor, a pure-decode workload keeps the fused path,
arrivals mid-serve give the closed-loop streams, preemption at any pool size
gives the roomy pool's streams, and the SLO-aware admission policy (under
the scripted clock: it decides from engine time) lets an online request
bypass the deferred offline head. Each test keeps the reference's name."""
import numpy as np

from repro_torch.core import (
    ArrivalQueueScheduler,
    CostModel,
    GlobalQueueScheduler,
    LagrangianPolicy,
    PrefillFirstPolicy,
    Request,
    StageKind,
    build_clients,
)
from repro_torch.data import WorkloadSpec, gsm8k_like_workload
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.overload import SLOAwareOverloadPolicy
from torch_port_engine import weights
from torch_port_helpers import scripted_clock

CM = CostModel(level_caps=(32, 64, 128))
# multi-chunk prompts next to decode-heavy outputs (test_mixed_batch.py's SPEC)
SPEC = WorkloadSpec(n_requests=10, input_mean=30, input_std=20, output_mean=10,
                    output_std=6, output_max=16, input_max=60)


def _engine(mixed=True, overload=None, **kw):
    model, params = weights()[2:]
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", 80)
    kw.setdefault("prefill_seq_buckets", (32, 64))
    kw.setdefault("page_size", 16)
    kw.setdefault("prefill_chunk", 16)
    kw.setdefault("num_pages", 24)
    eng = Engine(model, params, EngineConfig(kv_layout="paged", mixed_schedule=mixed, **kw),
                 overload_policy=overload, device="cpu")
    eng.profiler.cost_model = CM
    return eng


def _serve(eng, seed=5, policy=None, reqs=None, scheduler=None):
    reqs = reqs or gsm8k_like_workload(SPEC, seed=seed, known_lengths=True)
    clients = build_clients(eng.cfg.n_slots, reqs, None)
    tr = eng.serve(reqs, clients, scheduler or GlobalQueueScheduler(reqs),
                   policy or PrefillFirstPolicy())
    tr.validate()
    return tr


# --------------------------------------------------------------------------- #
# tests/test_mixed_batch.py                                                   #
# --------------------------------------------------------------------------- #
def test_mixed_matches_alternating_greedy():
    alt = _engine(mixed=False)
    tr_a = _serve(alt)
    mix = _engine(mixed=True)
    tr_m = _serve(mix)
    assert alt.generated == mix.generated
    assert alt.prefill_stall_time > 0.0 and mix.prefill_stall_time == 0.0
    assert mix.mixed_rounds > 0 and alt.mixed_rounds == 0
    assert StageKind.MIXED in {s.kind for s in tr_m.stages}
    assert StageKind.MIXED not in {s.kind for s in tr_a.stages}
    s = tr_m.summary()
    assert s["mixed_rounds"] == mix.mixed_rounds and s["prefill_stall_time_s"] == 0.0
    assert tr_a.summary()["prefill_stall_time_s"] > 0.0


def test_mixed_lagrangian_share_serves_valid_trace():
    eng = _engine(mixed=True)
    tr = _serve(eng, seed=6, policy=LagrangianPolicy())
    assert eng.mixed_rounds > 0 and eng.prefill_stall_time == 0.0
    assert any(s.kind is StageKind.MIXED and s.chunk_tokens and s.tokens > s.chunk_tokens
               for s in tr.stages)


def _co_occurrence_eos(stream_a):
    """(EOS, the round A stops in): the reference's test stops A on
    ``stream_a[3]``, in the round B's last chunk lands. A stream stops at the
    first *decoded* occurrence of its EOS (index >= 1; the prefill's token
    is not checked), and on another model ``stream_a[3]`` may occur earlier:
    take the latest index <= 3 that is its token's first decoded
    occurrence."""
    for i in (3, 2, 1):
        if stream_a.index(stream_a[i], 1) == i:
            return stream_a[i], i
    raise AssertionError(f"no usable EOS in {stream_a[:4]}")


def test_chunk_completes_in_round_a_decode_row_hits_eos():
    ref = _engine()
    _serve(ref, reqs=[Request(rid=0, n_prefill=8, n_decode=12)])
    stream_a = ref.generated[0]
    ref_b = _engine()
    _serve(ref_b, reqs=[Request(rid=1, n_prefill=40, n_decode=4)])
    stream_b = ref_b.generated[1]
    eos, cut = _co_occurrence_eos(stream_a)
    # B's chunks land in rounds 1..3 (16 + 16 + 8); A stops in round ``cut``
    chunks = (16, 16, 8)

    eng = _engine(eos_id=int(eos))
    a = Request(rid=0, n_prefill=8, n_decode=12)
    b = Request(rid=1, n_prefill=40, n_decode=4)
    clients = build_clients(4, [a, b], None)
    eng._start_chunked_batch([(clients[0], a)], 0, 0.0)
    plan, _ = eng._plan_mixed_round([], 8)
    _, _, _, _, fin, _, _ = eng._run_mixed_stage(plan)
    assert fin == [0]
    eng._start_chunked_batch([(clients[1], b)], 1, 0.0)
    for idx in range(1, cut + 1):
        plan, _ = eng._plan_mixed_round([], 16)
        dt, fin_dec, dec_tok, chunk_tok, fin_chunks, busy, busy_partial = (
            eng._run_mixed_stage(plan))
        assert dec_tok == 1 and chunk_tok == chunks[idx - 1]
        if idx < cut:
            assert not fin_dec and not fin_chunks and busy_partial == {1: 1}
        else:
            assert fin_dec == [0]
            assert fin_chunks == ([1] if cut == 3 else [])
    assert eng.generated[0] == stream_a[: cut + 1]
    eng.slots.release(0)
    while eng._chunking:                             # B's remaining chunks alone
        eng._run_chunk_round()
    assert eng.generated[1] == stream_b[:1]
    eng._run_decode_stage(3)
    assert eng.generated[1] == stream_b[:4]


def test_checkpoint_restore_between_mixed_rounds_mid_chunk():
    a = Request(rid=0, n_prefill=8, n_decode=12)
    b = Request(rid=1, n_prefill=40, n_decode=6)
    eng = _engine()
    clients = build_clients(4, [a, b], None)
    eng._start_chunked_batch([(clients[0], a)], 0, 0.0)
    eng._run_mixed_stage(eng._plan_mixed_round([], 8)[0])       # A bound
    eng._start_chunked_batch([(clients[1], b)], 1, 0.0)
    eng._run_mixed_stage(eng._plan_mixed_round([], 16)[0])      # A +1, B at 16
    assert eng._chunking[1].done == 16

    eng2 = _engine()
    eng2.warm_serving_shapes()
    eng2.load_state_dict(eng.state_dict(), {0: a, 1: b})
    assert eng2._chunking[1].done == 16 and eng2.slots.emitted[0] == 2
    for e in (eng, eng2):
        for _ in range(2):
            e._run_mixed_stage(e._plan_mixed_round([], 16)[0])
    assert eng2.generated[0] == eng.generated[0][2:]
    assert eng2.generated[1] == eng.generated[1]
    assert eng._chunking == {} and eng2._chunking == {}
    for k in eng.slots.cache:
        np.testing.assert_array_equal(eng.slots.cache[k].numpy(), eng2.slots.cache[k].numpy())


def test_pure_decode_fast_path_unchanged():
    def reqs():
        return [Request(rid=i, n_prefill=12, n_decode=d) for i, d in enumerate((10, 13, 7, 9))]

    alt = _engine(mixed=False)
    tr_a = _serve(alt, reqs=reqs())
    mix = _engine(mixed=True)
    tr_m = _serve(mix, reqs=reqs())
    assert alt.generated == mix.generated
    assert mix.decode_dispatches == alt.decode_dispatches
    assert mix.decoded_tokens == alt.decoded_tokens and mix.mixed_rounds == 0
    assert [(s.kind, s.rounds) for s in tr_m.stages] == [(s.kind, s.rounds) for s in tr_a.stages]


def test_engine_serves_poisson_arrivals():
    base = [Request(rid=i, n_prefill=10 + 3 * i, n_decode=6 + i) for i in range(5)]
    closed = _engine()
    _serve(closed, reqs=[Request(r.rid, r.n_prefill, r.n_decode) for r in base])
    eng = _engine()
    reqs = [Request(r.rid, r.n_prefill, r.n_decode) for r in base]
    for r, arr in zip(reqs, (0.0, 0.005, 0.005, 0.01, 1e9)):
        r.arrival = arr
    tr = eng.serve(reqs, build_clients(4, reqs, None), ArrivalQueueScheduler(reqs),
                   LagrangianPolicy())
    tr.validate()
    assert eng.generated == closed.generated
    assert reqs[-1].t_prefill_start is None or reqs[-1].t_done >= 1e9


# --------------------------------------------------------------------------- #
# tests/test_overload.py                                                      #
# --------------------------------------------------------------------------- #
def _overload_engine(**kw):
    return _engine(**{**dict(n_slots=2, max_len=64, prefill_seq_buckets=(32,), num_pages=None),
                      **kw})


def _assert_page_ownership(slots):
    owned = [p for t in slots.tables for p in t]
    assert len(owned) == len(set(owned))
    slots.allocator.check_consistency()


def test_preemption_streams_bit_identical_across_pool_sizes():
    def reqs():
        return [Request(rid=i, n_prefill=12, n_decode=16 + 6 * (i % 3)) for i in range(6)]

    def serve_with_pool(num_pages):
        eng = _overload_engine(n_slots=4, page_size=8, num_pages=num_pages)
        trace = _serve(eng, reqs=reqs(), policy=LagrangianPolicy())
        _assert_page_ownership(eng.slots)
        assert eng.slots.allocator.num_used == 0
        return eng, trace

    ref_eng, _ = serve_with_pool(None)
    assert ref_eng.preemption_events == 0
    preempted = False
    for num_pages in (16, 14, 12, 10):
        eng, _ = serve_with_pool(num_pages)
        assert eng.generated == ref_eng.generated, f"num_pages={num_pages}"
        preempted |= eng.preemption_events > 0
    assert preempted, "sweep never exercised preemption"


def test_deferred_offline_head_does_not_starve_online():
    with scripted_clock():
        eng = _overload_engine()
        warm = [Request(rid=i, n_prefill=12, n_decode=8) for i in range(4)]
        _serve(eng, reqs=warm, policy=LagrangianPolicy(), scheduler=ArrivalQueueScheduler(warm))
        eng.warm_serving_shapes()
        pol = SLOAwareOverloadPolicy()
        eng.overload = pol
        reqs = [Request(rid=i, n_prefill=12, n_decode=8) for i in range(4)]
        reqs.append(Request(rid=100, n_prefill=12, n_decode=8, arrival=1e-7, ttft_slo_s=10.0))
        trace = eng.serve(reqs, build_clients(2, reqs, None), ArrivalQueueScheduler(reqs),
                          LagrangianPolicy())
    trace.validate()
    assert pol.deferrals > 0, "policy never engaged"
    online = next(r for r in trace.requests if r.rid == 100)
    offline_starts = sorted(r.t_prefill_start for r in trace.requests if r.rid != 100)
    assert online.t_prefill_start < offline_starts[-1]
