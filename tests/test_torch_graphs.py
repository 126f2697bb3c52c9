"""The engine's captured dispatches (``serving.graphs``) on the CPU, where
each prepared dispatch runs its function on its static buffers in place of
a replay:

* ``warm_serving_shapes`` prepares exactly the keys ``_choose_horizon`` and
  ``_bucket`` can reach, for pinned, capped and default horizons on both
  layouts, and a dense sequence bucket past ``max_len`` still fails at
  serve time;
* stages that change key every time (paged: chunk, K 8, K 4, mixed, chunk,
  K 2; dense: prefill, K 8, prefill, K 2, K 4) give the JAX engine's
  streams from the same calls, the pending tokens carried from decode to
  decode in the engine's own buffer;
* the split scratch sized for an engine covers every plan its dispatches
  hand the decode kernels, at the H100's 132 SMs;
* a replay adds the launches its dispatch recorded, whatever the call
  itself counts (on the card a replay counts nothing on the host), runs
  the owner's view refresh first, and a key never prepared raises;
* the pool, slot cache and pending buffer are never reassigned: restore,
  migration and serves update them in place."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import Request, build_clients
from repro_torch.kernels import decode_attention, flash_attention, paged_decode_attention, rglru
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving import graphs
from repro_torch.serving.engine import Engine, EngineConfig, _bucket
from repro_torch.serving.graphs import Dispatches, Key, decode_scratch
from torch_port_engine import DENSE, PAGED, PORT, REF, engine, fcfs, gsm8k, run, scripted_clock
from torch_port_helpers import CFG

HORIZONS = {"default": {}, "pinned": dict(decode_horizon=6), "capped": dict(max_decode_horizon=5)}


def _reachable(eng):
    """Keys found by driving ``_choose_horizon`` over every policy horizon
    and remaining budget, halving as page pressure does, and ``_bucket``
    over every row count."""
    cfg = eng.cfg
    horizons = set()
    for policy in range(1, 20):
        for rem in range(1, 20):
            eng._decode_budget = lambda slot, rem=rem: rem
            eng.slots.request_of[0] = object()       # one active slot
            k = eng._choose_horizon(policy)
            while True:
                horizons.add(k)
                if cfg.decode_horizon is not None or k == 1:
                    break
                k //= 2                               # _ensure_decode_capacity's shrink
    eng.slots.request_of[0] = None
    del eng._decode_budget
    st = eng._base_key is not None
    rows = {_bucket(r, cfg.prefill_req_buckets) for r in range(1, cfg.n_slots + 1)}
    keys = {Key("decode", (k,), st) for k in horizons}
    if cfg.kv_layout == "paged":
        keys |= {Key(kind, (r,), st) for r in rows for kind in ("chunk", "mixed")}
    else:
        keys |= {Key("prefill", (r, s), st) for r in rows for s in cfg.prefill_seq_buckets
                 if s <= cfg.max_len}
    return keys


@pytest.mark.parametrize("horizon", list(HORIZONS))
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_prepared_keys_are_the_reachable_keys(layout, horizon):
    kw = dict({"paged": PAGED, "dense": DENSE}[layout], **HORIZONS[horizon])
    eng = engine(PORT, kw)
    eng.warm_serving_shapes()
    assert eng.graphs.keys == _reachable(eng) == eng.serving_keys()
    assert eng.graphs.captures == 0            # the CPU captures nothing


def test_dense_bucket_past_max_len_fails_at_serve_time():
    eng = engine(PORT, dict(DENSE, max_len=40, prefill_seq_buckets=(32, 64)))
    eng.warm_serving_shapes()                  # prepares the (r, 32) pairs only
    assert {k.shape[1] for k in eng.graphs.keys if k.kind == "prefill"} == {32}
    reqs = [Request(rid=0, n_prefill=50, n_decode=4)]
    with pytest.raises(RuntimeError):
        run(eng, reqs, fcfs(PORT, reqs))


# --------------------------------------------------------------------------- #
# Changing key every stage, against the reference's same calls                #
# --------------------------------------------------------------------------- #
def _paged_script(pkg, eng, log):
    a = pkg.core.Request(rid=0, n_prefill=12, n_decode=30)
    b = pkg.core.Request(rid=1, n_prefill=40, n_decode=12)
    clients = pkg.core.build_clients(4, [a, b], None)
    eng._start_chunked_batch([(clients[0], a)], 0, 0.0)
    eng._run_chunk_round()                              # chunk: A bound
    eng._run_decode_stage(8)                            # K 8
    eng._run_decode_stage(4)                            # K 4, tokens carried
    log.append(eng._pending_dev_valid if pkg is PORT else None)
    eng._start_chunked_batch([(clients[1], b)], 1, 0.0)
    eng._run_mixed_stage(eng._plan_mixed_round([], 16)[0])   # mixed: A + B's chunk
    stages = 4
    while eng._chunking:
        eng._run_chunk_round()                          # chunk: B bound
        stages += 1
    eng._run_decode_stage(2)                            # K 2
    return stages + 1


def _dense_script(pkg, eng, log):
    reqs = [pkg.core.Request(rid=i, n_prefill=10 + 5 * i, n_decode=20) for i in range(3)]
    clients = pkg.core.build_clients(4, reqs, None)
    eng._run_prefill_stage([(clients[0], reqs[0]), (clients[1], reqs[1])])   # prefill (2, 32)
    eng._run_decode_stage(8)                            # K 8
    eng._run_prefill_stage([(clients[2], reqs[2])])     # prefill (1, 32)
    eng._run_decode_stage(2)                            # K 2
    eng._run_decode_stage(4)                            # K 4, tokens carried
    log.append(eng._pending_dev_valid if pkg is PORT else None)
    return 5


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_changing_keys_give_the_reference_streams(layout):
    kw = {"paged": PAGED, "dense": DENSE}[layout]
    script = {"paged": _paged_script, "dense": _dense_script}[layout]
    out, log = {}, []
    with scripted_clock():
        for pkg in (REF, PORT):
            eng = engine(pkg, kw)
            stages = script(pkg, eng, log)
            out[pkg] = eng
    eng = out[PORT]
    assert eng.generated == out[REF].generated
    assert len(eng.generated) == {"paged": 2, "dense": 3}[layout]
    assert all(len(v) > 2 for v in eng.generated.values())
    # a decode leaves its last tokens in the engine's buffer, equal to the
    # host's pending tokens, and the next decode reads them from there
    assert log == [None, True]
    active = eng.slots.active_slots
    assert eng._pending_dev[active].tolist() == eng.pending_token[active].tolist()
    kinds = {k.kind for k in eng.graphs.keys}
    assert kinds == ({"chunk", "decode", "mixed"} if layout == "paged" else {"prefill", "decode"})
    assert eng.graphs.replays == stages


# --------------------------------------------------------------------------- #
# The split scratch                                                           #
# --------------------------------------------------------------------------- #
N_SMS = 132


@pytest.mark.parametrize("dtype,head_dim", [("float32", 0), ("bfloat16", 64)])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_scratch_covers_every_captured_plan(monkeypatch, layout, dtype, head_dim):
    """Record the shapes every dispatch hands the decode kernels (their
    plain versions run here) and hold each shape's plan at 132 SMs against
    the scratch the engine reserves: the CUDA-core body (float32, head_dim
    16) and the tensor-core one (bf16, head_dim 64)."""
    seen = []
    plain_paged = paged_decode_attention.paged_decode_attention_plain
    plain_dense = decode_attention.decode_attention_plain

    def paged(q, k_pages, v_pages, tables, lengths, **kw):
        b, _, h, d = q.shape
        seen.append(paged_decode_attention.decode_plan(
            b, h, k_pages.shape[0], tables.shape[1], k_pages.shape[2], N_SMS).scratch(
                b, k_pages.shape[0], d))
        return plain_paged(q, k_pages, v_pages, tables, lengths, **kw)

    def dense(q, k, v, lengths, **kw):
        b, h, d = q.shape
        seen.append(decode_attention.plan(q.dtype, b, h, k.shape[1], k.shape[2], d, N_SMS)
                    .split.scratch(b, k.shape[1], d))
        return plain_dense(q, k, v, lengths, **kw)

    monkeypatch.setattr(paged_decode_attention, "paged_decode_attention_plain", paged)
    monkeypatch.setattr(decode_attention, "decode_attention_plain", dense)
    cfg = dataclasses.replace(CFG, dtype=dtype, head_dim=head_dim)
    model = TransformerLM(cfg, device="cpu")
    kw = dict({"paged": PAGED, "dense": dict(DENSE, max_len=640)}[layout], n_slots=8)
    eng = Engine(model, model.init_params(seed=0), EngineConfig(**kw), device="cpu")
    eng.warm_serving_shapes()
    reqs = gsm8k(PORT, n_requests=10)
    run(eng, reqs, (build_clients(8, reqs, None),) + fcfs(PORT, reqs)[1:])
    reserved = decode_scratch(eng.slots.cache, cfg.n_heads, N_SMS)
    assert seen and reserved[1] > 0, "the case should split: it checks nothing unsplit"
    assert all(f <= reserved[0] and c <= reserved[1] for f, c in seen)
    assert set(seen) == {reserved}              # every lane sees the engine's one shape


# --------------------------------------------------------------------------- #
# Launch accounting and unprepared keys                                       #
# --------------------------------------------------------------------------- #
def test_replay_adds_the_recorded_launches():
    """A stub dispatch bumps the scan's and flash's counters on its first
    call only, as a capture does on the card (the eager call runs kernels;
    replays count nothing on the host): every replay still adds them."""
    calls = []

    def build(key):
        def fn(x):
            if not calls:
                rglru.launch_count += 3
                flash_attention.launch_count += 2
                flash_attention.launch_count_by_variant["tensor_cores"] += 2
            calls.append(1)
            x["out"].copy_(x["inp"] * 2)
            return x["out"]
        return dict(inp=torch.zeros(4), out=torch.zeros(4)), fn

    rglru.reset_launch_count()
    flash_attention.reset_launch_count()
    d = Dispatches(torch.device("cpu"), build)
    key = Key("decode", (1,), False)
    d.prepare(key)
    assert (rglru.launch_count, flash_attention.launch_count) == (3, 2)
    for i in range(5):
        out = d.run(key, inp=np.full(4, i, np.float32))
        assert out.tolist() == [2.0 * i] * 4
    assert rglru.launch_count == 3 * 6 and flash_attention.launch_count == 2 * 6
    assert flash_attention.launch_count_by_variant == {"cuda_cores": 0, "tensor_cores": 12}
    assert d.replays == 5 and len(calls) == 6
    d.prepare(key)                                      # prepared once
    assert len(calls) == 6
    rglru.reset_launch_count()
    flash_attention.reset_launch_count()


def test_replay_runs_the_refresh_first():
    """The owner's ``refresh`` (a model's ``refresh_views``) runs before
    every replay, not at prepare: a replay reads views no older than the
    parameters."""
    order = []

    def build(key):
        return dict(x=torch.zeros(1)), lambda x: order.append("call")

    d = Dispatches(torch.device("cpu"), build, refresh=lambda: order.append("refresh"))
    key = Key("decode", (1,), False)
    d.prepare(key)
    assert order == ["call"]
    d.replay(key)
    d.run(key, x=np.ones(1, np.float32))
    assert order == ["call", "refresh", "call", "refresh", "call"]


def test_unprepared_key_raises():
    eng = engine(PORT, PAGED)
    key = Key("decode", (3,), False)
    with pytest.raises(KeyError, match="never prepared"):
        eng.graphs.replay(key)
    with pytest.raises(KeyError, match="never prepared"):
        eng.graphs.load(key, active=np.zeros(4, bool))
    with pytest.raises(ValueError, match="unknown dispatch kind"):
        eng.graphs.prepare(Key("verify", (1,), False))


# --------------------------------------------------------------------------- #
# State updated in place                                                      #
# --------------------------------------------------------------------------- #
def _pointers(eng):
    return {k: t.data_ptr() for k, t in eng.slots.cache.items()} | {
        "pending": eng._pending_dev.data_ptr()}


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_state_is_updated_in_place(layout):
    kw = {"paged": PAGED, "dense": DENSE}[layout]
    eng = engine(PORT, kw)
    eng.warm_serving_shapes()
    before = _pointers(eng)
    with scripted_clock():
        reqs = gsm8k(PORT)
        run(eng, reqs, fcfs(PORT, reqs), steps=6)
        state = eng.state_dict()
        eng.load_state_dict(state, {r.rid: r for r in reqs})
        if layout == "paged":
            slot = eng.slots.active_slots[0]
            eng.import_slot(eng.export_slot(slot))
        while eng.serve_step() != "done":
            pass
        eng.finish_serve()
    assert _pointers(eng) == before
    assert eng.graphs.keys == eng.serving_keys()       # no stage prepared a new key
    assert graphs.KERNELS["rglru_scan"] is rglru
