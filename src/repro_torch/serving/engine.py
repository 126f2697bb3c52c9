"""The serving engine (counterpart of ``repro.serving.engine``): continuous
batching under PD Competition with the paper's hybrid offline-online
scheduler as the dispatch policy.

The same ``RequestScheduler`` (offline assignment / Algorithm 1 stealing)
and ``IterationPolicy`` (prefill-first / Lagrangian) objects as the
reference drive the port's model steps over one of two KV layouts:

  * ``kv_layout="dense"`` (the default, as in the reference): each slot owns
    a preallocated row of the slot cache. An iteration either runs a
    *prefill stage* — whole, bucket-padded prompts of the admitted batch in
    one ``model.prefill`` whose cache is merged into the slot rows; it
    preempts decoding, and ``prefill_stall_time`` counts what that costs the
    active slots — or a fused decode stage. This is the paper's binary
    stage choice, which the Lagrangian policy prices;
  * ``kv_layout="paged"``: prompts are split into ``prefill_chunk``-token
    chunks written straight into the slot's pages (``model.prefill_chunk``);
    with ``mixed_schedule=True`` (the default) every iteration with prefill
    work pending dispatches ONE mixed batch (``model.mixed_step``): the
    decode tokens of every active slot plus a policy-priced share of chunk
    tokens, so prefill piggybacks on decode instead of preempting it;
  * on either layout, iterations with no prefill in view run a fused
    multi-step decode (``model.decode_steps``): K iterations queued on the
    device, one host sync at the horizon boundary.

Where the reference calls ``jax.jit(..., donate_argnums=...)`` executables,
the port replays CUDA graphs (``serving.graphs``): one captured dispatch for
each key the scheduler can reach — fused decode per horizon, mixed and
chunk rounds per row bucket, the dense prefill per (request, sequence)
bucket pair — each with its static input buffers, over the pool and slot
cache, which every path updates in place. A key is captured the first time
a stage needs it, before the stage's clock starts, or all at once by
``warm_serving_shapes``. On a CPU engine the same dispatches run eagerly on
the same static buffers (the kernels' plain versions). Every stage
synchronises the device before it reads the clock (before the replay, and
through the host copy of its sampled tokens after it), so the online
profiler fits device time, not capture or launch latency.

A ``Fleet`` (``serving.fleet``) drives many engines' sessions interleaved
in virtual time through ``begin_serve`` / ``serve_step`` / ``finish_serve``,
the session clock (``clock`` / ``advance_clock``), live migration of a slot
by KV page-copy (``export_slot`` / ``import_slot``, as a ``SlotCheckpoint``)
and engine checkpoints (``state_dict`` / ``load_state_dict``, the cache as
CPU tensors: numpy has no bf16).

Stochastic samplers (``serving.sampler.TopPSampler``) draw from threefry
keys folded from ``(sample_seed, rid, token index)``, JAX's streams. With
``EngineConfig.observe`` set to a ``repro_torch.obs.Observation`` the serve
records the reference's spans, capacity samples, audit records and metrics.

Apart from that, every engine records the wall-clock spans of its own host
work (``Engine.host``, a ``repro_torch.obs.host.HostSpans``): one
``engine.step`` a ``serve_step``, its phases from scheduling through the
replay to the commit. They are always on, cost no ``Observation`` callback,
stay out of ``state_dict()`` (wall times do not repeat, and the reference has
none), and open profiler ranges only while a profiler records.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.iteration import CandidateBatch, IterationPolicy, SystemSnapshot
from ..core.online import RequestScheduler
from ..core.types import (
    ClientState,
    Request,
    ScheduleTrace,
    StageKind,
    StageRecord,
)
from ..obs.host import HostSpans
from .graphs import Dispatches, Key, decode_scratch, sm_count
from .kv_slots import PagedSlotManager, SlotManager
from .overload import OverloadPolicy
from .profiler import OnlineProfiler
from .sampler import fold_row_keys, greedy
from .threefry import seed_key

Tree = Any


@dataclasses.dataclass
class EngineConfig:
    """The reference's engine configuration, with the same field names and
    defaults. See ``repro.serving.engine.EngineConfig`` for each field."""

    n_slots: int = 8
    max_len: int = 256
    prefill_seq_buckets: Tuple[int, ...] = (32, 64, 128)
    prefill_req_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    eos_id: Optional[int] = None          # None → workload-driven stop
    max_stages: int = 200_000
    straggler_factor: float = 3.0
    kv_layout: str = "dense"              # "dense" | "paged"
    page_size: int = 16
    prefill_chunk: int = 32
    num_pages: Optional[int] = None
    page_reserve: str = "ondemand"        # "ondemand" | "upfront"
    max_decode_horizon: int = 8
    decode_horizon: Optional[int] = None
    mixed_schedule: bool = True
    mixed_token_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256)
    # PRNG seed for stochastic samplers. Token streams are reproducible as a
    # pure function of (seed, request id, token index) — independent of
    # horizon grouping, slot placement, batch composition, or KV layout.
    sample_seed: int = 0
    debug_invariants: Optional[bool] = None
    prefix_cache: bool = False
    cache_aware_pricing: bool = True
    # Observability sink (a ``repro_torch.obs.Observation``). None — the
    # default — is the zero-cost path: every emission site guards on a
    # single ``is not None``, so a disabled serve executes zero obs
    # callbacks. A Fleet shares the instance across its replicas.
    observe: Optional[Any] = None


# Declarations for the typed metrics registry mirroring the engine's
# ``trace.meta`` counters (units + help text; keys not listed here default
# to unit-less counters) — the reference's table.
_METRIC_SPECS: Dict[str, Tuple[str, str, str]] = {
    "mixed_rounds": ("counter", "", "mixed prefill+decode rounds dispatched"),
    "prefill_stall_time_s": (
        "counter", "s",
        "wall-clock decoders spent frozen behind preempting prefill stages",
    ),
    "decode_dispatches": ("counter", "", "fused decode dispatches"),
    "preemption_events": ("counter", "", "slots preempted by page eviction"),
    "peak_concurrency": (
        "gauge", "", "peak simultaneously in-flight requests on one replica",
    ),
    "offline_deferrals": (
        "counter", "", "offline admissions deferred by overload control",
    ),
    "recomputed_tokens": (
        "counter", "tokens", "tokens re-prefilled on recompute-on-resume",
    ),
    "migrations_in": ("counter", "", "slots imported by page-copy migration"),
    "migrations_out": ("counter", "", "slots exported by page-copy migration"),
    "cached_prefill_tokens": (
        "counter", "tokens", "prompt tokens served from the prefix cache",
    ),
    "shared_pages_peak": (
        "gauge", "pages", "peak KV pages shared read-only across slots",
    ),
    "cow_copies": ("counter", "pages", "copy-on-write page copies"),
    "decoded_tokens": ("counter", "tokens", "tokens decoded"),
}


def _bucket(x: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if x <= b:
            return b
    raise ValueError(
        f"value {x} exceeds the largest bucket {buckets[-1]}; a request "
        f"padded into it would silently overflow the batch — raise the "
        f"bucket table (EngineConfig.prefill_seq_buckets / "
        f"prefill_req_buckets) to cover the workload"
    )


def prompt_tokens(req: Request, vocab: int) -> np.ndarray:
    """Synthetic prompt tokens derived from the request id (and the prefix
    group for shared-prefix workloads) — the reference's derivation, so
    both engines see the same prompts."""
    n = req.n_prefill
    if req.prefix_group is not None and req.prefix_len > 0:
        head_rng = np.random.default_rng(10_000_019 + req.prefix_group)
        head = head_rng.integers(1, vocab, size=req.prefix_len).astype(np.int32)
        tail_rng = np.random.default_rng(req.rid)
        tail = tail_rng.integers(1, vocab, size=n - req.prefix_len).astype(np.int32)
        return np.concatenate([head, tail])
    rng = np.random.default_rng(req.rid)
    return rng.integers(1, vocab, size=n).astype(np.int32)


@dataclasses.dataclass
class _ServeSession:
    """Host-side state of one in-progress serve (the step-driven API)."""

    trace: ScheduleTrace
    clients: List[ClientState]
    scheduler: RequestScheduler
    policy: IterationPolicy
    t: float = 0.0
    bin_index: int = -1
    stages_run: int = 0
    # adopt requests into the trace as the scheduler commits them (fleet
    # dispatch and work stealing route requests in mid-serve)
    track_requests: bool = False


@dataclasses.dataclass
class _ChunkState:
    """One slot's in-flight chunked prefill. A *resumed* (previously
    preempted) request recomputes prompt + generated prefix in one pass and
    its final chunk restores ``(resume_emitted, resume_pending)`` instead of
    sampling, so the stream continues bit-identical."""

    slot: int
    req: Request
    prompt: np.ndarray
    done: int = 0
    resume_emitted: int = 0               # >0 → recompute of a preemptee
    resume_pending: int = -1              # pending token to restore at bind
    cached: int = 0                       # prompt tokens adopted from cache

    @property
    def total(self) -> int:
        return len(self.prompt)

    @property
    def remaining(self) -> int:
        return self.total - self.done


@dataclasses.dataclass
class SlotCheckpoint:
    """Portable mid-request slot state for live KV migration by page-copy
    (the reference's ``SlotCheckpoint``, field for field).

    ``Engine.export_slot`` gathers what a destination engine needs to
    continue the request with zero recomputed tokens: the slot's KV pages
    (page-id agnostic), the pending token, the sampler cursor (``emitted``),
    the generated prefix and, for a request migrated between prefill chunks,
    its chunk progress. ``prefill_credit`` counts the prefill completions the
    request performed on other traces (the importer records it in
    ``ScheduleTrace.external_prefills``). ``checksum`` is the payload's
    ``page_checksum``, verified at import; ``src_replica`` / ``src_epoch``
    are the exporter's lease, stamped by the fleet."""

    req: Request
    kind: str                             # "bound" | "chunking"
    emitted: int                          # sampler cursor (bound slots)
    pending_token: int                    # next decode round's input token
    kv_length: int                        # valid KV entries in the payload
    k_pages: Any                          # (L, KV, n_pages, page_size, D)
    v_pages: Any
    n_pages: int
    prefix: List[int]                     # every token generated so far
    prefill_credit: int
    chunk_done: int = 0                   # kind == "chunking" only
    resume_emitted: int = 0
    resume_pending: int = -1
    checksum: Optional[int] = None
    src_replica: int = -1
    src_epoch: int = -1


class Engine:
    def __init__(
        self,
        model,
        params: Tree,
        config: EngineConfig,
        profiler: Optional[OnlineProfiler] = None,
        sampler: Callable = greedy,
        speed_factor: float = 1.0,
        overload_policy: Optional[OverloadPolicy] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"model lives on {model.device}, engine asked for {self.device}"
            )
        if config.page_reserve not in ("ondemand", "upfront"):
            raise ValueError(f"unknown page_reserve {config.page_reserve!r}")
        if speed_factor <= 0:
            raise ValueError("speed_factor must be positive")
        self.model = model
        self.params = params
        self.cfg = config
        self.profiler = profiler or OnlineProfiler()
        self.sampler = sampler
        self.overload = overload_policy
        self.speed_factor = float(speed_factor)
        if config.prefix_cache and config.kv_layout != "paged":
            raise ValueError(
                "prefix_cache requires kv_layout='paged' — dense layout has "
                "no page identity to share"
            )
        if config.kv_layout == "paged":
            self.slots: Any = PagedSlotManager(
                model, config.n_slots, config.max_len,
                config.page_size, config.num_pages,
                prefix_cache=config.prefix_cache,
            )
        elif config.kv_layout == "dense":
            self.slots = SlotManager(model, config.n_slots, config.max_len)
        else:
            raise ValueError(f"unknown kv_layout {config.kv_layout!r}")
        # stochastic samplers draw per-row keys folded from this base key;
        # greedy engines carry no key (None skips the key plumbing)
        self._base_key = (
            seed_key(config.sample_seed, self.device)
            if getattr(sampler, "stochastic", False) else None
        )
        self.pending_token = np.zeros(config.n_slots, dtype=np.int32)
        # the decode and mixed dispatches' pending-token input, owned by the
        # engine: a decode graph leaves its last tokens here, so consecutive
        # decode stages carry them on the device; while it is not valid, the
        # next stage reloads it from the host array
        self._pending_dev = torch.zeros(config.n_slots, dtype=torch.int32, device=self.device)
        self._pending_dev_valid = False
        self._prefill_buf: Optional[Dict[str, torch.Tensor]] = None
        self.graphs = Dispatches(
            self.device, self._build_dispatch,
            scratch=(decode_scratch(self.slots.cache, model.cfg.n_heads, sm_count(self.device))
                     if self.device.type == "cuda" else (0, 0)),
            refresh=lambda: model.refresh_views(self.params),
        )
        self.decode_dispatches = 0
        self.decoded_tokens = 0
        self.mixed_rounds = 0
        self.prefill_stall_time = 0.0
        self._budget_shift = 0            # straggler mitigation state
        self.straggler_events = 0
        self._chunking: Dict[int, _ChunkState] = {}
        self._resume_rids: set = set()
        self.preemption_events = 0
        self.offline_deferrals = 0
        self.recomputed_tokens = 0
        self.migrations_in = 0
        self.migrations_out = 0
        self.cache_hit_tokens = 0
        self._use_prefix_cache = (
            config.kv_layout == "paged" and config.prefix_cache
        )
        self.debug_invariants = (
            config.debug_invariants
            if config.debug_invariants is not None
            else os.environ.get("REPRO_DEBUG_INVARIANTS", "") == "1"
        )
        self.peak_concurrency = 0
        # observability (repro_torch.obs.Observation); None keeps every
        # emission site dead. A Fleet sets obs_replica after construction.
        self.obs = config.observe
        self.obs_replica = 0
        # wall-clock spans of every serve_step's phases (repro_torch.obs.host)
        self.host = HostSpans()
        if config.kv_layout == "paged":
            self.slots.obs = self.obs
        # migrated-in slots awaiting their first post-import dispatch —
        # capacity attribution classifies that wait as "migration"
        self._mig_pending: set = set()
        # rid -> every token this engine sampled for it
        self.generated: Dict[int, List[int]] = {}
        self._sv: Optional[_ServeSession] = None

    # ------------------------------------------------------------------ #
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def _prompt_tokens(self, req: Request) -> np.ndarray:
        return prompt_tokens(req, self._vocab())

    def _sample_first(self, logits: torch.Tensor, rids: Sequence[int]) -> torch.Tensor:
        """Sample each prefill row's first token (token index 0 of its
        request): the fused loop's key derivation at index 0, so the stream
        is seamless. Pad rows are keyed by rid -1."""
        if self._base_key is None:
            return self.sampler(logits)
        n_pad = logits.shape[0]
        rid_vec = np.full(n_pad, -1, np.int32)
        rid_vec[: len(rids)] = rids
        keys = fold_row_keys(
            self._base_key, self._tensor(rid_vec),
            torch.zeros(n_pad, dtype=torch.int32, device=self.device),
        )
        return self.sampler(logits, keys)

    def _replay_timed(
        self, key: Key, read: Callable[[Any], np.ndarray]
    ) -> Tuple[np.ndarray, float]:
        """Synchronise, replay ``key`` and bring its outputs to the host
        with ``read``. Returns (what ``read`` returned, the stage's duration:
        replay to host copy, over ``speed_factor``), marking the host spans'
        sync, launch, wait and commit on the same two clock readings and
        tagging the step with ``key``."""
        self.host.tag(key.kind, key.shape)
        self.host.enter("engine.sync")
        self._sync()
        t0 = time.perf_counter()
        self.host.enter("engine.launch", t0)
        out = self.graphs.replay(key)
        self.host.enter("engine.wait")
        host = read(out)
        t1 = time.perf_counter()
        self.host.enter("engine.commit", t1)
        return host, (t1 - t0) / self.speed_factor

    def _observe_prefill(self, total_tokens: int, dt: float) -> None:
        """Feed the profiler and run straggler mitigation."""
        self.profiler.record_prefill(total_tokens, dt)
        predicted = self.profiler.cost_model.prefill_time(total_tokens)
        if predicted > 0 and dt > self.cfg.straggler_factor * predicted:
            self._budget_shift = min(self._budget_shift + 1, 3)
            self.straggler_events += 1
        elif self._budget_shift > 0 and dt < 1.5 * predicted:
            self._budget_shift -= 1

    def _run_prefill_stage(self, pairs: List[Tuple[ClientState, Request]]):
        """Execute one packed whole-prompt prefill (dense layout); returns
        (duration_s, total_tokens)."""
        self.host.enter("engine.load")
        reqs = [r for _, r in pairs]
        slots = [c.cid for c, _ in pairs]
        max_len = max(r.n_prefill for r in reqs)
        s_pad = _bucket(max_len, self.cfg.prefill_seq_buckets)
        n_pad = _bucket(len(reqs), self.cfg.prefill_req_buckets)
        tokens = np.zeros((n_pad, s_pad), dtype=np.int32)
        lengths = np.ones(n_pad, dtype=np.int32)
        for i, r in enumerate(reqs):
            tokens[i, : r.n_prefill] = self._prompt_tokens(r)
            lengths[i] = r.n_prefill
        key = self._key("prefill", n_pad, s_pad)
        pref_cache = self.graphs.prepare(key).inputs["cache"]
        self.graphs.load(key, tokens=tokens, lengths=lengths)
        # the stage's host sync; the first token is sampled outside the
        # graph, as outside the reference's ``_prefill_jit``
        first, dt = self._replay_timed(key, lambda logits: self._sample_first(
            logits, [r.rid for r in reqs]).cpu().numpy())
        self._pending_dev_valid = False  # prefill rewrites pending tokens
        # scatter only the real rows (the batch was padded to a bucket)
        n = len(slots)
        real_cache = {
            k: x[:, :n] if x.dim() >= 3 else x[:n] for k, x in pref_cache.items()
        }
        self.slots.merge_prefill(real_cache, slots)
        for i, (client, req) in enumerate(pairs):
            self.slots.bind(client.cid, req)
            self.slots.emitted[client.cid] = 1     # prefill samples token #1
            self.pending_token[client.cid] = int(first[i])
            self.generated.setdefault(req.rid, []).append(int(first[i]))
            client.current = req
        self._note_concurrency()
        total_tokens = sum(r.n_prefill for r in reqs)
        self._observe_prefill(total_tokens, dt)
        return dt, total_tokens

    def _vocab(self) -> int:
        return self.model.cfg.vocab_size

    # ------------------------------------------------------------------ #
    # Admission and page accounting                                       #
    # ------------------------------------------------------------------ #
    def _tokens_bound(self, req: Request) -> int:
        """KV tokens a request can touch over its lifetime: prompt plus the
        decode bound (decode round k writes position n_prefill + k - 1)."""
        if self.cfg.eos_id is None:
            tokens = req.n_prefill + max(req.n_decode - 1, 0)
        else:
            tokens = self.cfg.max_len
        return min(tokens, self.cfg.max_len)

    def _prompt_total(self, req: Request) -> int:
        """Tokens the request's next (re)prefill will write."""
        extra = 0
        if req.rid in self._resume_rids:
            extra = max(len(self.generated.get(req.rid, ())) - 1, 0)
        return req.n_prefill + extra

    def _pages_needed(self, req: Request) -> int:
        if self.cfg.page_reserve == "upfront":
            return self.slots.allocator.pages_for(self._tokens_bound(req))
        return self.slots.allocator.pages_for(self._prompt_total(req))

    def _deadline_class(self, req: Request) -> int:
        """1 = online arrival carrying a TTFT deadline, 0 = everything else."""
        return 1 if (req.ttft_slo_s is not None and req.arrival > 0) else 0

    def _admissible(
        self, pairs: List[Tuple[ClientState, Request]]
    ) -> List[Tuple[ClientState, Request]]:
        """Trim a proposed batch to what the page pool can host: FCFS within
        a priority class (a blocked head blocks its class and every lower
        class), with headroom set aside for the active decoders' next round
        under on-demand reservation."""
        out = []
        free = self.slots.allocator.num_free + self.slots.reclaimable_pages()
        if self.cfg.page_reserve != "upfront":
            free -= self._decode_growth_pages(1)
        blocked: set = set()
        for client, req in pairs:
            full = self.slots.allocator.pages_for(self._tokens_bound(req))
            if full > self.slots.allocator.num_pages:
                raise ValueError(
                    f"request {req.rid} needs {full} pages but the pool only "
                    f"has {self.slots.allocator.num_pages}; raise "
                    f"EngineConfig.num_pages"
                )
            cls = self._deadline_class(req)
            if any(b >= cls for b in blocked):
                continue
            need = self._pages_needed(req)
            if need > free:
                blocked.add(cls)
                continue
            out.append((client, req))
            free -= need
        return out

    def _growth_target(self, slot: int, k: int) -> int:
        """KV tokens ``slot`` must own to run ``k`` more decode rounds."""
        req = self.slots.request_of[slot]
        return min(
            req.n_prefill + self.slots.emitted[slot] + k - 1,
            self._tokens_bound(req),
        )

    def _decode_growth_pages(self, k: int) -> int:
        return sum(
            self.slots.pages_to_cover(s, self._growth_target(s, k))
            for s in self.slots.active_slots
        )

    def _preemption_victims(self) -> List[int]:
        """Eviction order: offline before deadline traffic, then fewest
        emitted tokens, newest rid first."""
        cands = []
        for s in range(self.cfg.n_slots):
            if self.slots.request_of[s] is not None:
                cands.append((s, self.slots.request_of[s]))
            elif s in self._chunking:
                cands.append((s, self._chunking[s].req))
        cands.sort(
            key=lambda sr: (
                self._deadline_class(sr[1]),
                self.slots.emitted[sr[0]],
                -sr[1].rid,
            )
        )
        return [s for s, _ in cands]

    def _preempt_slot(self, slot: int) -> None:
        """Evict ``slot``: deallocate its pages and re-queue its request for
        recompute-on-resume (a mid-chunk prefill simply restarts)."""
        sv = self._sv
        if slot in self._chunking:
            st = self._chunking.pop(slot)
            req = st.req
            if st.resume_emitted > 0:
                self._resume_rids.add(req.rid)
            self.slots.free_pages_of(slot)
        else:
            req = self.slots.request_of[slot]
            if self.generated.get(req.rid):
                self._resume_rids.add(req.rid)
                req.preemptions += 1
            self.slots.release(slot)
            sv.clients[slot].current = None
        self.preemption_events += 1
        self._mig_pending.discard(slot)
        if self.obs is not None:
            self.obs.span(
                req.rid, "preempt", sv.t, replica=self.obs_replica,
                slot=slot, reason="page_pressure",
            )
        sv.scheduler.push(req)

    def _ensure_decode_capacity(self, k: int, allow_shrink: bool = False) -> int:
        """Secure pages for ``k`` decode rounds over every active slot,
        shrinking a policy-driven horizon before evicting work. Returns the
        horizon actually funded."""
        while True:
            active = self.slots.active_slots
            if not active:
                return k
            headroom = (
                self.slots.allocator.num_free + self.slots.reclaimable_pages()
            )
            if self._decode_growth_pages(k) <= headroom:
                for s in active:
                    self.slots.ensure_tokens(s, self._growth_target(s, k))
                return k
            if allow_shrink and k > 1:
                k //= 2
                continue
            victims = self._preemption_victims()
            if not victims:
                return k
            self._preempt_slot(victims[0])

    def _note_concurrency(self) -> None:
        cur = len(self.slots.active_slots) + len(self._chunking)
        if cur > self.peak_concurrency:
            self.peak_concurrency = cur

    def _note_first_token(self, req: Request, t: float) -> None:
        """Pin TTFT to the FIRST prefill completion and feed the overload
        policy's attainment window."""
        if req.t_first_token is None:
            req.t_first_token = t
            if self.overload is not None and req.ttft_slo_s is not None:
                self.overload.record_ttft(t - req.arrival, req.ttft_slo_s)
            if self.obs is not None:
                self.obs.span(
                    req.rid, "first_token", t, replica=self.obs_replica,
                    slot=req.client, ttft_s=round(t - req.arrival, 6),
                )

    # ------------------------------------------------------------------ #
    # Observability emission (every call site guards on self.obs)         #
    # ------------------------------------------------------------------ #
    def _obs_admit(
        self, req: Request, t: float, slot: int, resumed: bool, cached: int
    ) -> None:
        """Admission span; a request's first-ever event is its arrival."""
        if not self.obs.spans.has(req.rid):
            self.obs.span(
                req.rid, "arrival", max(req.arrival, 0.0),
                replica=self.obs_replica,
            )
        self.obs.span(
            req.rid, "resume" if resumed else "admit", t,
            replica=self.obs_replica, slot=slot,
            cached_tokens=cached, prefill_tokens=req.n_prefill,
        )

    def _obs_complete(self, req: Request, t: float, slot: int) -> None:
        self.obs.span(
            req.rid, "complete", t, replica=self.obs_replica, slot=slot,
            decoded=req.decoded,
        )

    def _capacity_classes(
        self, busy: Dict[int, int], busy_partial: Dict[int, int], dt: float
    ) -> Dict[str, float]:
        """Classify every slot's share of one stage: each of ``n_slots``
        slots contributes exactly ``dt`` to exactly one class, so the sample
        sums to ``dt × n_slots`` by construction."""
        cls: Dict[str, float] = {}
        for s in range(self.cfg.n_slots):
            if s in busy or s in busy_partial:
                st = self._chunking.get(s)
                if st is not None and st.resume_emitted > 0:
                    c = "preempted"        # recomputing an evicted request
                elif st is not None and st.cached > 0:
                    c = "cache_hit"        # prefill riding adopted pages
                else:
                    c = "busy"
                self._mig_pending.discard(s)
            elif s in self._mig_pending:
                c = "migration"            # imported, not yet dispatched
            elif self.slots.request_of[s] is not None or s in self._chunking:
                c = "stall"                # holds work but was not dispatched
            else:
                c = "idle_gap"             # free slot during the stage
            cls[c] = cls.get(c, 0.0) + dt
        return cls

    def _obs_finish(self, trace: ScheduleTrace) -> None:
        """Mirror the trace's meta counters into the typed registry and
        record this replica's capacity denominator."""
        obs = self.obs
        for k, v in trace.meta.items():
            kind, unit, help_ = _METRIC_SPECS.get(
                k, ("counter", "", "engine meta counter")
            )
            obs.declare(k, kind, unit=unit, help=help_)
            if kind == "counter":
                obs.inc(k, float(v))
            else:
                # per-replica peaks: the registry keeps the max across
                # replicas
                obs.set(k, max(obs.registry.value(k), float(v)))
        kind, unit, help_ = _METRIC_SPECS["decoded_tokens"]
        obs.declare("decoded_tokens", kind, unit=unit, help=help_)
        obs.inc("decoded_tokens", float(self.decoded_tokens))
        obs.finish_replica(self.obs_replica, trace.makespan, self.cfg.n_slots)

    # ------------------------------------------------------------------ #
    # Chunked prefill                                                     #
    # ------------------------------------------------------------------ #
    def _start_chunked_batch(
        self, pairs: List[Tuple[ClientState, Request]], bin_index: int, now: float
    ) -> None:
        for client, req in pairs:
            prompt = self._prompt_tokens(req)
            resume_emitted = 0
            resume_pending = -1
            resumed = False
            if req.rid in self._resume_rids:
                self._resume_rids.discard(req.rid)
                prefix = self.generated.get(req.rid, [])
                if prefix:
                    resumed = True
                    resume_emitted = len(prefix)
                    resume_pending = int(prefix[-1])
                    if len(prefix) > 1:
                        prompt = np.concatenate(
                            [prompt, np.asarray(prefix[:-1], np.int32)]
                        )
            if self.cfg.page_reserve == "upfront":
                span = self._tokens_bound(req)
            else:
                span = len(prompt)
            if self._use_prefix_cache:
                cached = self.slots.reserve_with_prefix(client.cid, prompt, span)
            else:
                self.slots.reserve(client.cid, span)
                cached = 0
            if resumed:
                self.recomputed_tokens += len(prompt) - cached
            req.cached_prefill = min(cached, req.n_prefill)
            self.cache_hit_tokens += cached
            if self.obs is not None:
                self._obs_admit(req, now, client.cid, resumed, cached)
            self._chunking[client.cid] = _ChunkState(
                slot=client.cid, req=req, prompt=prompt, done=cached,
                resume_emitted=resume_emitted, resume_pending=resume_pending,
                cached=cached,
            )
            req.client = client.cid
            req.prefill_bin = bin_index
            req.t_prefill_start = now
        self._note_concurrency()

    def _next_chunk_tokens(self) -> int:
        return sum(
            min(self.cfg.prefill_chunk, st.remaining)
            for st in self._chunking.values()
        )

    def _bind_finished_chunk(self, st: _ChunkState, first: int) -> None:
        """Bind a slot whose final chunk just landed: restore a resumed
        stream, or record the first sampled token."""
        slot = st.slot
        self.slots.bind(slot, st.req)
        if self._use_prefix_cache:
            self.slots.publish_prefix(slot, st.prompt)
        if st.resume_emitted > 0:
            self.slots.emitted[slot] = st.resume_emitted
            self.pending_token[slot] = st.resume_pending
        else:
            self.slots.emitted[slot] = 1       # final chunk samples token #1
            self.pending_token[slot] = first
            self.generated.setdefault(st.req.rid, []).append(first)
        del self._chunking[slot]

    def _run_chunk_round(self):
        """One chunk round over every mid-prefill slot; returns
        (duration, chunk_tokens, finished_slots, busy, busy_partial)."""
        self.host.enter("engine.load")
        states = [self._chunking[s] for s in sorted(self._chunking)]
        c = self.cfg.prefill_chunk
        n_pad = _bucket(len(states), self.cfg.prefill_req_buckets)
        tokens = np.zeros((n_pad, c), dtype=np.int32)
        # pad rows point one past the last slot: their (len-0) writes drop
        slot_ids = np.full(n_pad, self.cfg.n_slots, dtype=np.int32)
        starts = np.zeros(n_pad, dtype=np.int32)
        lens = np.zeros(n_pad, dtype=np.int32)
        for i, st in enumerate(states):
            n = min(c, st.remaining)
            tokens[i, :n] = st.prompt[st.done : st.done + n]
            slot_ids[i] = st.slot
            starts[i] = st.done
            lens[i] = n
        key = self._key("chunk", n_pad)
        self.graphs.prepare(key)
        self.graphs.load(key, tokens=tokens, slot_ids=slot_ids, starts=starts, lens=lens)
        # the stage's host sync (first tokens sampled outside the graph)
        first, dt = self._replay_timed(key, lambda logits: self._sample_first(
            logits, [st.req.rid for st in states]).cpu().numpy())
        self._pending_dev_valid = False  # prefill rewrites pending tokens
        busy: Dict[int, int] = {}
        busy_partial: Dict[int, int] = {}
        finished: List[int] = []
        chunk_tokens = int(lens.sum())
        for i, st in enumerate(states):
            st.done += int(lens[i])
            if st.done >= st.total:
                self._bind_finished_chunk(st, int(first[i]))
                busy[st.slot] = st.req.rid
                finished.append(st.slot)
            else:
                busy_partial[st.slot] = st.req.rid
        self._observe_prefill(chunk_tokens, dt)
        return dt, chunk_tokens, finished, busy, busy_partial

    # ------------------------------------------------------------------ #
    # Mixed prefill+decode rounds                                         #
    # ------------------------------------------------------------------ #
    def _plan_mixed_round(
        self, pairs: List[Tuple[ClientState, Request]], share: int
    ) -> Tuple[List[Tuple[_ChunkState, int]], List[Tuple[ClientState, Request, int]]]:
        """Split the policy-priced chunk-token share across prefill work in
        WHOLE chunks: continuations of in-flight prefills first, then new
        admissions. Returns the per-state token counts and the admissions."""
        plan: List[Tuple[_ChunkState, int]] = []
        budget = share
        for slot in sorted(self._chunking):
            if budget <= 0:
                break
            st = self._chunking[slot]
            n = min(self.cfg.prefill_chunk, st.remaining)
            if n > 0:
                plan.append((st, n))
                budget -= n
        admitted: List[Tuple[ClientState, Request, int]] = []
        for client, req in pairs:
            if budget <= 0:
                break
            n = min(self.cfg.prefill_chunk, req.n_prefill)
            admitted.append((client, req, n))
            budget -= n
        return plan, admitted

    def _load_pending(self) -> None:
        """Bring the engine-owned pending-token buffer up to date with the
        host array, unless a decode graph left it current."""
        if not self._pending_dev_valid:
            self._pending_dev.copy_(torch.from_numpy(self.pending_token))
            self._pending_dev_valid = True

    def _run_mixed_stage(self, plan: List[Tuple[_ChunkState, int]]):
        """ONE dispatch: a decode round over every active slot plus the
        planned prefill-chunk rows. Returns (duration, finished_decode_slots,
        decode_tokens, chunk_tokens, finished_chunk_slots, busy,
        busy_partial)."""
        self.host.enter("engine.load")
        cfg = self.cfg
        j = cfg.n_slots
        decode_slots = self.slots.active_slots
        n_chunk = sum(n for _, n in plan)
        c = cfg.prefill_chunk
        r_pad = _bucket(max(len(plan), 1), cfg.prefill_req_buckets)
        chunk_tokens = np.zeros((r_pad, c), dtype=np.int32)
        chunk_slots = np.full(r_pad, j, dtype=np.int32)    # j → pad row
        starts = np.zeros(r_pad, dtype=np.int32)
        lens = np.zeros(r_pad, dtype=np.int32)
        dec_active = np.zeros(j, dtype=bool)
        sample_rows = np.zeros(j + r_pad, dtype=bool)
        rids = np.full(j + r_pad, -1, dtype=np.int32)
        token_idx = np.zeros(j + r_pad, dtype=np.int32)
        budgets: Dict[int, int] = {}
        for slot in decode_slots:
            req = self.slots.request_of[slot]
            dec_active[slot] = True
            sample_rows[slot] = True
            rids[slot] = req.rid
            token_idx[slot] = self.slots.emitted[slot]
            budgets[slot] = self._decode_budget(slot)
        final_row: Dict[int, int] = {}     # slot → sample row of final chunk
        for i, (st, n) in enumerate(plan):
            chunk_tokens[i, :n] = st.prompt[st.done : st.done + n]
            chunk_slots[i] = st.slot
            starts[i] = st.done
            lens[i] = n
            if st.done + n >= st.total:
                if st.resume_emitted == 0:
                    sample_rows[j + i] = True
                    rids[j + i] = st.req.rid
                final_row[st.slot] = j + i
        key = self._key("mixed", r_pad)
        self.graphs.prepare(key)
        self._load_pending()
        self.graphs.load(
            key, chunk_tokens=chunk_tokens, chunk_slots=chunk_slots, starts=starts,
            lens=lens, dec_active=dec_active, rids=rids, token_idx=token_idx,
            sample_rows=sample_rows,
        )
        # the ONE host sync for this round
        sampled, dt = self._replay_timed(key, lambda out: out.cpu().numpy())
        self._pending_dev_valid = False  # pending rebuilt from host below

        finished_decode: List[int] = []
        decode_tokens = 0
        busy: Dict[int, int] = {}
        busy_partial: Dict[int, int] = {}
        for slot in decode_slots:
            tok = int(sampled[slot])
            req = self.slots.request_of[slot]
            self.slots.emitted[slot] += 1
            self.pending_token[slot] = tok
            self.generated.setdefault(req.rid, []).append(tok)
            req.decoded = self.slots.emitted[slot]
            decode_tokens += 1
            busy[slot] = req.rid
            if budgets[slot] <= 1 or (
                cfg.eos_id is not None and tok == cfg.eos_id
            ):
                finished_decode.append(slot)
        finished_chunks: List[int] = []
        for st, n in plan:
            st.done += n
            if st.done >= st.total:
                first = int(sampled[final_row[st.slot]])
                self._bind_finished_chunk(st, first)
                busy[st.slot] = st.req.rid
                finished_chunks.append(st.slot)
            else:
                busy_partial[st.slot] = st.req.rid
        self.mixed_rounds += 1
        if decode_slots:
            self.decode_dispatches += 1
            self.decoded_tokens += decode_tokens
        self.profiler.record_mixed(len(decode_slots), n_chunk, dt)
        return (
            dt, finished_decode, decode_tokens, n_chunk, finished_chunks,
            busy, busy_partial,
        )

    def _finish_prefills(
        self, slots: List[int], clients: List[ClientState], t: float
    ) -> None:
        """Post-stage bookkeeping for requests whose final chunk just
        landed."""
        for slot in slots:
            req = self.slots.request_of[slot]
            clients[slot].current = req
            req.t_prefill_end = t
            req.decoded = self.slots.emitted[slot]
            if self.obs is not None:
                self.obs.span(
                    req.rid, "prefill_done", t, replica=self.obs_replica,
                    slot=slot,
                )
            self._note_first_token(req, t)
            # requests with n_decode == 1 finish at prefill
            if self.cfg.eos_id is None and req.n_decode <= 1:
                req.t_done = t
                self.slots.release(slot)
                clients[slot].current = None
                if self.obs is not None:
                    self._obs_complete(req, t, slot)

    # ------------------------------------------------------------------ #
    # Captured dispatches (serving.graphs)                                #
    # ------------------------------------------------------------------ #
    def _key(self, kind: str, *shape: int) -> Key:
        return Key(kind, shape, self._base_key is not None)

    def _horizons(self) -> List[int]:
        """Every horizon ``_choose_horizon`` can return (page pressure only
        halves a policy horizon): a pinned K and the powers of two under it,
        or the powers of two up to the cap."""
        cfg = self.cfg
        if cfg.decode_horizon is not None:
            k = cfg.decode_horizon
            if k < 1:
                return [1]
            return sorted({k} | {1 << i for i in range(k.bit_length()) if 1 << i < k})
        cap = max(1, cfg.max_decode_horizon)
        return [1 << i for i in range(cap.bit_length())]

    def serving_keys(self) -> set:
        """Every dispatch key the scheduler can reach: fused decode at each
        horizon; on the paged layout, chunk rounds (and mixed rounds, under
        ``mixed_schedule``) at each row bucket of 1..n_slots rows; on the
        dense layout, prefill stages at each (request, sequence) bucket pair
        whose sequence bucket fits ``max_len`` (a longer one fails at serve
        time, as it always has)."""
        cfg = self.cfg
        rows = sorted({_bucket(r, cfg.prefill_req_buckets) for r in range(1, cfg.n_slots + 1)})
        keys = {self._key("decode", k) for k in self._horizons()}
        if cfg.kv_layout == "paged":
            keys |= {self._key("chunk", r) for r in rows}
            if cfg.mixed_schedule:
                keys |= {self._key("mixed", r) for r in rows}
        else:
            keys |= {self._key("prefill", r, s) for r in rows
                     for s in cfg.prefill_seq_buckets if s <= cfg.max_len}
        return keys

    def warm_serving_shapes(self) -> None:
        """Prepare every key of ``serving_keys`` — its all-inactive call
        (writes dropped, lengths untouched, nothing recorded) run eagerly,
        then, on the card, captured — so no stage of a measured serve
        captures, builds a kernel or warms cuBLAS."""
        for key in sorted(self.serving_keys()):
            self.graphs.prepare(key)
        self._sync()

    def _prefill_cache(self, n: int, s: int) -> Dict[str, torch.Tensor]:
        """The static cache of the (n, s) prefill bucket pair: views of one
        buffer of the largest pair (each stage overwrites every entry of its
        view, and the slot merge reads it before the next stage)."""
        cfg = self.cfg
        if self._prefill_buf is None:
            self._prefill_buf = self.model.cache_init(
                max(cfg.prefill_req_buckets), max(cfg.prefill_seq_buckets))
        return {
            k: self._prefill_buf[k][tuple(slice(0, d) for d in shape)]
            for k, shape in self.model.cache_shape(n, s).items()
        }

    def _build_dispatch(self, key: Key):
        """A key's static inputs, at its all-inactive call's values (pad
        rows at slot n_slots, no active lane, writes dropped), and the
        function the graph captures. Decode and mixed read the pending
        tokens from the engine's own buffer; a decode leaves its last tokens
        there, since its static outputs are overwritten by the next replay."""
        cfg, model, params, dev = self.cfg, self.model, self.params, self.device
        j, c = cfg.n_slots, cfg.prefill_chunk
        cache, pending = self.slots.cache, self._pending_dev
        sample = dict(sampler=self.sampler, base_key=self._base_key)

        def i32(*shape, fill=0):
            return torch.full(shape, fill, dtype=torch.int32, device=dev)

        def off(n):
            return torch.zeros(n, dtype=torch.bool, device=dev)

        if key.kind == "decode":
            (k,) = key.shape
            inputs = dict(active=off(j), budgets=i32(j), rids=i32(j), token_idx0=i32(j))

            def fn(x):
                block, counts, act, last, _ = model.decode_steps(
                    params, pending, cache, num_steps=k, active=x["active"],
                    budgets=x["budgets"], rids=x["rids"], token_idx0=x["token_idx0"],
                    eos_id=cfg.eos_id, **sample)
                pending.copy_(last)
                return torch.cat([block.reshape(-1), counts, act.to(torch.int32)])
        elif key.kind == "mixed":
            (r,) = key.shape
            inputs = dict(chunk_tokens=i32(r, c), chunk_slots=i32(r, fill=j), starts=i32(r),
                          lens=i32(r), dec_active=off(j), rids=i32(j + r, fill=-1),
                          token_idx=i32(j + r), sample_rows=off(j + r))

            def fn(x):
                return model.mixed_step(
                    params, pending, cache, x["chunk_tokens"], x["chunk_slots"], x["starts"],
                    x["lens"], dec_active=x["dec_active"], rids=x["rids"],
                    token_idx=x["token_idx"], sample_rows=x["sample_rows"], **sample)[0]
        elif key.kind == "chunk":
            (n,) = key.shape
            inputs = dict(tokens=i32(n, c), slot_ids=i32(n, fill=j), starts=i32(n), lens=i32(n))

            def fn(x):
                return model.prefill_chunk(params, x["tokens"], cache, x["slot_ids"],
                                           x["starts"], x["lens"])[0]
        elif key.kind == "prefill":
            n, s = key.shape
            inputs = dict(tokens=i32(n, s), lengths=i32(n, fill=1), cache=self._prefill_cache(n, s))

            def fn(x):
                return model.prefill(params, x["tokens"], x["cache"], lengths=x["lengths"])[0]
        else:
            raise ValueError(f"unknown dispatch kind {key.kind!r}")
        return inputs, fn

    # ------------------------------------------------------------------ #
    # Fused decode                                                        #
    # ------------------------------------------------------------------ #
    def _choose_horizon(self, policy_horizon: int) -> int:
        """Final decode horizon, capped by the largest remaining per-slot
        budget; policy-driven horizons bucket down to a power of two."""
        cfg = self.cfg
        rem = max(
            (self._decode_budget(s) for s in self.slots.active_slots),
            default=1,
        )
        if cfg.decode_horizon is not None:
            k = max(1, min(cfg.decode_horizon, rem))
            return k if k == cfg.decode_horizon else 1 << (k.bit_length() - 1)
        k = max(1, min(policy_horizon, cfg.max_decode_horizon, rem))
        return 1 << (k.bit_length() - 1)

    def _decode_budget(self, slot: int) -> int:
        """Tokens this slot may still emit."""
        req = self.slots.request_of[slot]
        emitted = self.slots.emitted[slot]
        if self.cfg.eos_id is None:
            return max(1, req.n_decode - emitted)
        return max(1, self.cfg.max_len - (req.n_prefill + emitted - 1))

    def _run_decode_stage(self, k: int) -> Tuple[float, List[int], int]:
        """One fused decode stage of ``k`` iterations over all active slots:
        one queue of device work, ONE host sync at the horizon boundary.
        Returns (duration, finished slots, tokens emitted)."""
        self.host.enter("engine.load")
        cfg = self.cfg
        slots = self.slots.active_slots
        active = np.zeros(cfg.n_slots, dtype=bool)
        budgets = np.zeros(cfg.n_slots, dtype=np.int32)
        rids = np.zeros(cfg.n_slots, dtype=np.int32)
        emit0 = np.zeros(cfg.n_slots, dtype=np.int32)
        for slot in slots:
            active[slot] = True
            budgets[slot] = self._decode_budget(slot)
            rids[slot] = self.slots.request_of[slot].rid
            emit0[slot] = self.slots.emitted[slot]
        key = self._key("decode", k)
        self.graphs.prepare(key)
        self._load_pending()
        self.graphs.load(key, active=active, budgets=budgets, rids=rids, token_idx0=emit0)
        # the ONE host sync for this horizon: everything the scheduler needs
        host, dt = self._replay_timed(key, lambda out: out.cpu().numpy())
        n = cfg.n_slots
        block = host[: k * n].reshape(k, n)
        emitted_k = host[k * n : k * n + n]
        active_out = host[k * n + n :].astype(bool)
        # the graph left the last tokens in the engine's pending buffer: they
        # stay device-resident across stages
        self.decode_dispatches += 1
        finished: List[int] = []
        total = 0
        for slot in slots:
            cnt = int(emitted_k[slot])
            req = self.slots.request_of[slot]
            toks = block[:cnt, slot]
            self.slots.emitted[slot] += cnt
            self.pending_token[slot] = int(toks[-1])
            self.generated.setdefault(req.rid, []).extend(int(x) for x in toks)
            req.decoded = self.slots.emitted[slot]
            total += cnt
            if not bool(active_out[slot]):
                finished.append(slot)
        self.decoded_tokens += total
        self.profiler.record_decode(len(slots), dt, rounds=k)
        return dt, finished, total

    # ------------------------------------------------------------------ #
    # Step-driven serve                                                   #
    # ------------------------------------------------------------------ #
    def begin_serve(
        self,
        requests: Sequence[Request],
        clients: List[ClientState],
        request_scheduler: RequestScheduler,
        iteration_policy: IterationPolicy,
        policy_name: str = "",
        track_requests: bool = False,
    ) -> None:
        """Open a step-driven serve session (``serve_step`` runs stages one
        at a time; ``finish_serve`` closes the trace). With
        ``track_requests=True`` the trace adopts requests as the scheduler
        commits them (a fleet routes them in while the serve runs)."""
        cfg = self.cfg
        if len(clients) != cfg.n_slots:
            raise ValueError("clients must match n_slots")
        trace = ScheduleTrace(
            num_clients=cfg.n_slots,
            requests=list(requests),
            policy_name=policy_name or f"engine/{iteration_policy.name}",
        )
        for r in requests:
            r.reset()
        self.generated = {}
        self.decode_dispatches = 0
        self.decoded_tokens = 0
        self.mixed_rounds = 0
        self.prefill_stall_time = 0.0
        self.preemption_events = 0
        self.offline_deferrals = 0
        self.peak_concurrency = 0
        self.recomputed_tokens = 0
        self.migrations_in = 0
        self.migrations_out = 0
        self.cache_hit_tokens = 0
        self._mig_pending = set()
        self._sv = _ServeSession(
            trace=trace, clients=clients, scheduler=request_scheduler,
            policy=iteration_policy, track_requests=track_requests,
        )

    def has_work(self) -> bool:
        """Anything to run now or later: a bound slot, an in-flight chunked
        prefill, or a queued request."""
        return (
            bool(self.slots.active_slots)
            or bool(self._chunking)
            or self._sv.scheduler.has_pending()
        )

    @property
    def clock(self) -> float:
        """The open session's stage clock (virtual serve time)."""
        return self._sv.t

    def advance_clock(self, t: float) -> None:
        """Fast-forward the session clock (fleet-level idle gaps)."""
        if t > self._sv.t:
            self._sv.t = t

    def _commit_pairs(self, pairs: List[Tuple[ClientState, Request]]) -> None:
        sv = self._sv
        sv.scheduler.commit_batch(pairs)
        if sv.track_requests:
            # a preempted request is committed again on resume — adopt each
            # request into the trace once
            known = {r.rid for r in sv.trace.requests}
            sv.trace.requests.extend(r for _, r in pairs if r.rid not in known)

    def queued_requests(self) -> Tuple[Request, ...]:
        """Not-yet-admitted requests of the open session (overload policies
        inspect these for queue pressure)."""
        if self._sv is None:
            return ()
        return self._sv.scheduler.queued

    def adopt_resume(self, req: Request, prefix: List[int]) -> None:
        """Adopt a request recovered from another replica mid-decode: seed
        its generated prefix and queue it for recompute-on-resume, the path
        a locally preempted request takes."""
        self.generated[req.rid] = list(prefix)
        self._resume_rids.add(req.rid)
        self._sv.scheduler.push(req)

    # ------------------------------------------------------------------ #
    # Live migration by page-copy (fleet drain / rebalancing / recovery)  #
    # ------------------------------------------------------------------ #
    def _local_prefill_completions(self, rid: int) -> int:
        """Prefill completions for ``rid`` recorded in this session's trace
        so far (``ScheduleTrace.validate``'s counting rule); an import
        subtracts them from the checkpoint's credit."""
        cnt = 0
        for s in self._sv.trace.stages:
            if s.kind is StageKind.PREFILL:
                cnt += sum(1 for r in s.busy.values() if r == rid)
            elif s.kind is StageKind.MIXED:
                cnt += sum(1 for r in s.prefilled.values() if r == rid)
        return cnt

    def can_import(self, n_pages: int) -> bool:
        """Whether this engine can host a migrated slot of ``n_pages`` now:
        a truly free slot, and pool headroom beyond its own decoders' next
        round (an import must never force a preemption here)."""
        if self.cfg.kv_layout != "paged" or self._sv is None:
            return False
        if not any(s not in self._chunking for s in self.slots.free_slots):
            return False
        free = (
            self.slots.allocator.num_free + self.slots.reclaimable_pages()
            - self._decode_growth_pages(1)
        )
        return n_pages <= free

    def slot_pages(self, slot: int) -> int:
        """Pages ``slot`` currently owns (capacity probe for migration)."""
        return len(self.slots.tables[slot])

    def export_slot(self, slot: int) -> SlotCheckpoint:
        """Extract ``slot``'s mid-request state as a ``SlotCheckpoint`` and
        release the slot: gather its KV pages, capture the pending token,
        sampler cursor, generated prefix (and chunk progress), free the
        pages and drop the request from this trace."""
        sv = self._sv
        if slot in self._chunking:
            st = self._chunking[slot]
            req = st.req
            kind = "chunking"
            emitted = st.resume_emitted
            pending = st.resume_pending
            chunk_done = st.done
            resume_emitted = st.resume_emitted
            resume_pending = st.resume_pending
            # the in-flight pass has not completed; earlier passes number
            # exactly req.preemptions
            credit = req.preemptions
        elif self.slots.request_of[slot] is not None:
            req = self.slots.request_of[slot]
            kind = "bound"
            emitted = self.slots.emitted[slot]
            pending = int(self.pending_token[slot])
            chunk_done = 0
            resume_emitted = 0
            resume_pending = -1
            credit = 1 + req.preemptions
        else:
            raise RuntimeError(f"slot {slot} holds no in-flight request")
        pages, k_pages, v_pages, kv_length, checksum = self.slots.export_pages(slot)
        if kind == "chunking":
            del self._chunking[slot]
            self.slots.free_pages_of(slot)
        else:
            self.slots.release(slot)
            sv.clients[slot].current = None
        prefix = self.generated.pop(req.rid, [])
        sv.trace.requests = [r for r in sv.trace.requests if r.rid != req.rid]
        sv.trace.external_prefills.pop(req.rid, None)
        self.migrations_out += 1
        self._mig_pending.discard(slot)
        if self.obs is not None:
            self.obs.span(
                req.rid, "migrate_out", sv.t, replica=self.obs_replica,
                slot=slot, pages=len(pages), state=kind,
            )
        if self.debug_invariants:
            self._check_invariants()
        return SlotCheckpoint(
            req=req, kind=kind, emitted=emitted, pending_token=pending,
            kv_length=kv_length, k_pages=k_pages, v_pages=v_pages,
            n_pages=len(pages), prefix=list(prefix), prefill_credit=credit,
            chunk_done=chunk_done, resume_emitted=resume_emitted,
            resume_pending=resume_pending, checksum=checksum,
        )

    def import_slot(self, ckpt: SlotCheckpoint) -> int:
        """Land a migrated slot: allocate fresh pages, scatter the payload
        (its checksum verified before any pool state changes) and rebind
        the request where it left off. Returns the destination slot.
        Callers gate on ``can_import`` first."""
        sv = self._sv
        free = [s for s in self.slots.free_slots if s not in self._chunking]
        if not free:
            raise RuntimeError("no free slot to import into")
        slot = free[0]
        self.slots.import_pages(
            slot, ckpt.k_pages, ckpt.v_pages, ckpt.kv_length,
            checksum=ckpt.checksum,
        )
        req = ckpt.req
        if ckpt.prefix:
            self.generated[req.rid] = list(ckpt.prefix)
        if ckpt.kind == "bound":
            self.slots.bind(slot, req)
            self.slots.emitted[slot] = ckpt.emitted
            self.pending_token[slot] = ckpt.pending_token
            # the device copy of pending tokens predates this import
            self._pending_dev_valid = False
            sv.clients[slot].current = req
            req.decoded = ckpt.emitted
        else:
            prompt = self._prompt_tokens(req)
            if ckpt.resume_emitted > 1:
                prompt = np.concatenate(
                    [prompt, np.asarray(ckpt.prefix[:-1], np.int32)]
                )
            self._chunking[slot] = _ChunkState(
                slot=slot, req=req, prompt=prompt, done=ckpt.chunk_done,
                resume_emitted=ckpt.resume_emitted,
                resume_pending=ckpt.resume_pending,
            )
        req.client = slot
        if req.rid not in {r.rid for r in sv.trace.requests}:
            sv.trace.requests.append(req)
        # credit only the completions this trace has not recorded itself (a
        # request can leave and come back)
        sv.trace.external_prefills[req.rid] = (
            ckpt.prefill_credit - self._local_prefill_completions(req.rid)
        )
        self._note_concurrency()
        self.migrations_in += 1
        self._mig_pending.add(slot)
        if self.obs is not None:
            self.obs.span(
                req.rid, "migrate_in", sv.t, replica=self.obs_replica,
                slot=slot, pages=ckpt.n_pages, state=ckpt.kind,
            )
        if self.debug_invariants:
            self._check_invariants()
        return slot

    def _check_invariants(self) -> None:
        """Allocator consistency, the host↔device block-table mirror and
        per-page refcounts — paged layout only."""
        if self.cfg.kv_layout != "paged":
            return
        self.slots.allocator.check_consistency()
        self.slots.check_block_table_mirror()
        self.slots.check_refcounts()

    def _filter_overload(
        self,
        pairs: List[Tuple[ClientState, Request]],
        idle: List[ClientState],
        max_cap: int,
        request_scheduler: RequestScheduler,
        t: float,
    ) -> List[Tuple[ClientState, Request]]:
        """Run the overload policy over the proposed admissions, re-proposing
        for any client whose candidate was deferred."""
        kept = self.overload.filter_admissions(pairs, t, self)
        deferred = {r.rid for _, r in pairs} - {r.rid for _, r in kept}
        if not deferred:
            return kept
        self.offline_deferrals += len(deferred)
        while True:
            taken = {id(c) for c, _ in kept}
            freed = [c for c in idle if id(c) not in taken]
            budget = max_cap - sum(r.n_prefill for _, r in kept)
            if not freed or budget <= 0:
                return kept
            extra = request_scheduler.propose_batch(
                freed, budget,
                exclude=deferred | {r.rid for _, r in kept},
            )
            if not extra:
                return kept
            kept_extra = self.overload.filter_admissions(extra, t, self)
            newly = {r.rid for _, r in extra} - {r.rid for _, r in kept_extra}
            self.offline_deferrals += len(newly)
            kept = kept + kept_extra
            if not newly:
                return kept
            deferred |= newly

    def serve_step(self) -> str:
        """Run at most one stage of the open session. Returns ``"ran"``,
        ``"done"`` (nothing left) or ``"idle"`` (pending work but nothing
        runnable and no arrival to wait for). Each call is one step of
        ``self.host``."""
        self.host.begin(self._sv.t)
        try:
            return self._serve_step()
        finally:
            self.host.end()

    def _serve_step(self) -> str:
        sv = self._sv
        cfg = self.cfg
        paged = cfg.kv_layout == "paged"
        mixed = paged and cfg.mixed_schedule
        clients = sv.clients
        request_scheduler = sv.scheduler
        iteration_policy = sv.policy
        trace = sv.trace
        for attempt in range(4):
            if attempt:
                self.host.enter("engine.schedule")
            if sv.stages_run >= cfg.max_stages:
                raise RuntimeError("max_stages exceeded")
            t = sv.t
            if self.obs is not None and paged:
                # COW copies fire inside reserve_with_prefix; stamp them
                # with the current virtual time
                self.slots.obs_now = t
            max_cap = max(
                self.profiler.cost_model.max_level.cap_tokens >> self._budget_shift,
                self.profiler.cost_model.level_caps[0],
            )
            active = [c for c in clients if c.current is not None]
            idle = [
                c for c in clients
                if c.current is None and c.cid not in self._chunking
            ]
            if (
                not active and not self._chunking
                and not request_scheduler.has_pending()
            ):
                return "done"
            if hasattr(request_scheduler, "set_now"):
                request_scheduler.set_now(t)
            pairs = request_scheduler.propose_batch(idle, max_cap)
            if self.overload is not None and pairs:
                pairs = self._filter_overload(
                    pairs, idle, max_cap, request_scheduler, t
                )
            if paged and pairs:
                pairs = self._admissible(pairs)
            if paged:
                # the candidate stage is one chunk round: continuations of
                # any in-flight prefills plus first chunks of new admissions
                cont = sorted(self._chunking)
                cached_est = 0
                if self._use_prefix_cache and cfg.cache_aware_pricing:
                    cached_est = sum(
                        self._chunking[s].cached for s in cont
                    ) + sum(
                        self.slots.probe_prefix(self._prompt_tokens(r))
                        for _, r in pairs
                    )
                candidate = CandidateBatch(
                    requests=[self._chunking[s].req for s in cont]
                    + [r for _, r in pairs],
                    client_ids=cont + [c.cid for c, _ in pairs],
                    chunk_tokens=self._next_chunk_tokens()
                    + sum(min(cfg.prefill_chunk, r.n_prefill) for _, r in pairs),
                    cached_tokens=cached_est,
                )
            else:
                candidate = CandidateBatch(
                    requests=[r for _, r in pairs],
                    client_ids=[c.cid for c, _ in pairs],
                )
            snap = SystemSnapshot(
                n_clients=cfg.n_slots,
                n_active=len(active),
                n_idle=len(idle),
                active_remaining_est=sum(
                    max(0, (c.current.n_decode_est or 0) - c.current.decoded)
                    for c in active
                ),
                pending_requests=request_scheduler.pending_count(),
                candidate=candidate,
                now=t,
            )
            burst = bool(self._chunking or pairs)
            mixed_budget: Optional[int] = None
            if mixed:
                avail = self._next_chunk_tokens() + sum(
                    min(cfg.prefill_chunk, r.n_prefill) for _, r in pairs
                )
                mixed_budget = min(avail, cfg.mixed_token_buckets[-1])
            explain = (
                {} if (self.obs is not None and mixed_budget is not None)
                else None
            )
            t0 = time.perf_counter()
            self.host.enter("engine.policy", t0)
            decision = iteration_policy.decide(
                snap, self.profiler.cost_model,
                k_max=cfg.decode_horizon or cfg.max_decode_horizon,
                mixed_budget=mixed_budget,
                explain=explain,
            )
            do_prefill = decision.prefill
            t1 = time.perf_counter()
            self.host.enter("engine.plan", t1)
            trace.decision_times_ms.append((t1 - t0) * 1e3)
            if explain:
                self.obs.audit_record(
                    "prefill_share", t, self.obs_replica, explain,
                    explain.get("share", decision.chunk_tokens),
                )

            if mixed and decision.chunk_tokens > 0 and active:
                # quantize the priced share down to the bucket table
                fitting = [
                    b for b in cfg.mixed_token_buckets
                    if b <= decision.chunk_tokens
                ]
                share = fitting[-1] if fitting else cfg.mixed_token_buckets[0]
                plan, admitted = self._plan_mixed_round(pairs, share)
                if admitted:
                    new_pairs = [(c, r) for c, r, _ in admitted]
                    self._commit_pairs(new_pairs)
                    sv.bin_index += 1
                    self._start_chunked_batch(new_pairs, sv.bin_index, t)
                    for c, _, n in admitted:
                        st = self._chunking[c.cid]
                        plan.append((st, min(n, st.remaining)))
                if cfg.page_reserve != "upfront":
                    self._ensure_decode_capacity(1)
                    plan = [
                        (st, n) for st, n in plan
                        if self._chunking.get(st.slot) is st
                    ]
                    if not self.slots.active_slots:
                        continue   # every decode lane was evicted — re-plan
                (
                    dt, fin_decode, decode_tok, chunk_tok, fin_chunks,
                    busy, busy_partial,
                ) = self._run_mixed_stage(plan)
                trace.stages.append(
                    StageRecord(
                        kind=StageKind.MIXED,
                        t_start=t, t_end=t + dt,
                        bin_index=max(sv.bin_index, 0),
                        busy=busy, busy_partial=busy_partial,
                        tokens=decode_tok + chunk_tok,
                        chunk_tokens=chunk_tok, rounds=1, burst=True,
                        prefilled={
                            s: self.slots.request_of[s].rid for s in fin_chunks
                        },
                    )
                )
                sv.t = t + dt
                if self.obs is not None:
                    self.obs.capacity(
                        self.obs_replica, t, sv.t,
                        self._capacity_classes(busy, busy_partial, dt),
                    )
                self._finish_prefills(fin_chunks, clients, sv.t)
                for slot in fin_decode:
                    req = self.slots.release(slot)
                    req.t_done = sv.t
                    clients[slot].current = None
                    if self.obs is not None:
                        self._obs_complete(req, sv.t, slot)
            elif (
                candidate and paged
                and (do_prefill or (mixed and decision.chunk_tokens > 0))
            ):
                # no decoders are running (or the alternating schedule chose
                # prefill): run the plain chunk round
                if pairs:
                    self._commit_pairs(pairs)
                    sv.bin_index += 1
                    self._start_chunked_batch(pairs, sv.bin_index, t)
                dt, tok, finished, busy, busy_partial = self._run_chunk_round()
                if active:
                    self.prefill_stall_time += dt
                trace.stages.append(
                    StageRecord(
                        kind=StageKind.PREFILL,
                        t_start=t, t_end=t + dt,
                        bin_index=max(sv.bin_index, 0),
                        busy=busy, busy_partial=busy_partial, tokens=tok,
                        level=self.profiler.cost_model.level_for(
                            min(tok, max_cap)
                        ).index,
                    )
                )
                sv.t = t + dt
                if self.obs is not None:
                    self.obs.capacity(
                        self.obs_replica, t, sv.t,
                        self._capacity_classes(busy, busy_partial, dt),
                    )
                self._finish_prefills(finished, clients, sv.t)
            elif do_prefill and candidate:
                # dense layout: one whole-prompt prefill stage, preempting
                # every active decoder for its duration
                self._commit_pairs(pairs)
                sv.bin_index += 1
                dt, tok = self._run_prefill_stage(pairs)
                if active:
                    self.prefill_stall_time += dt
                busy = {}
                for client, req in pairs:
                    req.client = client.cid
                    req.prefill_bin = sv.bin_index
                    req.t_prefill_start = t
                    req.t_prefill_end = t + dt
                    req.decoded = 1
                    if self.obs is not None:
                        self._obs_admit(req, t, client.cid, False, 0)
                    self._note_first_token(req, t + dt)
                    busy[client.cid] = req.rid
                trace.stages.append(
                    StageRecord(
                        kind=StageKind.PREFILL,
                        t_start=t, t_end=t + dt,
                        bin_index=sv.bin_index, busy=busy, tokens=tok,
                        level=self.profiler.cost_model.level_for(
                            min(tok, max_cap)
                        ).index,
                    )
                )
                sv.t = t + dt
                if self.obs is not None:
                    self.obs.capacity(
                        self.obs_replica, t, sv.t,
                        self._capacity_classes(busy, {}, dt),
                    )
                # requests with n_decode == 1 finish at prefill
                for client, req in pairs:
                    if self.cfg.eos_id is None and req.n_decode <= 1:
                        req.t_done = sv.t
                        self.slots.release(client.cid)
                        client.current = None
                        if self.obs is not None:
                            self._obs_complete(req, sv.t, client.cid)
            elif active:
                k = self._choose_horizon(decision.horizon)
                if paged and cfg.page_reserve != "upfront":
                    k = self._ensure_decode_capacity(
                        k, allow_shrink=cfg.decode_horizon is None
                    )
                    if not self.slots.active_slots:
                        continue   # every decode lane was evicted — re-plan
                dt, finished, tokens = self._run_decode_stage(k)
                if trace.stages and trace.stages[-1].kind is StageKind.PREFILL:
                    burst = True
                busy = {
                    c.cid: c.current.rid for c in active if c.current is not None
                }
                trace.stages.append(
                    StageRecord(
                        kind=StageKind.DECODE,
                        t_start=t, t_end=t + dt,
                        bin_index=max(sv.bin_index, 0), busy=busy,
                        tokens=tokens, rounds=k, burst=burst,
                    )
                )
                sv.t = t + dt
                if self.obs is not None:
                    self.obs.capacity(
                        self.obs_replica, t, sv.t,
                        self._capacity_classes(busy, {}, dt),
                    )
                for slot in finished:
                    req = self.slots.release(slot)
                    req.t_done = sv.t
                    clients[slot].current = None
                    if self.obs is not None:
                        self._obs_complete(req, sv.t, slot)
            else:
                if candidate:
                    continue  # policy refused but nothing to decode: retry
                nxt = getattr(request_scheduler, "next_arrival", None)
                arrival = nxt() if callable(nxt) else None
                if arrival is not None and arrival > t:
                    sv.t = arrival    # idle gap: fast-forward to the arrival
                    return "ran"
                return "idle"
            sv.stages_run += 1
            if self.debug_invariants:
                self._check_invariants()
            return "ran"
        raise RuntimeError(
            "engine livelock: policy kept refusing the only runnable stage"
        )

    def finish_serve(self, validate: bool = True) -> ScheduleTrace:
        """Close the session: merge executor counters into the trace and
        (by default) check the trace invariants."""
        trace = self._sv.trace
        trace.meta.update(
            mixed_rounds=self.mixed_rounds,
            prefill_stall_time_s=round(self.prefill_stall_time, 6),
            decode_dispatches=self.decode_dispatches,
            preemption_events=self.preemption_events,
            peak_concurrency=self.peak_concurrency,
            offline_deferrals=self.offline_deferrals,
            recomputed_tokens=self.recomputed_tokens,
            migrations_in=self.migrations_in,
            migrations_out=self.migrations_out,
            cached_prefill_tokens=self.cache_hit_tokens,
        )
        if self.cfg.kv_layout == "paged":
            trace.meta.update(
                shared_pages_peak=self.slots.shared_pages_peak,
                cow_copies=self.slots.cow_copies,
            )
        if self.obs is not None:
            self._obs_finish(trace)
        if validate:
            trace.validate()
        return trace

    def serve(
        self,
        requests: Sequence[Request],
        clients: List[ClientState],
        request_scheduler: RequestScheduler,
        iteration_policy: IterationPolicy,
        policy_name: str = "",
    ) -> ScheduleTrace:
        """Serve a request set to completion; returns the execution trace."""
        self.begin_serve(
            requests, clients, request_scheduler, iteration_policy,
            policy_name=policy_name,
        )
        while True:
            status = self.serve_step()
            if status == "done":
                break
            if status == "idle":
                raise RuntimeError("engine deadlock: pending but no candidate")
        return self.finish_serve()

    # ------------------------------------------------------------------ #
    # Checkpoint / restore                                                #
    # ------------------------------------------------------------------ #
    def state_dict(self) -> Dict[str, Any]:
        """Engine state for a mid-serve checkpoint: the slot cache as CPU
        tensor copies (numpy has no bf16), slot bindings, pending tokens,
        straggler state, in-flight chunked prefills as fixed-shape per-slot
        arrays and the rids awaiting recompute-on-resume."""
        n = self.cfg.n_slots
        chunk_rid = np.full(n, -1, np.int32)
        chunk_done = np.zeros(n, np.int32)
        chunk_resume = np.zeros(n, np.int32)
        chunk_pending = np.full(n, -1, np.int32)
        chunk_cached = np.zeros(n, np.int32)
        for slot, st in self._chunking.items():
            chunk_rid[slot] = st.req.rid
            chunk_done[slot] = st.done
            chunk_resume[slot] = st.resume_emitted
            chunk_pending[slot] = st.resume_pending
            chunk_cached[slot] = st.cached
        return {
            "cache": {
                k: v.detach().to("cpu", copy=True)
                for k, v in self.slots.cache.items()
            },
            "request_of": [
                (r.rid if r is not None else -1) for r in self.slots.request_of
            ],
            "emitted": list(self.slots.emitted),
            "pending_token": self.pending_token.copy(),
            "budget_shift": self._budget_shift,
            "straggler_events": self.straggler_events,
            "chunk_rid": chunk_rid,
            "chunk_done": chunk_done,
            "chunk_resume": chunk_resume,
            "chunk_pending": chunk_pending,
            "chunk_cached": chunk_cached,
            "resume_rids": np.asarray(sorted(self._resume_rids), np.int32),
        }

    def load_state_dict(self, state: Dict[str, Any], requests_by_rid) -> None:
        """Restore engine state. To resume serving afterwards, give the
        request scheduler only the requests that had not started: restored
        in-flight work continues from engine state."""
        for k, v in state["cache"].items():
            self.slots.cache[k].copy_(torch.as_tensor(v))
        self.slots.request_of = [
            (requests_by_rid[int(rid)] if int(rid) >= 0 else None)
            for rid in state["request_of"]
        ]
        self.slots.emitted = [int(e) for e in state["emitted"]]
        self.pending_token = np.array(state["pending_token"], dtype=np.int32)
        self._pending_dev_valid = False  # rebuilt from the restored host copy
        self._budget_shift = int(state.get("budget_shift", 0))
        self.straggler_events = int(state.get("straggler_events", 0))
        self._resume_rids = {
            int(r) for r in np.asarray(state.get("resume_rids", [])).ravel()
        }
        self._chunking = {}
        chunk_rid = np.asarray(state.get("chunk_rid", []))
        chunk_done = np.asarray(state.get("chunk_done", []))
        chunk_resume = np.asarray(state.get("chunk_resume", []))
        chunk_pending = np.asarray(state.get("chunk_pending", []))
        chunk_cached = np.asarray(state.get("chunk_cached", []))
        for slot, rid in enumerate(chunk_rid):
            if rid >= 0:
                req = requests_by_rid[int(rid)]
                prompt = self._prompt_tokens(req)
                re_cnt = int(chunk_resume[slot]) if chunk_resume.size else 0
                re_pend = int(chunk_pending[slot]) if chunk_pending.size else -1
                if re_cnt > 1:
                    # the recompute prompt includes the generated prefix: the
                    # caller restores ``generated`` before engine state
                    prefix = list(self.generated.get(int(rid), ()))[:re_cnt]
                    prompt = np.concatenate(
                        [prompt, np.asarray(prefix[:-1], np.int32)]
                    )
                self._chunking[slot] = _ChunkState(
                    slot=slot, req=req, prompt=prompt,
                    done=int(chunk_done[slot]),
                    resume_emitted=re_cnt, resume_pending=re_pend,
                    cached=int(chunk_cached[slot]) if chunk_cached.size else 0,
                )
        if self.cfg.kv_layout == "paged":
            # the device block table is the durable page-ownership record
            self.slots.sync_from_device()
