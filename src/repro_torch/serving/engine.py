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
the port calls the model methods directly and they update the pool in place.
Every stage synchronises the device before it reads the clock (before the
dispatch, and through the host copy of its sampled tokens after it), so the
online profiler fits device time, not launch latency.

Not ported yet (see ROADMAP.md): stochastic sampling, page-copy migration
(``export_slot``/``import_slot``), ``state_dict`` checkpoints and the
observability hooks.
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
from .kv_slots import PagedSlotManager, SlotManager
from .overload import OverloadPolicy
from .profiler import OnlineProfiler
from .sampler import greedy

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
    sample_seed: int = 0
    debug_invariants: Optional[bool] = None
    prefix_cache: bool = False
    cache_aware_pricing: bool = True
    observe: Optional[Any] = None


def _bucket(x: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if x <= b:
            return b
    raise ValueError(
        f"value {x} exceeds the largest bucket {buckets[-1]}; a request "
        f"padded into it would silently overflow the batch — raise the "
        f"bucket table (EngineConfig.prefill_req_buckets) to cover the "
        f"workload"
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
        if config.observe is not None:
            raise NotImplementedError(
                "EngineConfig.observe: the observability hooks are not ported "
                "yet (see ROADMAP.md)"
            )
        if getattr(sampler, "stochastic", False):
            raise NotImplementedError(
                "stochastic samplers wait for a threefry port (see ROADMAP.md)"
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
        self.pending_token = np.zeros(config.n_slots, dtype=np.int32)
        # device copy of pending tokens carried between consecutive decode
        # stages (None → stale, rebuilt from the host array)
        self._dev_pending: Optional[torch.Tensor] = None
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
        cache = self.model.cache_init(n_pad, s_pad)
        args = [self._tensor(x) for x in (tokens, lengths)]
        self._sync()
        t0 = time.perf_counter()
        logits, pref_cache = self.model.prefill(self.params, args[0], cache, lengths=args[1])
        first = self.sampler(logits).cpu().numpy()   # the stage's host sync
        dt = (time.perf_counter() - t0) / self.speed_factor
        self._dev_pending = None          # prefill rewrites pending tokens
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
        args = [self._tensor(x) for x in (tokens, slot_ids, starts, lens)]
        self._sync()
        t0 = time.perf_counter()
        logits, self.slots.cache = self.model.prefill_chunk(
            self.params, args[0], self.slots.cache, *args[1:]
        )
        first = self.sampler(logits).cpu().numpy()   # the stage's host sync
        dt = (time.perf_counter() - t0) / self.speed_factor
        self._dev_pending = None          # prefill rewrites pending tokens
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

    def _pending_tensor(self) -> torch.Tensor:
        if self._dev_pending is not None:
            return self._dev_pending
        return self._tensor(self.pending_token.copy())

    def _run_mixed_stage(self, plan: List[Tuple[_ChunkState, int]]):
        """ONE dispatch: a decode round over every active slot plus the
        planned prefill-chunk rows. Returns (duration, finished_decode_slots,
        decode_tokens, chunk_tokens, finished_chunk_slots, busy,
        busy_partial)."""
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
        pending = self._pending_tensor()
        dev = [
            self._tensor(x) for x in (
                chunk_tokens, chunk_slots, starts, lens, dec_active, rids,
                token_idx, sample_rows,
            )
        ]
        self._sync()
        t0 = time.perf_counter()
        sampled, self.slots.cache = self.model.mixed_step(
            self.params, pending, self.slots.cache, *dev[:4],
            sampler=self.sampler, dec_active=dev[4], rids=dev[5],
            token_idx=dev[6], sample_rows=dev[7],
        )
        sampled = sampled.cpu().numpy()    # the ONE host sync for this round
        dt = (time.perf_counter() - t0) / self.speed_factor
        self._dev_pending = None           # pending rebuilt from host below

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
            self._note_first_token(req, t)
            # requests with n_decode == 1 finish at prefill
            if self.cfg.eos_id is None and req.n_decode <= 1:
                req.t_done = t
                self.slots.release(slot)
                clients[slot].current = None

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
        pending = self._pending_tensor()
        dev = [self._tensor(x) for x in (active, budgets, rids, emit0)]
        self._sync()
        t0 = time.perf_counter()
        token_block, emitted_k, active_out, last_tok, self.slots.cache = (
            self.model.decode_steps(
                self.params, pending, self.slots.cache,
                num_steps=k, sampler=self.sampler, active=dev[0],
                budgets=dev[1], rids=dev[2], token_idx0=dev[3],
                eos_id=cfg.eos_id,
            )
        )
        # the ONE host sync for this horizon: everything the scheduler needs
        host = torch.cat([
            token_block.reshape(-1), emitted_k, active_out.to(torch.int32),
        ]).cpu().numpy()
        dt = (time.perf_counter() - t0) / self.speed_factor
        n = cfg.n_slots
        block = host[: k * n].reshape(k, n)
        emitted_k = host[k * n : k * n + n]
        active_out = host[k * n + n :].astype(bool)
        self._dev_pending = last_tok      # stays device-resident across stages
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
    ) -> None:
        """Open a step-driven serve session (``serve_step`` runs stages one
        at a time; ``finish_serve`` closes the trace)."""
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
        self.cache_hit_tokens = 0
        self._sv = _ServeSession(
            trace=trace, clients=clients, scheduler=request_scheduler,
            policy=iteration_policy,
        )

    def _commit_pairs(self, pairs: List[Tuple[ClientState, Request]]) -> None:
        self._sv.scheduler.commit_batch(pairs)

    def queued_requests(self) -> Tuple[Request, ...]:
        """Not-yet-admitted requests of the open session (overload policies
        inspect these for queue pressure)."""
        if self._sv is None:
            return ()
        return self._sv.scheduler.queued

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
        runnable and no arrival to wait for)."""
        sv = self._sv
        cfg = self.cfg
        paged = cfg.kv_layout == "paged"
        mixed = paged and cfg.mixed_schedule
        clients = sv.clients
        request_scheduler = sv.scheduler
        iteration_policy = sv.policy
        trace = sv.trace
        for _attempt in range(4):
            if sv.stages_run >= cfg.max_stages:
                raise RuntimeError("max_stages exceeded")
            t = sv.t
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
            t0 = time.perf_counter()
            decision = iteration_policy.decide(
                snap, self.profiler.cost_model,
                k_max=cfg.decode_horizon or cfg.max_decode_horizon,
                mixed_budget=mixed_budget,
            )
            do_prefill = decision.prefill
            trace.decision_times_ms.append((time.perf_counter() - t0) * 1e3)

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
                self._finish_prefills(fin_chunks, clients, sv.t)
                for slot in fin_decode:
                    req = self.slots.release(slot)
                    req.t_done = sv.t
                    clients[slot].current = None
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
                # requests with n_decode == 1 finish at prefill
                for client, req in pairs:
                    if self.cfg.eos_id is None and req.n_decode <= 1:
                        req.t_done = sv.t
                        self.slots.release(client.cid)
                        client.current = None
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
                for slot in finished:
                    req = self.slots.release(slot)
                    req.t_done = sv.t
                    clients[slot].current = None
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
            migrations_in=0,
            migrations_out=0,
            cached_prefill_tokens=self.cache_hit_tokens,
        )
        if self.cfg.kv_layout == "paged":
            trace.meta.update(
                shared_pages_peak=self.slots.shared_pages_peak,
                cow_copies=self.slots.cow_copies,
            )
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
