"""Online requests scheduling — Algorithm 1 (Sorting and Online Preemptive
Method) plus the no-stealing baselines.

A *request scheduler* answers one question at prefill-scheduling time:
"client ``j`` is idle — which request should it take next?" Three variants:

  * ``StaticBacklogScheduler`` — clients only consume their own offline
    backlog (baseline & offline-only configurations; Figs. 6–7).
  * ``SortingPreemptiveScheduler`` — Algorithm 1: backlogs are sorted by
    N_i^p + N_i^d descending; an idle client with an empty backlog *steals*
    the longest request from the client with the largest ``remain_token``
    (online-only & hybrid configurations; Figs. 8–9).
  * ``GlobalQueueScheduler`` — a single FCFS queue (what vLLM actually does);
    used for ablations.

``peek`` takes a ``claimed`` set so a whole prefill batch can be *proposed*
(one request per idle client) without mutating any backlog; the iteration
policy then decides whether the batch actually runs, and only then is it
committed. All schedulers operate on the same ``ClientState`` objects the
simulator and the real engine share.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .types import ClientState, Request


class RequestScheduler:
    """Interface: proposes and commits requests for idle clients."""

    def has_pending(self) -> bool:
        raise NotImplementedError

    def pending_count(self) -> int:
        raise NotImplementedError

    def peek(self, client: ClientState, claimed: Set[int]) -> Optional[Request]:
        """Which request would ``client`` take next, ignoring ids in
        ``claimed``? Must not mutate state."""
        raise NotImplementedError

    def commit(self, client: ClientState, request: Request) -> None:
        """Remove ``request`` from whatever backlog ``peek`` found it in."""
        raise NotImplementedError

    # -- fleet hooks: external admission + cross-replica work stealing -- #
    def push(self, request: Request) -> None:
        """Admit a request from outside (fleet dispatch / stolen work).
        Optional — only queue-backed schedulers support it."""
        raise NotImplementedError(
            f"{type(self).__name__} does not accept external admissions"
        )

    def steal_longest(self) -> Optional[Request]:
        """Give up the longest not-yet-started request (for a starving
        replica), or None. Optional — queue-backed schedulers only."""
        return None

    def peek_longest(self) -> Optional[Request]:
        """The request ``steal_longest`` *would* surrender, without removing
        it — the fleet prices a candidate steal through both replicas' cost
        models before committing (popping and pushing back would reshuffle
        the queue order). Optional — queue-backed schedulers only."""
        return None

    @property
    def queued(self) -> Tuple[Request, ...]:
        """Snapshot of not-yet-started requests (fleet load estimation).
        Schedulers that cannot enumerate their backlog return ()."""
        return ()

    # ------------------------------------------------------------------ #
    def propose_batch(
        self,
        idle_clients: Sequence[ClientState],
        max_tokens: int,
        exclude: Set[int] = frozenset(),
    ) -> List[Tuple[ClientState, Request]]:
        """One candidate request per idle client, total prefill tokens ≤
        ``max_tokens`` (Eq. 6/16). A single request larger than the cap is
        admitted alone (the engine runs it as an oversize stage).
        ``exclude`` rids are skipped as if already claimed — an overload
        policy that defers an FCFS queue head re-proposes with the deferred
        rids excluded, so deferral cannot shadow admissible requests queued
        behind them (livelock otherwise: the idle slot would be offered the
        same deferred head forever)."""
        claimed: Set[int] = set(exclude)
        batch: List[Tuple[ClientState, Request]] = []
        total = 0
        for client in idle_clients:
            req = self.peek(client, claimed)
            if req is None:
                continue
            if batch and total + req.n_prefill > max_tokens:
                continue  # try remaining idle clients with smaller requests
            claimed.add(req.rid)
            batch.append((client, req))
            total += req.n_prefill
            if total >= max_tokens:
                break
        return batch

    def commit_batch(self, batch: Sequence[Tuple[ClientState, Request]]) -> None:
        for client, req in batch:
            self.commit(client, req)


def _sort_backlog(backlog: List[Request]) -> None:
    """Sort by N_i^p + N_i^d descending (Algorithm 1's required ordering)."""
    backlog.sort(key=lambda r: -r.est_total_tokens)


def _first_unclaimed(backlog: Sequence[Request], claimed: Set[int]) -> Optional[Request]:
    for r in backlog:
        if r.rid not in claimed:
            return r
    return None


class StaticBacklogScheduler(RequestScheduler):
    """Clients consume only their own backlog, in the given order."""

    def __init__(self, clients: Sequence[ClientState], sort_longest_first: bool = False):
        self._clients = list(clients)
        if sort_longest_first:
            for c in self._clients:
                _sort_backlog(c.backlog)

    def has_pending(self) -> bool:
        return any(c.backlog for c in self._clients)

    def pending_count(self) -> int:
        return sum(len(c.backlog) for c in self._clients)

    def peek(self, client: ClientState, claimed: Set[int]) -> Optional[Request]:
        return _first_unclaimed(client.backlog, claimed)

    def commit(self, client: ClientState, request: Request) -> None:
        client.backlog.remove(request)


class SortingPreemptiveScheduler(RequestScheduler):
    """Algorithm 1: sorted backlogs + work stealing from argmax remain_token.

    Faithful to the listing:

        for client j in J:
            if queue for client j is empty and I_j != ∅:  pop I_j to client j
            elif max(remain_token) > 0: pop argmax(remain_token) to client j

    ``remain_token(j) = Σ_{i∈I_j} (N_i^p + N_i^d)`` over the *backlog* (work
    not yet started). Stealing takes the longest request from the most-loaded
    backlog, so the makespan tail shrinks — this is the paper's request-level
    straggler mitigation.

    ``remain_token`` is maintained incrementally (updated on commit) and
    donor selection uses a heap, so a whole-batch proposal costs
    O(J + batch·log J) — well inside the paper's <10 ms decision budget even
    at thousands of clients (see ``benchmarks`` decision-latency table).
    """

    def __init__(self, clients: Sequence[ClientState]):
        self._clients = list(clients)
        self._by_cid = {c.cid: c for c in self._clients}
        for c in self._clients:
            _sort_backlog(c.backlog)
        self._remain = {c.cid: c.remain_token() for c in self._clients}
        self._total_pending = sum(len(c.backlog) for c in self._clients)

    def has_pending(self) -> bool:
        return self._total_pending > 0

    def pending_count(self) -> int:
        return self._total_pending

    def peek(self, client: ClientState, claimed: Set[int]) -> Optional[Request]:
        own = _first_unclaimed(client.backlog, claimed)
        if own is not None:
            return own
        # Steal from the client with the largest (unclaimed) remaining backlog.
        best, best_rem = None, 0
        for c in self._clients:
            rem = self._remain[c.cid] - sum(
                r.est_total_tokens for r in c.backlog if r.rid in claimed
            )
            if rem > best_rem:
                best, best_rem = c, rem
        if best is None:
            return None
        return _first_unclaimed(best.backlog, claimed)  # longest-first order

    def propose_batch(
        self,
        idle_clients: Sequence[ClientState],
        max_tokens: int,
        exclude: Set[int] = frozenset(),
    ) -> List[Tuple[ClientState, Request]]:
        """Heap-based batch proposal (same semantics as the generic one)."""
        import heapq

        claimed: Set[int] = set(exclude)
        batch: List[Tuple[ClientState, Request]] = []
        total = 0
        # Lazy max-heap over adjusted remain_token.
        rem = dict(self._remain)
        heap = [(-v, cid) for cid, v in rem.items() if v > 0]
        heapq.heapify(heap)
        for client in idle_clients:
            req = _first_unclaimed(client.backlog, claimed)
            if req is None:
                # steal from argmax remain_token
                while heap:
                    neg, cid = heap[0]
                    if -neg != rem[cid] or rem[cid] <= 0:
                        heapq.heappop(heap)
                        if rem[cid] > 0:
                            heapq.heappush(heap, (-rem[cid], cid))
                        continue
                    cand = _first_unclaimed(self._by_cid[cid].backlog, claimed)
                    if cand is None:
                        heapq.heappop(heap)
                        continue
                    req = cand
                    break
                if req is None:
                    continue
            if batch and total + req.n_prefill > max_tokens:
                continue
            claimed.add(req.rid)
            owner_cid = self._owner_cid(req, hint=client)
            rem[owner_cid] -= req.est_total_tokens
            heapq.heappush(heap, (-rem[owner_cid], owner_cid))
            batch.append((client, req))
            total += req.n_prefill
            if total >= max_tokens:
                break
        return batch

    def _owner_cid(self, request: Request, hint: ClientState) -> int:
        if request in hint.backlog:
            return hint.cid
        for c in self._clients:
            if request in c.backlog:
                return c.cid
        raise ValueError(f"request {request.rid} not found in any backlog")

    def commit(self, client: ClientState, request: Request) -> None:
        owner = self._by_cid[self._owner_cid(request, hint=client)]
        owner.backlog.remove(request)
        self._remain[owner.cid] -= request.est_total_tokens
        self._total_pending -= 1


class GlobalQueueScheduler(RequestScheduler):
    """Single FCFS queue shared by all clients (vLLM-style, for ablations)."""

    def __init__(self, requests: Sequence[Request], sort_longest_first: bool = False):
        self._queue: List[Request] = list(requests)
        if sort_longest_first:
            _sort_backlog(self._queue)

    def has_pending(self) -> bool:
        return bool(self._queue)

    def pending_count(self) -> int:
        return len(self._queue)

    def peek(self, client: ClientState, claimed: Set[int]) -> Optional[Request]:
        return _first_unclaimed(self._queue, claimed)

    def commit(self, client: ClientState, request: Request) -> None:
        self._queue.remove(request)

    def push(self, request: Request) -> None:
        self._queue.append(request)

    def steal_longest(self) -> Optional[Request]:
        if not self._queue:
            return None
        victim = max(self._queue, key=lambda r: r.est_total_tokens)
        self._queue.remove(victim)
        return victim

    def peek_longest(self) -> Optional[Request]:
        if not self._queue:
            return None
        return max(self._queue, key=lambda r: r.est_total_tokens)

    @property
    def queued(self) -> Tuple[Request, ...]:
        return tuple(self._queue)


class ArrivalQueueScheduler(GlobalQueueScheduler):
    """FCFS queue where a request only becomes schedulable once its
    ``arrival`` time has passed (open-loop online traffic, e.g. Poisson
    arrivals — ``benchmarks/mixed_batch.py``).

    The executor publishes its stage clock through ``set_now`` before every
    batch proposal; ``peek`` then surfaces only arrived requests, and
    ``next_arrival`` lets an idle engine fast-forward through an empty gap
    instead of spinning or deadlocking. ``has_pending`` counts *all*
    undelivered requests (including future arrivals) so the serve loop does
    not drain early."""

    def __init__(self, requests: Sequence[Request]):
        super().__init__(sorted(requests, key=lambda r: (r.arrival, r.rid)))
        self.now = 0.0

    def set_now(self, now: float) -> None:
        if now > self.now:
            self.now = now

    def pending_count(self) -> int:
        """Only *arrived* requests count as schedulable pressure — the
        policies price waiter pressure (w in prefill_share, the Lagrangian
        C_d) against work they could actually admit now, and a queue of
        far-future arrivals would inflate it. ``has_pending`` still counts
        everything so the serve loop does not drain early."""
        n = 0
        for r in self._queue:              # arrival-sorted: stop at the
            if r.arrival > self.now:       # first future request instead
                break                      # of scanning the whole queue
            n += 1
        return n

    def peek(self, client: ClientState, claimed: Set[int]) -> Optional[Request]:
        for r in self._queue:
            if r.arrival > self.now:
                break                      # queue is arrival-sorted
            if r.rid not in claimed:
                return r
        return None

    def next_arrival(self) -> Optional[float]:
        for r in self._queue:
            if r.arrival > self.now:
                return r.arrival
        return None

    def push(self, request: Request) -> None:
        """External admission preserving the arrival-sorted invariant peek /
        next_arrival rely on (a plain append would break early-exit scans)."""
        import bisect

        keys = [(r.arrival, r.rid) for r in self._queue]
        self._queue.insert(
            bisect.bisect_right(keys, (request.arrival, request.rid)), request
        )

    def steal_longest(self) -> Optional[Request]:
        """Only *arrived* requests are stealable — a future arrival is not
        work a starving replica could start now."""
        victim = self.peek_longest()
        if victim is not None:
            self._queue.remove(victim)
        return victim

    def peek_longest(self) -> Optional[Request]:
        arrived = [r for r in self._queue if r.arrival <= self.now]
        if not arrived:
            return None
        return max(arrived, key=lambda r: r.est_total_tokens)


def build_clients(
    n_clients: int,
    requests: Sequence[Request],
    assignment: Optional[List[List[int]]] = None,
) -> List[ClientState]:
    """Materialize ClientStates with backlogs from an assignment.

    ``assignment[j]`` is a list of request ids for client j (e.g. from
    ``offline.solve_offline`` or ``offline.round_robin_assign``). With no
    assignment, backlogs stay empty (use GlobalQueueScheduler then).
    """
    by_rid: Dict[int, Request] = {r.rid: r for r in requests}
    clients = [ClientState(cid=j) for j in range(n_clients)]
    if assignment is not None:
        if len(assignment) != n_clients:
            raise ValueError("assignment length != n_clients")
        seen: Set[int] = set()
        for j, rids in enumerate(assignment):
            for rid in rids:
                if rid in seen:
                    raise ValueError(f"request {rid} assigned twice")
                seen.add(rid)
                clients[j].backlog.append(by_rid[rid])
        if len(seen) != len(requests):
            missing = set(by_rid) - seen
            raise ValueError(f"requests not assigned: {sorted(missing)[:5]}...")
    return clients
