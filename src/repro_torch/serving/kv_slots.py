"""Slot managers (counterpart of ``repro.serving.kv_slots``).

J slots ↔ the paper's J parallel clients. Two KV ownership models:

  * ``SlotManager`` — each slot owns one dense row of the batched cache
    (a full row of max_len, or a ring of W for sliding-window configs); a
    packed prefill's cache is merged into the slot rows (``scatter_cache``).
  * ``PagedSlotManager`` — slots own *pages* of a shared pool, handed out by
    a host-side refcounted ``BlockAllocator`` and resolved through the
    device block table (see ``models.cache``). ``PrefixCacheIndex`` shares
    full prompt pages across requests (copy-on-write at the divergence
    page). The allocator and the index are host-side bookkeeping, copied
    from the reference; ``PagedSlotManager`` mirrors every block-table row
    it changes to the device pool.

A slot's pages export and import by page-copy for live migration between
engines (``export_pages`` / ``import_pages``), guarded by a CRC32 of the
payload bytes (``page_checksum``) that equals the reference's on the same
arrays.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.types import Request


class PageIntegrityError(RuntimeError):
    """A migrated KV payload failed its content checksum at import. The
    destination pool is untouched when this raises — callers fall back to
    recompute-on-resume (``Fleet.migrate_slot``) instead of continuing a
    poisoned stream."""


def _payload_bytes(x: torch.Tensor) -> np.ndarray:
    """The raw bytes of ``x`` in row-major order, on the host (bf16 has no
    numpy dtype: its bytes are read as uint8, as ``ml_dtypes`` lays them)."""
    return x.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()


def page_checksum(k_pages: torch.Tensor, v_pages: torch.Tensor, kv_length: int) -> int:
    """Content checksum of a page-copy payload: CRC32 over the K and V
    payload bytes plus the valid-KV length — the reference's checksum of the
    same arrays. Computed at ``export_pages`` and verified at
    ``import_pages``; the cost is one device-to-host copy of the payload."""
    h = zlib.crc32(_payload_bytes(k_pages))
    h = zlib.crc32(_payload_bytes(v_pages), h)
    return zlib.crc32(str(int(kv_length)).encode(), h)


def scatter_cache(
    main: Dict[str, torch.Tensor], pref: Dict[str, torch.Tensor],
    slots: torch.Tensor,
) -> None:
    """Scatter prefill-cache rows into slot rows of ``main``, in place.

    ``slots`` (n,) int64 names the target row of each of the prefill cache's
    rows (distinct, in range). Rank-1 leaves (``length``) and rank-2 leaves
    (ring ``pos``) carry the batch on axis 0, the rest (``k``/``v``,
    (L, B, S, KV, D)) on axis 1. The prefill cache's sequence axis may be a
    shorter bucket than the main cache's: the target rows are zeroed past the
    bucket, so nothing of a previous occupant survives; ring ``pos`` rows
    are padded with -1 (empty) likewise."""
    for key, m in main.items():
        p = pref[key].to(m.dtype)
        if m.dim() == 1:
            m.index_copy_(0, slots, p)
        elif m.dim() == 2:
            m.index_fill_(0, slots, -1)
            m.narrow(1, 0, p.shape[1]).index_copy_(0, slots, p)
        else:
            s = p.shape[2]
            if s < m.shape[2]:
                m.narrow(2, s, m.shape[2] - s).index_fill_(1, slots, 0)
            m.narrow(2, 0, s).index_copy_(1, slots, p)


class SlotManager:
    """Slot manager for the dense layout: the slot cache is preallocated at
    ``n_slots`` rows of ``max_len`` (``model.cache_init``)."""

    def __init__(self, model, n_slots: int, max_len: int):
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.cache = model.cache_init(n_slots, max_len)
        self.request_of: List[Optional[Request]] = [None] * n_slots
        self.emitted: List[int] = [0] * n_slots

    @property
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.request_of) if r is None]

    @property
    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.request_of) if r is not None]

    def bind(self, slot: int, request: Request) -> None:
        if self.request_of[slot] is not None:
            raise RuntimeError(f"slot {slot} already bound")
        self.request_of[slot] = request
        self.emitted[slot] = 0

    def release(self, slot: int) -> Request:
        req = self.request_of[slot]
        if req is None:
            raise RuntimeError(f"slot {slot} not bound")
        self.request_of[slot] = None
        self.emitted[slot] = 0
        return req

    def merge_prefill(self, prefill_cache: Dict[str, torch.Tensor], slots: Sequence[int]) -> None:
        """Move a packed prefill's cache (batch = len(slots)) into the slot
        cache rows."""
        idx = torch.tensor(list(slots), dtype=torch.long, device=self.cache["length"].device)
        scatter_cache(self.cache, prefill_cache, idx)


class BlockAllocator:
    """Host-side refcounted free-list allocator for the paged KV pool.

    Pure bookkeeping — page contents live on device; this hands out page ids
    and tracks how many owners each page has. ``allocate`` hands out fresh
    pages at refcount 1, ``share`` adds an owner to a live page (prefix-cache
    adoption / index holds), and ``release`` drops one owner — a page returns
    to the free list only when its last reference goes. LIFO reuse keeps
    recently freed (cache-warm) pages hot. A persistent free-*set* shadows
    the LIFO list so double-free detection is O(pages released), not
    O(pool) — under preemption churn every eviction releases pages, so this
    is a hot path."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._free_set: set = set(self._free)
        self._refs: List[int] = [0] * num_pages

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_pages - len(self._free)

    def ref_count(self, page: int) -> int:
        return self._refs[page]

    def num_shared(self) -> int:
        """Pages with more than one live owner right now."""
        return sum(1 for r in self._refs if r >= 2)

    def pages_for(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.page_size))

    def can_allocate(self, n_pages: int) -> bool:
        return n_pages <= len(self._free)

    def allocate(self, n_pages: int) -> List[int]:
        if not self.can_allocate(n_pages):
            raise RuntimeError(
                f"page pool exhausted: want {n_pages}, have {len(self._free)} "
                f"of {self.num_pages}"
            )
        out = self._free[-n_pages:][::-1]
        del self._free[-n_pages:]
        self._free_set.difference_update(out)
        for p in out:
            self._refs[p] = 1
        return out

    def share(self, pages: Sequence[int]) -> None:
        """Add one owner to each page. Only live pages can gain owners —
        sharing a free page means the caller holds a stale id."""
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"page {p} out of range")
            if self._refs[p] <= 0:
                raise RuntimeError(f"share of free KV page {p}")
        for p in pages:
            self._refs[p] += 1

    def release(self, pages: Sequence[int]) -> List[int]:
        """Drop one owner per page; pages whose last reference goes return
        to the free list. Returns the pages actually freed. Releasing a page
        with no owners is the refcount-world double free."""
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"page {p} out of range")
        if any(self._refs[p] <= 0 or p in self._free_set for p in pages):
            raise RuntimeError("double free of KV page")
        freed = []
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                freed.append(p)
        self._free.extend(freed)
        self._free_set.update(freed)
        self.check_consistency()
        return freed

    # kept as the historical name — release IS free in refcount world
    free = release

    def reset(self, in_use: Sequence[int] = ()) -> None:
        """Rebuild the free list from the in-use pages of a restored
        checkpoint. ``in_use`` may repeat a page id — multiplicity IS the
        refcount (a page shared by k block-table rows appears k times)."""
        refs = [0] * self.num_pages
        for p in in_use:
            refs[p] += 1
        self._refs = refs
        self._free = [
            p for p in range(self.num_pages - 1, -1, -1) if refs[p] == 0
        ]
        self._free_set = set(self._free)

    def check_consistency(self) -> None:
        """Free list, free set, and refcounts must describe the same pages —
        a divergence means a page was leaked, double-owned, or freed while
        referenced."""
        if len(self._free) != len(self._free_set):
            raise AssertionError(
                f"allocator free list ({len(self._free)}) and free set "
                f"({len(self._free_set)}) diverged"
            )
        for p in self._free_set:
            if self._refs[p] != 0:
                raise AssertionError(
                    f"page {p} is on the free list with refcount {self._refs[p]}"
                )
        live = sum(1 for r in self._refs if r > 0)
        if live != self.num_used:
            raise AssertionError(
                f"{live} pages hold references but {self.num_used} are "
                f"off the free list — a page leaked or was double-owned"
            )


class PrefixCacheIndex:
    """Content-addressed index of *full* KV pages for prefix-cache reuse.

    Pages are keyed by a chained hash à la vLLM: a page holding prompt
    tokens ``t[i·ps:(i+1)·ps]`` hashes as ``H(parent_key, page_tokens)``
    where ``parent_key`` is the key of the page before it (root sentinel
    for the first page). Two prompts that share a prefix walk to the same
    keys, so lookup is a chain walk that stops at the first miss; the
    divergence *within* a page is found by scanning the last matched key's
    children for the longest common token prefix — that page is the
    copy-on-write source.

    The index holds one allocator reference per published page, so cached
    pages survive their publisher's release. ``reclaim`` evicts
    least-recently-touched entries whose page has no owner besides the
    index (refcount 1) and no children still in the index — eviction of a
    page some slot still shares is structurally impossible, and parents
    are never removed from under reachable children (which would leak the
    child's hold forever)."""

    _ROOT = 0xA5A5A5A5

    def __init__(self, allocator: BlockAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        # key -> (page, tokens tuple, parent key); insertion order is
        # maintained separately as the LRU clock
        self._entries: Dict[int, Tuple[int, Tuple[int, ...], int]] = {}
        self._children: Dict[int, set] = {}
        self._clock = 0
        self._touched: Dict[int, int] = {}
        self.lookups = 0
        self.hit_tokens = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _hash(parent_key: int, tokens: Sequence[int]) -> int:
        import hashlib

        data = int(parent_key).to_bytes(8, "big") + np.asarray(
            tokens, dtype=np.int64
        ).tobytes()
        return int.from_bytes(
            hashlib.blake2b(data, digest_size=8).digest(), "big"
        )

    def _touch(self, key: int) -> None:
        self._clock += 1
        self._touched[key] = self._clock

    def held_pages(self) -> List[int]:
        """Pages the index itself holds a reference on (one per entry)."""
        return [page for page, _, _ in self._entries.values()]

    # -- lookup ---------------------------------------------------------- #
    def match(
        self, tokens: np.ndarray
    ) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Longest cached prefix of ``tokens``: a list of fully matched
        pages (position order) plus, at the divergence point, the best
        partially matching page as ``(page, n_matched_tokens)`` — the COW
        source — or None if the next page is a clean miss."""
        self.lookups += 1
        ps = self.page_size
        toks = np.asarray(tokens)
        full, parent = [], self._ROOT
        n_full = len(toks) // ps
        i = 0
        while i < n_full:
            key = self._hash(parent, toks[i * ps:(i + 1) * ps])
            ent = self._entries.get(key)
            if ent is None:
                break
            self._touch(key)
            full.append(ent[0])
            parent = key
            i += 1
        # partial match inside the next page: scan the last matched key's
        # children for the longest common prefix with the remaining tokens
        rest = toks[i * ps:]
        best: Optional[Tuple[int, int]] = None
        if len(rest) > 0:
            for key in self._children.get(parent, ()):
                page, ent_toks, _ = self._entries[key]
                n = 0
                m = min(len(rest), len(ent_toks))
                while n < m and int(rest[n]) == ent_toks[n]:
                    n += 1
                if n > 0 and (best is None or n > best[1]):
                    best = (page, n)
                    if n == m:
                        break
            if best is not None:
                self._touch(
                    next(
                        k for k in self._children.get(parent, ())
                        if self._entries[k][0] == best[0]
                    )
                )
        return full, best

    # -- publication ------------------------------------------------------ #
    def insert(self, tokens: np.ndarray, pages: Sequence[int]) -> int:
        """Publish the full pages of a completed prompt: ``pages[i]`` holds
        ``tokens[i·ps:(i+1)·ps]``. Already-indexed content is skipped (the
        existing entry keeps serving hits); new entries take one allocator
        reference each. Returns the number of pages newly published."""
        ps = self.page_size
        toks = np.asarray(tokens)
        parent, added = self._ROOT, 0
        for i in range(min(len(toks) // ps, len(pages))):
            page_toks = tuple(int(t) for t in toks[i * ps:(i + 1) * ps])
            key = self._hash(parent, page_toks)
            if key not in self._entries:
                self.allocator.share([pages[i]])
                self._entries[key] = (pages[i], page_toks, parent)
                self._children.setdefault(parent, set()).add(key)
                added += 1
            self._touch(key)
            parent = key
        return added

    # -- eviction ---------------------------------------------------------- #
    def _evictable(self, key: int) -> bool:
        page = self._entries[key][0]
        return (
            self.allocator.ref_count(page) == 1
            and not self._children.get(key)
        )

    def _evict(self, key: int) -> None:
        page, _, parent = self._entries.pop(key)
        kids = self._children.get(parent)
        if kids is not None:
            kids.discard(key)
            if not kids:
                del self._children[parent]
        self._children.pop(key, None)
        self._touched.pop(key, None)
        self.allocator.release([page])
        self.evictions += 1

    def reclaim(self, n_pages: int) -> int:
        """Evict index-only pages (LRU first, leaves before parents) until
        ``n_pages`` have been freed or nothing evictable remains. Returns
        pages freed."""
        freed = 0
        while freed < n_pages:
            cands = [
                k for k in sorted(
                    self._entries, key=lambda k: self._touched.get(k, 0)
                )
                if self._evictable(k)
            ]
            if not cands:
                break
            for k in cands:
                self._evict(k)
                freed += 1
                if freed >= n_pages:
                    break
        return freed

    def reclaimable_pages(self) -> int:
        """How many pages eviction could free right now: entries whose page
        has no owner but the index, counted with leaf-to-root cascading
        (a parent counts only if its whole reachable subtree is index-only)."""
        kids = {k: set(v) for k, v in self._children.items()}
        alive = set(self._entries)
        n = 0
        progress = True
        while progress:
            progress = False
            for k in list(alive):
                if kids.get(k):
                    continue
                if self.allocator.ref_count(self._entries[k][0]) != 1:
                    continue
                alive.discard(k)
                parent = self._entries[k][2]
                if parent in kids:
                    kids[parent].discard(k)
                n += 1
                progress = True
        return n

    def clear(self) -> int:
        """Drop every entry, releasing the index's holds (end-of-serve
        refcount audit, cold-start). Returns pages whose last reference
        this released."""
        freed = 0
        for page, _, _ in self._entries.values():
            freed += len(self.allocator.release([page]))
        self._entries.clear()
        self._children.clear()
        self._touched.clear()
        return freed

    def invalidate(self) -> None:
        """Forget every entry WITHOUT touching the allocator — for restore
        paths where the allocator was rebuilt from the device block tables
        and the index's holds are already gone."""
        self._entries.clear()
        self._children.clear()
        self._touched.clear()


class PagedSlotManager:
    """Slot manager for the paged cache layout.

    ``reserve`` hands a slot pages covering an initial token span (the
    engine decides how much: the prompt under on-demand paging, the whole
    prompt + decode bound under up-front reservation) and ``ensure_tokens``
    grows the slot's table page-by-page as decode crosses page boundaries.
    When growth finds the pool exhausted the *engine* preempts a
    lowest-priority slot (``free_pages_of`` + re-queue) — the manager only
    does page bookkeeping. Block table rows are mirrored to the device pool
    on reserve/grow/release (small host-to-device copies; the pool itself is
    updated in place)."""

    def __init__(
        self,
        model,
        n_slots: int,
        max_len: int,
        page_size: int,
        num_pages: Optional[int] = None,
        prefix_cache: bool = False,
    ):
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.page_size = page_size
        self.max_pages_per_slot = -(-max_len // page_size)
        self.num_pages = (
            num_pages if num_pages is not None
            else n_slots * self.max_pages_per_slot
        )
        self.cache = model.paged_cache_init(
            self.num_pages, page_size, n_slots, self.max_pages_per_slot
        )
        self.allocator = BlockAllocator(self.num_pages, page_size)
        self.prefix_index: Optional[PrefixCacheIndex] = (
            PrefixCacheIndex(self.allocator, page_size) if prefix_cache else None
        )
        self.tables: List[List[int]] = [[] for _ in range(n_slots)]
        self.request_of: List[Optional[Request]] = [None] * n_slots
        self.emitted: List[int] = [0] * n_slots
        self.peak_pages = 0
        self.shared_pages_peak = 0
        self.cow_copies = 0
        # observability hooks, set by the owning engine when a serve opts
        # in (EngineConfig.observe); obs_now is refreshed each serve step
        # so COW instants land at the engine's current virtual time
        self.obs = None
        self.obs_replica = 0
        self.obs_now = 0.0

    @property
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.request_of) if r is None]

    @property
    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.request_of) if r is not None]

    def bind(self, slot: int, request: Request) -> None:
        if self.request_of[slot] is not None:
            raise RuntimeError(f"slot {slot} already bound")
        self.request_of[slot] = request
        self.emitted[slot] = 0

    # -- page ownership ------------------------------------------------ #
    def _mirror_row(self, slot: int) -> None:
        """Push ``slot``'s host block-table row to the device pool."""
        row = np.full((self.max_pages_per_slot,), -1, np.int32)
        pages = self.tables[slot]
        row[: len(pages)] = pages
        self.cache["block_tables"][slot].copy_(torch.from_numpy(row))

    def _alloc(self, n_pages: int) -> List[int]:
        """Allocate fresh pages, evicting index-only cached pages on demand
        when the free list alone can't supply them."""
        short = n_pages - self.allocator.num_free
        if short > 0 and self.prefix_index is not None:
            self.prefix_index.reclaim(short)
        pages = self.allocator.allocate(n_pages)
        self.peak_pages = max(self.peak_pages, self.allocator.num_used)
        return pages

    def reserve(self, slot: int, n_tokens: int) -> None:
        """Give ``slot`` pages covering ``n_tokens`` and mirror its block
        table row to the device."""
        if self.tables[slot]:
            raise RuntimeError(f"slot {slot} already holds pages")
        n_tokens = min(n_tokens, self.max_len)
        pages = self._alloc(self.allocator.pages_for(n_tokens))
        self.tables[slot] = pages
        self._mirror_row(slot)

    # -- prefix-cache adoption / publication ----------------------------- #
    def probe_prefix(self, prompt: np.ndarray) -> int:
        """Read-only estimate of how many of ``prompt``'s tokens the cache
        could supply (clamped so at least one token is always recomputed —
        the first output token needs live logits)."""
        if self.prefix_index is None or len(prompt) == 0:
            return 0
        full, partial = self.prefix_index.match(prompt)
        cached = len(full) * self.page_size + (partial[1] if partial else 0)
        return min(cached, len(prompt) - 1)

    def _copy_page(self, src: int, dst: int) -> None:
        """Device copy of one page's K/V content (the COW divergence page)."""
        self.cache["k"][:, :, dst] = self.cache["k"][:, :, src]
        self.cache["v"][:, :, dst] = self.cache["v"][:, :, src]
        self.cow_copies += 1
        if self.obs is not None:
            self.obs.instant(
                "cow_copy", self.obs_now, replica=self.obs_replica,
                src_page=src, dst_page=dst,
            )

    def reserve_with_prefix(
        self, slot: int, prompt: np.ndarray, n_tokens: int
    ) -> int:
        """Like ``reserve``, but adopt the longest cached prefix of
        ``prompt`` first: fully matched pages are shared read-only
        (refcount + 1), and the page at the divergence point is
        copy-on-write. Returns the number of prompt tokens served from
        cache; chunked prefill should start at that offset."""
        if self.tables[slot]:
            raise RuntimeError(f"slot {slot} already holds pages")
        if self.prefix_index is None:
            self.reserve(slot, n_tokens)
            return 0
        ps = self.page_size
        full, partial = self.prefix_index.match(prompt)
        cached = len(full) * ps + (partial[1] if partial else 0)
        # always recompute ≥ 1 token: the final prompt token's logits seed
        # the first output token, and the page it lands in must be private
        cached = min(cached, len(prompt) - 1)
        n_shared = cached // ps
        shared = full[:n_shared]
        cow_src: Optional[int] = None
        if cached % ps:
            cow_src = full[n_shared] if n_shared < len(full) else partial[0]
        self.allocator.share(shared)
        n_total = self.allocator.pages_for(min(n_tokens, self.max_len))
        try:
            fresh = self._alloc(max(n_total - n_shared, 0))
        except RuntimeError:
            self.allocator.release(shared)
            raise
        if cow_src is not None and fresh:
            self._copy_page(cow_src, fresh[0])
        self.tables[slot] = shared + fresh
        self.shared_pages_peak = max(
            self.shared_pages_peak, self.allocator.num_shared()
        )
        self._mirror_row(slot)
        self.cache["length"][slot] = int(cached)
        return int(cached)

    def publish_prefix(self, slot: int, prompt: np.ndarray) -> int:
        """Publish the completed prompt's *full* pages to the prefix index
        (the partial last page keeps taking decode writes). Returns pages
        newly indexed."""
        if self.prefix_index is None:
            return 0
        n_full = len(prompt) // self.page_size
        return self.prefix_index.insert(prompt, self.tables[slot][:n_full])

    def reclaimable_pages(self) -> int:
        """Pages the prefix index could surrender on demand."""
        return (
            self.prefix_index.reclaimable_pages()
            if self.prefix_index is not None else 0
        )

    def owned_tokens(self, slot: int) -> int:
        """Token capacity of the pages ``slot`` currently owns."""
        return len(self.tables[slot]) * self.page_size

    def pages_to_cover(self, slot: int, n_tokens: int) -> int:
        """Additional pages ``slot`` needs to hold ``n_tokens`` KV entries
        (0 when its current pages already cover them)."""
        n_tokens = min(n_tokens, self.max_len)
        return max(
            0, self.allocator.pages_for(n_tokens) - len(self.tables[slot])
        )

    def ensure_tokens(self, slot: int, n_tokens: int) -> int:
        """Grow ``slot``'s page span to cover ``n_tokens`` (on-demand decode
        growth). Returns the pages added; raises if the pool cannot supply
        them — the engine preempts a victim and retries."""
        need = self.pages_to_cover(slot, n_tokens)
        if need == 0:
            return 0
        pages = self._alloc(need)
        self.tables[slot].extend(pages)
        self._mirror_row(slot)
        return need

    def release(self, slot: int) -> Request:
        req = self.request_of[slot]
        if req is None:
            raise RuntimeError(f"slot {slot} not bound")
        self.request_of[slot] = None
        self.emitted[slot] = 0
        self.free_pages_of(slot)
        return req

    def free_pages_of(self, slot: int) -> None:
        if self.tables[slot]:
            self.allocator.free(self.tables[slot])
            self.tables[slot] = []
        self.cache["block_tables"][slot] = -1
        self.cache["length"][slot] = 0

    # -- page-copy migration (live cross-engine slot transfer) ---------- #
    def export_pages(
        self, slot: int
    ) -> Tuple[List[int], torch.Tensor, torch.Tensor, int, int]:
        """Gather ``slot``'s KV pages out of the pool for migration.

        Returns ``(pages, k_payload, v_payload, kv_length, checksum)``: the
        payloads are ``(L, KV, n_pages, page_size, D)`` device tensors, an
        ``index_select`` along the pool's page axis (independent of which
        page ids the destination assigns), and ``checksum`` is their
        ``page_checksum``. The caller frees the source pages afterwards
        (``release`` / ``free_pages_of``)."""
        pages = list(self.tables[slot])
        if not pages:
            raise RuntimeError(f"slot {slot} holds no pages to export")
        idx = torch.tensor(pages, dtype=torch.long, device=self.cache["k"].device)
        k = self.cache["k"].index_select(2, idx)
        v = self.cache["v"].index_select(2, idx)
        length = int(self.cache["length"][slot])
        return pages, k, v, length, page_checksum(k, v, length)

    def import_pages(
        self,
        slot: int,
        k_pages: torch.Tensor,
        v_pages: torch.Tensor,
        kv_length: int,
        checksum: Optional[int] = None,
    ) -> List[int]:
        """Land exported KV payloads in freshly allocated pages of this
        pool: allocate, scatter, point ``slot``'s block-table row at the new
        pages and restore its valid-KV length. Returns the new pages.

        With ``checksum`` the received payload is re-hashed and verified
        BEFORE any pool state changes; a mismatch raises
        ``PageIntegrityError`` with the pool untouched."""
        if self.tables[slot]:
            raise RuntimeError(f"slot {slot} already holds pages")
        if checksum is not None:
            got = page_checksum(k_pages, v_pages, kv_length)
            if got != checksum:
                raise PageIntegrityError(
                    f"slot {slot}: KV payload checksum {got:#010x} != "
                    f"exported {checksum:#010x} — migration payload corrupt"
                )
        n = int(k_pages.shape[2])
        pages = self._alloc(n)
        pool_k, pool_v = self.cache["k"], self.cache["v"]
        idx = torch.tensor(pages, dtype=torch.long, device=pool_k.device)
        pool_k.index_copy_(2, idx, k_pages.to(pool_k.device, pool_k.dtype))
        pool_v.index_copy_(2, idx, v_pages.to(pool_v.device, pool_v.dtype))
        self.tables[slot] = pages
        self._mirror_row(slot)
        self.cache["length"][slot] = int(kv_length)
        return pages

    def sync_from_device(self) -> None:
        """Rebuild host tables and allocator from the device block table
        (checkpoint restore: the device array is the durable record).
        Refcounts come from block-table multiplicity; the prefix index's
        holds are not on the device, so the index restarts cold."""
        bt = self.cache["block_tables"].cpu().numpy()
        self.tables = [[int(p) for p in row if p >= 0] for row in bt]
        self.allocator.reset([p for row in self.tables for p in row])
        if self.prefix_index is not None:
            self.prefix_index.invalidate()
        self.peak_pages = max(self.peak_pages, self.allocator.num_used)

    # -- accounting ---------------------------------------------------- #
    def kv_bytes_in_use(self) -> int:
        """Bytes of KV pool owned by slots right now."""
        return self.allocator.num_used * (
            self.kv_bytes_capacity() // self.allocator.num_pages
        )

    def kv_bytes_capacity(self) -> int:
        k, v = self.cache["k"], self.cache["v"]
        return k.numel() * k.element_size() + v.numel() * v.element_size()

    def peak_kv_bytes(self) -> int:
        """High-water mark of slot-owned KV bytes over the manager's life."""
        if self.allocator.num_pages == 0:
            return 0
        return self.peak_pages * (self.kv_bytes_capacity() // self.allocator.num_pages)

    # -- invariants ------------------------------------------------------ #
    def check_block_table_mirror(self) -> None:
        """The host ``tables`` and the device ``block_tables`` must describe
        the same page ownership row for row, and a slot owning no pages must
        hold no KV length (``EngineConfig.debug_invariants`` asserts this at
        stage boundaries; it copies the table to the host)."""
        bt = self.cache["block_tables"].cpu().numpy()
        lengths = self.cache["length"].cpu().numpy()
        for slot, pages in enumerate(self.tables):
            row = np.full((self.max_pages_per_slot,), -1, np.int32)
            row[: len(pages)] = pages
            if not np.array_equal(bt[slot], row):
                raise AssertionError(
                    f"slot {slot}: host block table {pages} diverged from "
                    f"device row {bt[slot].tolist()}"
                )
            if not pages and int(lengths[slot]) != 0:
                raise AssertionError(
                    f"slot {slot}: owns no pages but device KV length is "
                    f"{int(lengths[slot])}"
                )

    def check_refcounts(self) -> None:
        """Every page's allocator refcount must equal its owners as the
        manager sees them: one per block-table row it appears in, plus one
        if the prefix index holds it."""
        expected = [0] * self.allocator.num_pages
        for pages in self.tables:
            for p in pages:
                expected[p] += 1
        if self.prefix_index is not None:
            for p in self.prefix_index.held_pages():
                expected[p] += 1
        for p, want in enumerate(expected):
            got = self.allocator.ref_count(p)
            if got != want:
                raise AssertionError(
                    f"page {p}: allocator refcount {got} != {want} owners "
                    f"(block-table rows + index hold)"
                )
