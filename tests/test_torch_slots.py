"""Port, KV slot management: allocator and slot-manager churn hold the
invariants the reference's tests hold (tests/test_overload.py,
tests/test_prefix_cache.py): no page leaked or owned twice, a double free is
refused, the device block table mirrors the host tables, and refcounts
match block-table rows plus prefix-index holds."""
import numpy as np
import pytest
import torch

from repro_torch.serving.kv_slots import BlockAllocator, PagedSlotManager
from torch_port_helpers import CFG
from repro_torch.models.transformer import TransformerLM
from repro_torch.core.types import Request


def test_allocator_churn_never_leaks_or_double_owns():
    rng = np.random.default_rng(0)
    alloc = BlockAllocator(num_pages=24, page_size=4)
    held = []
    for _ in range(400):
        if held and (rng.random() < 0.45 or alloc.num_free == 0):
            pages = held.pop(int(rng.integers(len(held))))
            alloc.release(pages)
        elif rng.random() < 0.15 and held:
            pages = held[int(rng.integers(len(held)))]
            alloc.share(pages)               # a second owner of live pages
            held.append(list(pages))
        else:
            n = int(rng.integers(1, 4))
            if alloc.can_allocate(n):
                held.append(alloc.allocate(n))
        alloc.check_consistency()
        owners = {}
        for pages in held:
            for p in pages:
                owners[p] = owners.get(p, 0) + 1
        assert all(alloc.ref_count(p) == n for p, n in owners.items())
        assert alloc.num_used == len(owners)
    for pages in held:
        alloc.release(pages)
    assert alloc.num_free == 24


def test_allocator_refuses_double_free_and_stale_share():
    alloc = BlockAllocator(num_pages=4, page_size=4)
    pages = alloc.allocate(2)
    alloc.release(pages)
    with pytest.raises(RuntimeError, match="double free"):
        alloc.release(pages)
    with pytest.raises(RuntimeError, match="share of free"):
        alloc.share(pages[:1])
    with pytest.raises(RuntimeError, match="exhausted"):
        alloc.allocate(5)


def _manager(prefix_cache=False, num_pages=None):
    model = TransformerLM(CFG, device="cpu")
    return PagedSlotManager(model, n_slots=4, max_len=32, page_size=4,
                            num_pages=num_pages, prefix_cache=prefix_cache)


def _req(rid, n_prefill=9):
    return Request(rid=rid, n_prefill=n_prefill, n_decode=4)


def test_slot_manager_churn_keeps_the_device_mirror():
    rng = np.random.default_rng(1)
    mgr = _manager(num_pages=20)
    rid = 0
    for _ in range(120):
        slot = int(rng.integers(4))
        if mgr.request_of[slot] is not None and rng.random() < 0.4:
            mgr.release(slot)
        elif mgr.request_of[slot] is not None:
            want = len(mgr.tables[slot]) * mgr.page_size + int(rng.integers(1, 6))
            if mgr.pages_to_cover(slot, want) <= mgr.allocator.num_free:
                mgr.ensure_tokens(slot, want)
        elif mgr.allocator.num_free >= 3:
            mgr.reserve(slot, int(rng.integers(1, 12)))
            mgr.bind(slot, _req(rid))
            rid += 1
        mgr.allocator.check_consistency()
        mgr.check_block_table_mirror()
        mgr.check_refcounts()
    for s in mgr.active_slots:
        mgr.release(s)
    assert mgr.allocator.num_used == 0
    assert (mgr.cache["block_tables"] == -1).all()


def test_mirror_check_catches_a_skipped_mirror_write():
    mgr = _manager()
    mgr.reserve(0, 8)
    mgr.cache["block_tables"][0, 0] = -1
    with pytest.raises(AssertionError, match="diverged"):
        mgr.check_block_table_mirror()


def test_prefix_adoption_shares_pages_and_copies_the_divergence_page():
    mgr = _manager(prefix_cache=True)
    prompt = np.arange(1, 11, dtype=np.int32)             # 10 tokens: 2 full pages
    mgr.reserve_with_prefix(0, prompt, len(prompt))
    mgr.cache["k"][:, :, mgr.tables[0][1]] = 7.0          # content of page 2
    mgr.bind(0, _req(0, 10))
    assert mgr.publish_prefix(0, prompt) == 2
    other = np.concatenate([prompt[:6], [99, 98, 97]]).astype(np.int32)
    cached = mgr.reserve_with_prefix(1, other, len(other))
    assert cached == 6                                    # one page + 2 tokens
    assert mgr.tables[1][0] == mgr.tables[0][0]           # shared read-only
    assert mgr.tables[1][1] != mgr.tables[0][1]           # copy-on-write
    assert torch.equal(mgr.cache["k"][:, :, mgr.tables[1][1]],
                       mgr.cache["k"][:, :, mgr.tables[0][1]])
    assert mgr.cow_copies == 1 and int(mgr.cache["length"][1]) == 6
    mgr.check_refcounts()
    mgr.release(0)
    mgr.free_pages_of(1)
    mgr.check_refcounts()
    assert mgr.prefix_index.clear() == 2
    assert mgr.allocator.num_used == 0
