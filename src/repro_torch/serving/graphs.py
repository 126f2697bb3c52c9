"""Captured serving dispatches: the port's counterpart of the reference
engine's ``jax.jit(..., donate_argnums=...)`` executables
(``repro/serving/engine.py:413-440``).

The reference compiles one executable for each dispatch shape (a fused
decode per horizon bucket, the mixed and chunk rounds of the paged layout,
the dense prefill) and calls it with the cache donated. Here each dispatch
is keyed by ``(kind, static shape, stochastic)`` and held as a
``Dispatch``: static input buffers, one ``torch.cuda.CUDAGraph`` that
replays every kernel of the call, and the graph's static outputs.

* ``prepare(key)`` builds a key's buffers and function (the owner's
  ``build``), runs the call once eagerly on its all-inactive inputs (writes
  dropped, lengths untouched: it loads every kernel module and warms cuBLAS
  on the capture stream), then captures the call on that side stream into
  the owner's one memory pool. The outputs stay alive as long as the owner.
* ``load(key, **inputs)`` copies inputs into the static buffers;
  ``replay(key)`` replays the graph and returns the static outputs;
  ``run`` does both.
* On a CPU device nothing is captured: ``replay`` calls the same function on
  the same static buffers, so the CPU tests run the copy-in and copy-out
  logic the card runs. Dispatch follows the tensors' device only, as the
  kernels' wrappers do: there is no switch and no fallback. A capture that
  fails raises; so does a key that was never prepared.

Hazards, each handled here or by the owner, and checked:

* **The split scratch** (``kernels/decode_split.py:workspace``). The decode
  kernels share one scratch a device and replace it with a larger one when a
  plan needs more; a graph captured before such a swap would replay into
  freed memory. The owner sizes it for the largest plan of every key it can
  dispatch (``decode_scratch``) before the first capture; a capture that
  still swaps it raises, and every replay asserts that the pointers the
  graph holds are the scratch's current ones.
* **The RG-LRU scan's control buffer** (``kernels/rglru.py:_control``:
  the chunked scan's ticket and its maps, tagged by call). Each launch
  leaves it ready for the next, so a replay needs no memset; it grows only
  outside a capture (the eager call before each capture sizes it), and a
  grown-out buffer is kept alive for the graphs that hold it.
* **Launch counts.** The kernel wrappers count launches on the host, so a
  replay adds nothing by itself. Each dispatch records the launches of one
  call by kernel (the eager call's, which the capture must match) and adds
  them on every replay; the capture's own host-side increments, which ran
  nothing, are taken back. The counters keep meaning "launches the device
  ran".
* **Outputs that outlive a call.** A static output is overwritten by the
  key's next replay, and the owner's graphs share one pool, so another
  key's replay may reuse its memory. Whatever must outlive the call is
  copied into owner buffers (the engine's pending tokens) before the next
  replay; every other output is read at once.
* **State updated in place.** The caches a graph reads and writes are the
  owner's, updated in place by every other path (slot binding, merges,
  migration, checkpoint restore) and never reassigned.
* **Parameter views.** A model's serving views of its parameters (float32
  copies of bf16 norm scales and gates; ``models.layers.ViewCache``) are
  refreshed by an eager call after an in-place optimizer step, and a replay
  runs none: the owner's ``refresh`` (the model's ``refresh_views`` on its
  parameters) runs before every replay, so a graph never reads views older
  than the parameters.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import decode_attention, decode_split, flash_attention, paged_decode_attention, rglru

#: the serving kernels' wrapper modules, by launch-count name
KERNELS = {
    "paged_decode_attention": paged_decode_attention,
    "flash_attention": flash_attention,
    "decode_attention": decode_attention,
    "rglru_scan": rglru,
}


class Key(NamedTuple):
    kind: str                  # "decode" | "mixed" | "chunk" | "prefill" | "wave"
    shape: Tuple[int, ...]     # horizon K | row bucket | (requests, sequence) | wave size
    stochastic: bool           # the sampler draws from threefry keys


Build = Callable[[Key], Tuple[Dict[str, Any], Callable[[Dict[str, Any]], Any]]]


@dataclasses.dataclass
class Dispatch:
    key: Key
    inputs: Dict[str, Any]                 # static input buffers (tensors or trees of them)
    fn: Callable[[Dict[str, Any]], Any]
    launches: Dict[str, int]               # kernel launches one call makes, by counter
    graph: Optional["torch.cuda.CUDAGraph"] = None
    outputs: Any = None                    # the graph's static outputs
    scratch: Optional[Tuple[int, int]] = None   # split-scratch pointers the graph holds


def launch_counts() -> Dict[str, int]:
    """Every serving kernel wrapper's launch count (flash's also by body,
    the RG-LRU scan's also by device kernel)."""
    out = {name: mod.launch_count for name, mod in KERNELS.items()}
    out.update({f"flash_attention/{v}": n
                for v, n in flash_attention.launch_count_by_variant.items()})
    out.update({f"rglru_scan/{k}": n for k, n in rglru.launch_count_by_kernel.items()})
    return out


def set_launch_counts(counts: Dict[str, int]) -> None:
    for name, mod in KERNELS.items():
        mod.launch_count = counts[name]
    for v in flash_attention.launch_count_by_variant:
        flash_attention.launch_count_by_variant[v] = counts[f"flash_attention/{v}"]
    for k in rglru.launch_count_by_kernel:
        rglru.launch_count_by_kernel[k] = counts[f"rglru_scan/{k}"]


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


def _scratch_pointers(device: torch.device) -> Optional[Tuple[int, int]]:
    cur = decode_split.current(device)
    return None if cur is None else (cur[0].data_ptr(), cur[1].data_ptr())


def decode_scratch(cache: Dict[str, torch.Tensor], n_heads: int, n_sms: int) -> Tuple[int, int]:
    """(floats, counters) of split scratch that one decode lane a slot of
    ``cache`` needs: kernel 1's plan over a paged pool (a ``block_tables``
    key), kernel 3's over a dense full or ring cache ``(L, B, S, KV, D)``.
    Every decode and mixed dispatch of an engine hands its decode kernel
    these shapes, whatever its key."""
    if "block_tables" in cache:
        _, kv, _, page, d = cache["k"].shape
        b, mb = cache["block_tables"].shape
        return paged_decode_attention.decode_plan(b, n_heads, kv, mb, page, n_sms).scratch(b, kv, d)
    k = cache["k"]
    _, b, s, kv, d = k.shape
    return decode_attention.plan(k.dtype, b, n_heads, kv, s, d, n_sms).split.scratch(b, kv, d)


def sm_count(device: torch.device) -> int:
    return flash_attention._sm_count(device.index or 0)


def _copy_in(buf, value) -> None:
    if isinstance(buf, dict):
        for k, v in value.items():
            _copy_in(buf[k], v)
    elif isinstance(value, np.ndarray):
        buf.copy_(torch.from_numpy(value))
    else:
        buf.copy_(value)


class Dispatches:
    """One owner's captured dispatches (an engine's, or a wave server's).

    ``build(key)`` returns the key's static inputs, at the values of its
    all-inactive call, and the function of those inputs to capture.
    ``scratch`` is the split scratch (floats, counters) the largest plan of
    every key needs, reserved before the first capture. ``refresh``, where
    given, runs before every replay (the parameter-views hazard)."""

    def __init__(self, device: torch.device, build: Build, scratch: Tuple[int, int] = (0, 0),
                 refresh: Optional[Callable[[], Any]] = None):
        self.device = device
        self.build = build
        self.scratch = scratch
        self.refresh = refresh
        self._entries: Dict[Key, Dispatch] = {}
        self.captures = 0
        self.replays = 0          # on a CPU device: calls in place of replays
        self.capture_s = 0.0
        self.pool_bytes = 0
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device)

    @property
    def keys(self):
        return set(self._entries)

    def stats(self) -> Dict[str, Any]:
        return dict(captures=self.captures, replays=self.replays,
                    capture_s=round(self.capture_s, 6), pool_mib=round(self.pool_bytes / 2**20, 3))

    def prepare(self, key: Key) -> Dispatch:
        """The key's dispatch, built, warmed and captured on first use."""
        entry = self._entries.get(key)
        if entry is not None:
            return entry
        inputs, fn = self.build(key)
        before = launch_counts()
        if not self._cuda:
            fn(inputs)
            entry = Dispatch(key, inputs, fn, _delta(launch_counts(), before))
        else:
            entry = self._capture(key, inputs, fn, before)
        self._entries[key] = entry
        return entry

    def _capture(self, key: Key, inputs, fn, before) -> Dispatch:
        dev, stream = self.device, self._stream
        if self.scratch[1]:
            # the split-scratch hazard: size it for every key before capturing
            decode_split.workspace(dev, *self.scratch)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            fn(inputs)                  # the all-inactive call, on the capture stream
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        launches = _delta(launch_counts(), before)
        scratch = _scratch_pointers(dev)
        counted = launch_counts()
        graph = torch.cuda.CUDAGraph()
        # the capture empties the allocator's cache first: so does the
        # reading it is measured from, so the growth is the pool's
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self._pool, stream=stream):
            outputs = fn(inputs)
        torch.cuda.synchronize(dev)
        self.capture_s += time.perf_counter() - t0
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        self.captures += 1
        captured = _delta(launch_counts(), counted)
        set_launch_counts(counted)      # the capture launched nothing
        if captured != launches:
            raise RuntimeError(f"dispatch {key}: the capture recorded launches {captured}, "
                               f"the eager call made {launches}")
        if _scratch_pointers(dev) != scratch:
            raise RuntimeError(f"dispatch {key}: the capture replaced the split scratch "
                               f"(its size {self.scratch} misses a plan)")
        return Dispatch(key, inputs, fn, launches, graph, outputs, scratch)

    def _entry(self, key: Key) -> Dispatch:
        entry = self._entries.get(key)
        if entry is None:
            raise KeyError(f"dispatch {key} was never prepared")
        return entry

    def load(self, key: Key, **inputs) -> None:
        """Copy ``inputs`` (numpy arrays, tensors, or dicts of them) into the
        key's static buffers of the same names."""
        entry = self._entry(key)
        for name, value in inputs.items():
            _copy_in(entry.inputs[name], value)

    def replay(self, key: Key) -> Any:
        """Run the key's call on its static buffers; returns its outputs."""
        entry = self._entry(key)
        if self.refresh is not None:
            self.refresh()
        counts = launch_counts()
        if entry.graph is None:
            out = entry.fn(entry.inputs)
        else:
            if entry.scratch is not None and _scratch_pointers(self.device) != entry.scratch:
                raise RuntimeError(f"dispatch {key}: the split scratch moved since its capture")
            entry.graph.replay()
            out = entry.outputs
        set_launch_counts({k: n + entry.launches[k] for k, n in counts.items()})
        self.replays += 1
        return out

    def run(self, key: Key, **inputs) -> Any:
        self.load(key, **inputs)
        return self.replay(key)
