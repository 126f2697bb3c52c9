"""Serve requests through a model's own ``prefill`` and ``decode_step``, in
waves of slots.

The port's ``Engine`` serves the dense decoders. RecurrentGemma has
``prefill`` and ``decode_step`` but no fused ``decode_steps``, and the
reference's JAX ``Engine`` cannot run it either (it calls ``decode_steps``),
so its requests are served here as the reference's tests drive the model
(``tests/test_models.py``): in waves of up to ``n_slots`` requests, each
wave one ragged prefill of its prompts (right-padded to ``prefill_len``)
into a fresh cache of ``max_len`` tokens a slot, then greedy ``decode_step``s
until every request of the wave has its budget of ``n_decode`` tokens (the
first from the prefill). A slot whose request is done decodes on with the
others and its tokens are dropped. Prompts are the engine's
(``serving.engine.prompt_tokens``). The decode steps replay a CUDA graph
of the wave size on the card and run the same function eagerly on the CPU
(``WaveServer``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..serving.engine import prompt_tokens
from ..serving.graphs import Dispatches, Key, decode_scratch, sm_count
from ..serving.sampler import greedy


@dataclasses.dataclass
class WaveResult:
    generated: Dict[int, List[int]]      # rid → its n_decode tokens
    prefills: int = 0
    decode_steps: int = 0
    prefill_s: float = 0.0               # wall time, each stage ending in a device sync
    decode_s: float = 0.0

    @property
    def tokens(self) -> int:
        return sum(len(v) for v in self.generated.values())


class WaveServer:
    """Serves requests in waves of up to ``n_slots`` (see the module's
    docstring). Each wave's decode steps replay one captured dispatch of its
    wave size (``serving.graphs``): ``decode_step``, the greedy pick and the
    pick fed back as the next step's token, over the dispatch's static wave
    cache. A wave prepares its dispatch before its clock starts, then resets
    that cache and prefills into it eagerly. Keep one server to serve many
    request sets on the same dispatches."""

    def __init__(self, model, params, *, n_slots: int, max_len: int, prefill_len: int):
        self.model, self.params = model, params
        self.n_slots, self.max_len, self.prefill_len = n_slots, max_len, prefill_len
        dev = model.device
        scratch = (0, 0)
        if dev.type == "cuda":
            # the largest split plan of any wave size, sized before a capture
            n_sms = sm_count(dev)
            needs = [decode_scratch(self._ring_meta(b), model.cfg.n_heads, n_sms)
                     for b in range(1, n_slots + 1)]
            scratch = (max(f for f, _ in needs), max(c for _, c in needs))
        self.graphs = Dispatches(dev, self._build, scratch=scratch)

    def _ring_meta(self, b: int) -> Dict[str, torch.Tensor]:
        shape = self.model.cache_shape(b, self.max_len)["attn"]["k"]
        return {"k": torch.empty(shape, dtype=self.model.dtype, device="meta")}

    def _build(self, key: Key):
        (b,) = key.shape
        model, params = self.model, self.params
        inputs = dict(tokens=torch.zeros(b, dtype=torch.int32, device=model.device),
                      cache=model.cache_init(b, self.max_len))

        def fn(x):
            logits, _ = model.decode_step(params, x["tokens"], x["cache"])
            x["tokens"].copy_(greedy(logits))
            return x["tokens"]

        return inputs, fn

    def serve(self, reqs: Sequence) -> WaveResult:
        model, params, dev = self.model, self.params, self.model.device
        vocab, prefill_len = model.cfg.vocab_size, self.prefill_len
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
        res = WaveResult(generated={})
        for w0 in range(0, len(reqs), self.n_slots):
            wave = reqs[w0 : w0 + self.n_slots]
            tokens = np.zeros((len(wave), prefill_len), np.int32)
            lengths = np.array([r.n_prefill for r in wave], np.int32)
            if lengths.max() > prefill_len:
                raise ValueError(f"a prompt of {lengths.max()} tokens exceeds prefill_len {prefill_len}")
            for i, r in enumerate(wave):
                tokens[i, : r.n_prefill] = prompt_tokens(r, vocab)
            key = Key("wave", (len(wave),), False)
            cache = self.graphs.prepare(key).inputs["cache"]
            steps = max(r.n_decode for r in wave) - 1
            sync()
            t0 = time.perf_counter()
            self.graphs.load(key, cache=model.cache_init(len(wave), self.max_len))
            logits, _ = model.prefill(params, torch.from_numpy(tokens).to(dev), cache,
                                      lengths=torch.from_numpy(lengths).to(dev))
            first = greedy(logits)
            self.graphs.load(key, tokens=first)
            sync()
            t1 = time.perf_counter()
            block = torch.empty((steps + 1, len(wave)), dtype=torch.int32, device=dev)
            block[0].copy_(first)
            for i in range(steps):
                block[i + 1].copy_(self.graphs.replay(key))
            host = block.cpu().numpy()                   # (steps + 1, wave)
            t2 = time.perf_counter()
            res.prefills += 1
            res.decode_steps += steps
            res.prefill_s += t1 - t0
            res.decode_s += t2 - t1
            for i, r in enumerate(wave):
                res.generated[r.rid] = host[: r.n_decode, i].tolist()
        return res


def generate_waves(model, params, reqs: Sequence, *, n_slots: int, max_len: int,
                   prefill_len: int) -> WaveResult:
    """Serve ``reqs`` in order, ``n_slots`` at a time, on a new
    ``WaveServer``. Tokens stay on the device until a wave ends."""
    return WaveServer(model, params, n_slots=n_slots, max_len=max_len,
                      prefill_len=prefill_len).serve(reqs)
