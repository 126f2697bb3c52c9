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
(``serving.engine.prompt_tokens``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..serving.engine import prompt_tokens
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


def generate_waves(model, params, reqs: Sequence, *, n_slots: int, max_len: int,
                   prefill_len: int) -> WaveResult:
    """Serve ``reqs`` in order, ``n_slots`` at a time (see the module's
    docstring). Tokens stay on the device until a wave ends."""
    dev = model.device
    vocab = model.cfg.vocab_size
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    res = WaveResult(generated={})
    for w0 in range(0, len(reqs), n_slots):
        wave = reqs[w0 : w0 + n_slots]
        tokens = np.zeros((len(wave), prefill_len), np.int32)
        lengths = np.array([r.n_prefill for r in wave], np.int32)
        if lengths.max() > prefill_len:
            raise ValueError(f"a prompt of {lengths.max()} tokens exceeds prefill_len {prefill_len}")
        for i, r in enumerate(wave):
            tokens[i, : r.n_prefill] = prompt_tokens(r, vocab)
        sync()
        t0 = time.perf_counter()
        cache = model.cache_init(len(wave), max_len)
        logits, cache = model.prefill(params, torch.from_numpy(tokens).to(dev), cache,
                                      lengths=torch.from_numpy(lengths).to(dev))
        cur = greedy(logits)
        sync()
        t1 = time.perf_counter()
        out = [cur]
        for _ in range(max(r.n_decode for r in wave) - 1):
            logits, cache = model.decode_step(params, cur, cache)
            cur = greedy(logits)
            out.append(cur)
        block = torch.stack(out).cpu().numpy()           # (steps + 1, wave)
        t2 = time.perf_counter()
        res.prefills += 1
        res.decode_steps += len(out) - 1
        res.prefill_s += t1 - t0
        res.decode_s += t2 - t1
        for i, r in enumerate(wave):
            res.generated[r.rid] = block[: r.n_decode, i].tolist()
    return res
