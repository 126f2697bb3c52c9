"""Serve requests through a model's own ``prefill`` and ``decode_step``, in
waves of slots.

The port's ``Engine`` serves the dense decoders. RecurrentGemma, xLSTM and
Whisper have ``prefill`` and ``decode_step`` but no fused ``decode_steps``,
and the reference's JAX ``Engine`` cannot run them either (it calls
``decode_steps``), so their requests are served here as the reference's
tests drive the models (``tests/test_models.py``): in waves of up to
``n_slots`` requests, each wave one prefill of its prompts into a fresh
cache of ``max_len`` tokens a slot, then greedy ``decode_step``s until every
request of the wave has its budget of ``n_decode`` tokens (the first from
the prefill). A slot whose request is done decodes on with the others and
its tokens are dropped. Prompts are the engine's
(``serving.engine.prompt_tokens``).

* RecurrentGemma and xLSTM take ragged prompts, right-padded to
  ``prefill_len``, with their lengths.
* Whisper's ``prefill`` takes no lengths, so a wave's prompts must have
  one length (the wave runs them unpadded), and each request brings its
  frame embeddings: ``enc_len`` frames drawn from the request's id
  (``request_frames``), the stub input of the reference's audio front end.

A wave's inputs (prompts, lengths, frames) are drawn on the host and moved
to the device before its clock starts (``wave_inputs``): ``prefill_s``
times the model's prefill, not the drawing of its inputs.

The decode steps replay a CUDA graph of the wave size on the card and run
the same function eagerly on the CPU (``WaveServer``).
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


def request_frames(rid: int, enc_len: int, d_model: int) -> np.ndarray:
    """The frame embeddings (enc_len, d_model) float32 of request ``rid``,
    drawn from numpy's generator seeded with ``rid``: a request brings the
    same frames whatever its wave."""
    return np.random.default_rng(rid).standard_normal((enc_len, d_model)).astype(np.float32)


class WaveServer:
    """Serves requests in waves of up to ``n_slots`` (see the module's
    docstring). Each wave's decode steps replay one captured dispatch of its
    wave size (``serving.graphs``): ``decode_step``, the greedy pick and the
    pick fed back as the next step's token, over the dispatch's static wave
    cache. A wave prepares its dispatch and its inputs before its clock
    starts, then resets that cache and prefills into it eagerly. Keep one
    server to serve many request sets on the same dispatches. ``enc_len``
    (an encoder-decoder model's frames a request, default 1500) is read for
    Whisper only."""

    def __init__(self, model, params, *, n_slots: int, max_len: int, prefill_len: int,
                 enc_len: int = 1500):
        self.model, self.params = model, params
        self.n_slots, self.max_len, self.prefill_len = n_slots, max_len, prefill_len
        self.audio = model.cfg.family == "audio"
        self.enc = {"enc_len": enc_len} if self.audio else {}
        dev = model.device
        scratch = (0, 0)
        if dev.type == "cuda":
            # the largest split plan of any wave size and any cache the
            # decode kernel reads, sized before a capture
            n_sms = sm_count(dev)
            needs = [decode_scratch({"k": torch.empty(shape, dtype=model.dtype, device="meta")},
                                    model.cfg.n_heads, n_sms)
                     for b in range(1, n_slots + 1)
                     for shape in model.decode_attention_caches(b, max_len, **self.enc)]
            if needs:
                scratch = (max(f for f, _ in needs), max(c for _, c in needs))
        self.graphs = Dispatches(dev, self._build, scratch=scratch,
                                 refresh=lambda: model.refresh_views(params))

    def _cache(self, b: int):
        return self.model.cache_init(b, self.max_len, **self.enc)

    def wave_inputs(self, wave: Sequence) -> Dict[str, torch.Tensor]:
        """One wave's keyword arguments of the model's ``prefill`` besides
        its parameters and cache, on the device: the prompts right-padded to
        ``prefill_len`` and their ``lengths``; for Whisper the prompts
        unpadded and each request's frames as ``patch_embeds``."""
        model, dev = self.model, self.model.device
        tokens = np.zeros((len(wave), self.prefill_len), np.int32)
        lengths = np.array([r.n_prefill for r in wave], np.int32)
        if lengths.max() > self.prefill_len:
            raise ValueError(f"a prompt of {lengths.max()} tokens exceeds prefill_len {self.prefill_len}")
        for i, r in enumerate(wave):
            tokens[i, : r.n_prefill] = prompt_tokens(r, model.cfg.vocab_size)
        if not self.audio:
            return dict(tokens=torch.from_numpy(tokens).to(dev),
                        lengths=torch.from_numpy(lengths).to(dev))
        if (lengths != lengths[0]).any():
            raise ValueError(f"{model.cfg.name}: a wave's prompts must have one length "
                             f"(its prefill takes no lengths), got {sorted(set(lengths.tolist()))}")
        frames = np.stack([request_frames(r.rid, self.enc["enc_len"], model.cfg.d_model)
                           for r in wave])
        return dict(tokens=torch.from_numpy(tokens[:, : lengths[0]]).to(dev),
                    patch_embeds=torch.from_numpy(frames).to(dev, model.dtype))

    def _build(self, key: Key):
        (b,) = key.shape
        model, params = self.model, self.params
        inputs = dict(tokens=torch.zeros(b, dtype=torch.int32, device=model.device),
                      cache=self._cache(b))

        def fn(x):
            logits, _ = model.decode_step(params, x["tokens"], x["cache"])
            x["tokens"].copy_(greedy(logits))
            return x["tokens"]

        return inputs, fn

    def serve(self, reqs: Sequence) -> WaveResult:
        dev = self.model.device
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
        res = WaveResult(generated={})
        for w0 in range(0, len(reqs), self.n_slots):
            wave = reqs[w0 : w0 + self.n_slots]
            key = Key("wave", (len(wave),), False)
            cache = self.graphs.prepare(key).inputs["cache"]
            steps = max(r.n_decode for r in wave) - 1
            inputs = self.wave_inputs(wave)
            sync()
            t0 = time.perf_counter()
            self.graphs.load(key, cache=self._cache(len(wave)))
            logits, _ = self.model.prefill(self.params, cache=cache, **inputs)
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
                   prefill_len: int, enc_len: int = 1500) -> WaveResult:
    """Serve ``reqs`` in order, ``n_slots`` at a time, on a new
    ``WaveServer``. Tokens stay on the device until a wave ends."""
    return WaveServer(model, params, n_slots=n_slots, max_len=max_len,
                      prefill_len=prefill_len, enc_len=enc_len).serve(reqs)
