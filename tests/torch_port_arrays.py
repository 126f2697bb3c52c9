"""Numpy helpers of the PyTorch port's tests (``test_torch_*.py``) that feed
the port and the reference identical inputs, the scripted clock the fleet
tests stand in for the engines' wall clock, and the serve / update / serve
drive of the parameter-views tests. They import no JAX, so the card's tests
use them on a machine without it."""
import dataclasses

import numpy as np
import torch


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32) if np.asarray(x).dtype.name == "bfloat16" else np.asarray(x)


def shuffled_tables(rng, n_rows, mb, n_pages, page_size, lengths):
    """Block tables over a shuffled pool: row i owns just enough pages for
    lengths[i] tokens (-1 past that)."""
    perm = rng.permutation(n_pages)
    tables = np.full((n_rows, mb), -1, np.int32)
    used = 0
    for i in range(n_rows):
        need = -(-int(lengths[i]) // page_size)
        assert used + need <= n_pages, "case under-provisions pages"
        tables[i, :need] = perm[used : used + need]
        used += need
    return tables


class ScriptedClock:
    """Stands in for an engine module's ``time``: every ``perf_counter``
    call advances 2**-10 s, so each stage lasts exactly that (over its
    replica's speed factor) and no decision reads the wall clock. A power of
    two keeps every clock reading exact, whatever the count of calls."""

    STEP = 2.0 ** -10

    def __init__(self):
        self.calls = 0

    def perf_counter(self):
        self.calls += 1
        return self.calls * self.STEP



def serve_update_serve(arch, device):
    """The bf16 smoke model of ``arch`` served through its captured
    dispatches (the Engine for a decoder, dense layout; ``WaveServer`` waves
    for the others), then one in-place ``adamw_update`` (lr 0.1, seeded
    gradients) of its parameters, then the same requests served again on
    the same dispatches. The Engine's cost model is pinned and its straggler
    mitigation off, so its schedule, and with it each stage's batch, does
    not follow the wall clock. Returns the tokens (before, after, a fresh
    model's on the updated tree)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import CostModel
    from repro_torch.data import WorkloadSpec, gsm8k_like_workload
    from repro_torch.launch.generate import WaveServer
    from repro_torch.launch.serve import build_scheduling
    from repro_torch.models.layers import tree_map
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.profiler import OnlineProfiler
    from repro_torch.train import optimizer as opt

    cfg = get_smoke_config(arch)
    spec = WorkloadSpec(n_requests=6, input_mean=12, input_std=4, input_max=20, output_mean=8,
                        output_std=3, output_mu0=8, output_sigma0=3, output_max=12)
    reqs = gsm8k_like_workload(spec, seed=1, known_lengths=True)
    if cfg.family == "audio":
        reqs = [dataclasses.replace(r, n_prefill=8) for r in reqs]

    def server(model, params):
        if cfg.family in TransformerLM.FAMILIES:
            ecfg = EngineConfig(n_slots=4, max_len=64, kv_layout="dense", prefill_seq_buckets=(32, 64),
                                straggler_factor=1e9)
            eng = Engine(model, params, ecfg, device=device,
                         profiler=OnlineProfiler(initial=CostModel(), refit_every=10**9))

            def serve():
                eng.serve(reqs, *build_scheduling("baseline", reqs, 4, CostModel()))
                return dict(eng.generated)
            return serve
        waves = WaveServer(model, params, n_slots=3, max_len=64, prefill_len=24, enc_len=8)
        return lambda: waves.serve(reqs).generated

    model = get_model(cfg, device=device)
    params = model.init_params(0)
    serve = server(model, params)
    before = serve()
    rng = np.random.default_rng(4)
    grads = tree_map(lambda t: torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
                     .to(t.device, t.dtype), params)
    opt.adamw_update(grads, opt.adamw_init(params), params, opt.AdamWConfig(lr=1e-1, warmup_steps=1))
    after = serve()
    fresh = server(get_model(cfg, device=device), params)()
    return before, after, fresh
