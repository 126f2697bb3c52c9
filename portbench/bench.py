"""The harness: builds one cell of ``BENCHMARK.json`` on the device, drives
its window, reads its metrics and decides ``correct``.

What belongs to one configuration, traffic mix, cell or metric is a file of
its own, found by name: ``configs/<config>.json`` (sizes, weight tree,
reference), ``traffic/<mix>.json`` (read by ``generate``), ``cells/<cell>.json``
(the engine's settings, the profiled sub-window, the check's sample and
limit) and ``metrics/<metric>.py`` (a ``read(run)`` returning a
number, or None where it finds nothing to read).

The window: the device is synchronised, then for ``seconds`` the harness
calls the program's ``Engine.serve_step``, moving the engine's clock to the
wall clock (``advance_clock``) before every step, so that host time between
stages counts, and stamping each token with the wall clock when it reaches
the host. A cell serves backlog rounds back to back, each planned offline
(``solve_offline``) when it falls due. After the window the open round is
abandoned; the finished rounds' traces are validated, and the reference
judges a sample of what was served.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Set

import numpy as np
import torch

from . import generate, yardstick
from .devtrace import SubWindow, Trace
from .weights import leaves, make_weights

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
K1 = re.compile(r"paged_decode_kernel")


# --------------------------------------------------------------------------- #
# Specification                                                               #
# --------------------------------------------------------------------------- #
def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    entry: Dict                         # the workloads entry of BENCHMARK.json
    config: Dict                        # configs/<config>.json
    mix: Dict                           # traffic/<mix>.json
    spec: Dict                          # cells/<cell>.json
    end_to_end: List[Dict]              # the metrics this cell reports
    per_layer: List[Dict]

    @property
    def arch(self) -> Dict:
        return self.config["arch"]

    @property
    def engine(self) -> Dict:
        return self.spec["engine"]


def reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[Dict] = None, root: Path = ROOT) -> Cell:
    bench = bench or load_json(root.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return Cell(
        name=name, entry=entry,
        config=load_json(root / "configs" / f"{entry['config']}.json"),
        mix=load_json(root / "traffic" / f"{entry['traffic']}.json"),
        spec=load_json(root / "cells" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
    )


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    path = root / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


# --------------------------------------------------------------------------- #
# The system under test                                                       #
# --------------------------------------------------------------------------- #
def engine_config(spec: Dict):
    from repro_torch.serving.engine import EngineConfig

    tuples = ("prefill_req_buckets", "mixed_token_buckets", "prefill_seq_buckets")
    return EngineConfig(**{k: tuple(v) if k in tuples else v for k, v in spec.items()})


def check_tree(model, weights: Dict) -> None:
    """The benchmark's weight tree must be the program's parameter tree."""
    def defs(tree, prefix=""):
        for k in sorted(tree):
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(tree[k], dict):
                yield from defs(tree[k], path)
            else:
                yield path, tree[k]
    want = {p: (tuple(d.shape), d.dtype) for p, d in defs(model.param_defs())}
    have = {p: (tuple(x.shape), x.dtype) for p, x in leaves(weights)}
    if want != have:
        raise ValueError(f"weight tree differs from the program's: missing "
                         f"{sorted(set(want) - set(have))}, extra {sorted(set(have) - set(want))}, "
                         f"shapes {[p for p in want if p in have and want[p] != have[p]]}")


def build(cell: Cell, seed: int, device) -> Dict[str, Any]:
    """Weights from the seed, the program's model over them, its engine with
    every dispatch of this cell's settings warmed (captured on the card)."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.engine import Engine

    weights = make_weights(cell.config["tree"], cell.arch, seed, device)
    model = TransformerLM(ArchConfig(**cell.arch), device=device)
    check_tree(model, weights)
    eng = Engine(model, weights, engine_config(cell.engine), device=device)
    eng.warm_serving_shapes()
    return dict(weights=weights, model=model, engine=eng)


# --------------------------------------------------------------------------- #
# The window                                                                  #
# --------------------------------------------------------------------------- #
@dataclass
class Req:
    rid: int
    n_prefill: int
    n_decode: int
    due: float
    stamps: List[float] = field(default_factory=list)


@dataclass
class Stage:
    kind: str
    t_start: float
    t_end: float
    busy: Dict[int, int]
    busy_partial: Dict[int, int]
    prefilled: Dict[int, int]
    tokens: int
    chunk_tokens: int
    rounds: int


@dataclass
class Step:
    stage: Stage
    new_tokens: Dict[int, int]
    finished: Set[int]
    session: int


@dataclass
class Records:
    end: float
    reqs: Dict[int, Req] = field(default_factory=dict)
    steps: List[Step] = field(default_factory=list)
    served: Dict[int, List[int]] = field(default_factory=dict)
    traces: List[Any] = field(default_factory=list)
    cut: bool = False                 # True: the open round was abandoned at the end
    trace: Optional[Trace] = None
    # host seconds in each of the harness's phases inside the window
    phases: Dict[str, float] = field(default_factory=dict)

    def add(self, phase: str, t0: float, t1: float) -> None:
        if t0 < self.end:
            self.phases[phase] = self.phases.get(phase, 0.0) + min(t1, self.end) - t0

    @property
    def stages(self) -> List[Stage]:
        return [s.stage for s in self.steps]


def _stage(s) -> Stage:
    return Stage(kind=s.kind.value, t_start=s.t_start, t_end=s.t_end, busy=dict(s.busy),
                 busy_partial=dict(s.busy_partial), prefilled=dict(s.prefilled),
                 tokens=s.tokens, chunk_tokens=s.chunk_tokens, rounds=s.rounds)


def _session(eng, reqs, n_slots: int):
    """The paper's hybrid configuration: offline bin packing, Algorithm 1's
    sorted backlogs with stealing, the Lagrangian policy."""
    from repro_torch.core import (LagrangianPolicy, SortingPreemptiveScheduler, build_clients,
                                  solve_offline)

    asn = solve_offline(reqs, n_slots, eng.profiler.cost_model).assignment
    clients = build_clients(n_slots, reqs, asn)
    return clients, SortingPreemptiveScheduler(clients), LagrangianPolicy()


def drive(eng, cell: Cell, seed: int, seconds: float, sync: Callable,
          sub: Optional[SubWindow] = None) -> Records:
    """Serve the cell's backlog rounds for ``seconds`` of wall time, each due
    when the last one ends; the round open at the end is abandoned. Returns
    the window's records (times from its start)."""
    from repro_torch.core.types import Request
    from torch.profiler import record_function

    n_slots = cell.engine["n_slots"]
    rec = Records(end=float(seconds))
    sync()
    start = time.perf_counter()
    clock = lambda: time.perf_counter() - start
    rnd = 0
    while True:
        due = clock()
        with record_function("portbench.plan"):
            reqs = [Request(rid=r["rid"], n_prefill=r["n_prefill"], n_decode=r["n_decode"],
                            n_decode_est=r["n_decode_est"], arrival=r["arrival"])
                    for r in generate.requests(cell.mix, seed, rnd)]
            for r in reqs:
                rec.reqs[r.rid] = Req(r.rid, r.n_prefill, r.n_decode, due + r.arrival)
            clients, sched, pol = _session(eng, reqs, n_slots)
            eng.begin_serve(reqs, clients, sched, pol, policy_name="hybrid")
        rec.add("plan", due, clock())
        session = len(rec.traces)
        while True:
            t = clock()
            if sub is not None:
                if t < seconds:
                    sub.tick(t, len(rec.steps))
                else:
                    sub.close(len(rec.steps))
            eng.advance_clock(t)
            n_before = _n_stages(eng)
            t0 = clock()
            with record_function("portbench.serve_step"):
                status = eng.serve_step()
            t = clock()
            rec.add("serve_step", t0, t)
            with record_function("portbench.stamp"):
                if _n_stages(eng) > n_before:
                    rec.steps.append(_stamp(eng, rec, t, session))
            rec.add("stamp", t, clock())
            if status == "done":
                break
            if status == "idle":
                raise RuntimeError("engine idle with work pending")
            if t >= seconds:
                rec.cut = True
                break
        if sub is not None:
            sub.close(len(rec.steps))
        for rid, toks in eng.generated.items():
            rec.served[rid] = list(toks)
        if rec.cut:
            break
        rec.traces.append(eng.finish_serve(validate=False))
        rnd += 1
        if clock() >= seconds:
            break
    rec.trace = sub.finish() if sub is not None else None
    return rec


def _n_stages(eng) -> int:
    return len(eng._sv.trace.stages)


def _stamp(eng, rec: Records, t: float, session: int) -> Step:
    """Record the stage a step ran and stamp each token it sent to the host."""
    stage = _stage(eng._sv.trace.stages[-1])
    new: Dict[int, int] = {}
    finished: Set[int] = set()
    for rid in stage.busy.values():
        r = rec.reqs[rid]
        n = len(eng.generated.get(rid, ())) - len(r.stamps)
        if n > 0:
            r.stamps.extend([t] * n)
            new[rid] = n
            if len(r.stamps) >= r.n_decode:
                finished.add(rid)
    return Step(stage, new, finished, session)


# --------------------------------------------------------------------------- #
# Correctness                                                                 #
# --------------------------------------------------------------------------- #
def load_reference(cell: Cell, root: Path = ROOT):
    path = root / cell.config["reference"]
    spec = importlib.util.spec_from_file_location("portbench_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scored(n: int, cap: int) -> np.ndarray:
    """Which of a request's ``n`` served tokens the check scores: all of
    them, or ``cap`` spread evenly from the first to the last."""
    if n <= cap:
        return np.arange(n)
    return np.round(np.linspace(0, n - 1, cap)).astype(np.int64)


def sample(rec: Records, seed: int, served_tokens: int, max_requests: int,
           per_request: int) -> List[Req]:
    """Finished requests drawn from the seed, the longest first, until they
    add ``served_tokens`` scored tokens (at most ``per_request`` each, so
    that the sample spreads over many slots) or ``max_requests``."""
    done = [r for r in rec.reqs.values() if len(rec.served.get(r.rid, ())) >= r.n_decode]
    if not done:
        return []
    longest = max(done, key=lambda r: (r.n_decode, r.n_prefill, -r.rid))
    rest = [r for r in done if r.rid != longest.rid]
    order = np.random.default_rng([seed, 7]).permutation(len(rest))
    picked, tokens = [longest], min(longest.n_decode, per_request)
    for i in order:
        if tokens >= served_tokens or len(picked) >= max_requests:
            break
        picked.append(rest[i])
        tokens += min(rest[i].n_decode, per_request)
    return picked


def sequences(cell: Cell, rec: Records, reqs: List[Req], per_request: int, device):
    """(tokens, prompt length, scored positions) of each request, and the
    served tokens at those positions: the prompt the benchmark derives from
    the request id, then every served token but the last; the logits at
    position ``n_prefill - 1 + i`` chose served token ``i``."""
    vocab = cell.arch["vocab_size"]
    out, served = [], []
    for r in reqs:
        toks = rec.served[r.rid]
        prompt = generate.prompt_tokens(r.rid, r.n_prefill, vocab)
        seq = np.concatenate([prompt, np.asarray(toks[:-1], np.int64)])
        idx = scored(len(toks), per_request)
        out.append((torch.from_numpy(seq).to(device), r.n_prefill,
                    torch.from_numpy(r.n_prefill - 1 + idx).to(device)))
        served.append(torch.tensor(toks, dtype=torch.long, device=device)[torch.from_numpy(idx).to(device)])
    return out, served


def gaps_of(logits: List[torch.Tensor], chosen: List[torch.Tensor]) -> torch.Tensor:
    """How far each chosen token's reference logit lies below the best."""
    return torch.cat([lg.max(-1).values - lg.gather(-1, c[:, None])[:, 0]
                      for lg, c in zip(logits, chosen)])


def readings(gaps: torch.Tensor) -> Dict[str, float]:
    """The numbers a check can compare: the widest gap, the mean gap, and
    the share of served tokens that are not the reference's best."""
    return {"logit_gap_max": float(gaps.max()), "logit_gap_mean": float(gaps.mean()),
            "mismatch_share": float((gaps > 0).float().mean())}


def judge(cell: Cell, rec: Records, weights: Dict, seed: int, device,
          control: bool = False) -> Dict[str, Any]:
    """The numbers compared, each with its limit: tokens a finished request
    got against its ``n_decode``, the traces' invariants, and the readings
    of the served tokens against the reference (``readings``) that the
    cell's ``check.limits`` gives a limit. With ``control`` the fp8 control
    is read on the same sequences (its own best token at each position) and
    held to the same limits, put in the program's place
    (``control_checks``, ``control_correct``)."""
    checks: Dict[str, Dict[str, float]] = {}
    # every request of a finished round got exactly n_decode tokens, each of
    # which the harness saw reach the host
    finished = {r.rid for tr in rec.traces for r in tr.requests}
    wrong = sum(1 for rid in finished
                if len(rec.served.get(rid, ())) != rec.reqs[rid].n_decode
                or len(rec.reqs[rid].stamps) != rec.reqs[rid].n_decode)
    # and no request of the abandoned round got more than its n_decode
    wrong += sum(1 for r in rec.reqs.values()
                 if r.rid not in finished and len(rec.served.get(r.rid, ())) > r.n_decode)
    checks["wrong_token_counts"] = {"value": wrong, "limit": 0}
    invalid = 0
    for tr in rec.traces:
        try:
            tr.validate()
        except AssertionError as exc:
            invalid += 1
            print(f"trace invalid: {exc}", file=sys.stderr)
    checks["invalid_traces"] = {"value": invalid, "limit": 0}
    spec = cell.spec["check"]
    cap = spec["tokens_per_request"]
    picked = sample(rec, seed, spec["served_tokens"], spec["max_requests"], cap)
    out: Dict[str, Any] = {"checks": checks, "sampled": len(picked), "readings": {}}
    limits = spec["limits"]
    if picked:
        ref = load_reference(cell)
        seqs, served = sequences(cell, rec, picked, cap, device)
        chunk = cell.engine["prefill_chunk"]
        logits = ref.served_logits(weights, cell.arch, seqs, chunk)
        gaps = gaps_of(logits, served)
        out["served_checked"] = int(gaps.numel())
        out["readings"] = readings(gaps)
        if control:
            low = ref.served_logits(weights, cell.arch, seqs, chunk, precision="fp8")
            out["control"] = readings(gaps_of(logits, [lg.argmax(-1) for lg in low]))

    def held(read: Dict[str, float]) -> Dict[str, Dict[str, float]]:
        return {name: {"value": read.get(name, float("inf")), "limit": limit}
                for name, limit in limits.items()}

    checks.update(held(out["readings"]))
    within = lambda cs: bool(picked and limits and all(c["value"] <= c["limit"] for c in cs.values()))  # noqa: E731
    out["correct"] = within(checks)
    if control:
        out["control_checks"] = held(out.get("control", {}))
        out["control_correct"] = within(out["control_checks"])
    return out


# --------------------------------------------------------------------------- #
# A run                                                                       #
# --------------------------------------------------------------------------- #
@dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    rec: Records
    setup_s: float
    flops: Dict[str, float]

    @property
    def end(self) -> float:
        return self.rec.end

    @property
    def reqs(self) -> List[Req]:
        return list(self.rec.reqs.values())

    def kernel_bounds(self) -> float:
        """Σ bound ms of kernel 1's calls in the traced steps."""
        tr = self.rec.trace
        n_prefill = {r.rid: r.n_prefill for r in self.rec.reqs.values()}
        k1 = 0.0
        sessions = sorted({s.session for s in self.rec.steps[tr.first_step:tr.last_step]})
        for sess in sessions:
            idx = [i for i, s in enumerate(self.rec.steps) if s.session == sess]
            steps = [self.rec.steps[i] for i in idx]
            before = [s for i, s in zip(idx, steps) if i < tr.first_step]
            upto = [s for i, s in zip(idx, steps) if i < tr.last_step]
            a = yardstick.kernel_calls(before, n_prefill, self.cell.engine, self.cell.arch)
            b = yardstick.kernel_calls(upto, n_prefill, self.cell.engine, self.cell.arch)
            k1 += sum(b) - sum(a)
        return k1


def window_summary(rec: Records) -> Dict[str, Any]:
    """Where the window's wall time went: the harness's phases, the program's
    stage time by kind (stages ending in the window), and the steps run."""
    kinds: Dict[str, List[float]] = {}
    for s in rec.stages:
        if s.t_end <= rec.end:
            k = kinds.setdefault(s.kind, [0, 0.0, 0, 0])
            k[0] += 1
            k[1] += s.t_end - s.t_start
            k[2] += s.rounds
            k[3] += s.tokens
    return {"end": rec.end, "steps": len(rec.steps), "sessions": len(rec.traces),
            "phases_s": rec.phases,
            "stages": {k: dict(n=v[0], s=v[1], rounds=v[2], tokens=v[3]) for k, v in kinds.items()}}


def forbidden_modules() -> List[str]:
    """Top-level names of JAX, its companions and the JAX package loaded in
    this process, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, t_process: float,
             device="cuda", require_chip: bool = True) -> Optional[Dict[str, Any]]:
    """One run of a cell. Returns the result line's object, or None (after
    saying why on stderr) where the run may print no result."""
    dev = torch.device(device)
    if require_chip:
        want = int(cell.entry["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < want:
            print(f"needs {want} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return None
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    built = build(cell, seed, dev)
    eng = built["engine"]
    sync()
    setup_s = time.perf_counter() - t_process
    prof = cell.spec["profile"]
    sub = SubWindow(prof["start_s"], prof["seconds"], sync) if traced else None
    if sub is not None:
        sub.warm()
    rec = drive(eng, cell, seed, seconds, sync, sub)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    numel = {p: x.numel() for p, x in leaves(built["weights"])}
    run = Run(cell=cell, rec=rec, setup_s=setup_s, flops=yardstick.flop_counts(cell.arch, numel))
    metrics: Dict[str, Dict[str, Any]] = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # free the program's state before the reference runs
    weights = built["weights"]
    del built, eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    verdict = judge(cell, rec, weights, seed, dev)
    attempted = sum(1 for r in rec.reqs.values() if r.due <= rec.end)
    # a request fails when its round was served to the end without it
    # finishing; the round abandoned at the window's end fails none
    failed = sum(1 for r in rec.reqs.values() if r.due <= rec.end and not rec.cut
                 and len(rec.served.get(r.rid, ())) < r.n_decode)
    device_info: Dict[str, Any] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak),
    }
    out: Dict[str, Any] = {"correct": verdict["correct"], "attempted": attempted, "failed": failed,
                           "metrics": metrics, "device": device_info}
    if traced and rec.trace is not None:
        device_info["busy_s"] = rec.trace.busy_s
        device_info["window_s"] = rec.trace.window_s
        top = sorted(rec.trace.kernels.items(), key=lambda kv: -kv[1][1])[:10]
        out["breakdown"] = {"device_ops": [[n[:120], s] for n, (_, s) in top],
                            "idle_gaps": [[n[:120], s] for n, s in rec.trace.gaps[:10]]}
    if cuda:
        print(f"card: {power_limit()}", file=sys.stderr)
    print(f"window: {json.dumps(window_summary(rec))}", file=sys.stderr)
    print(f"checked {verdict.get('served_checked', 0)} served tokens of {verdict['sampled']} requests: "
          f"{json.dumps(verdict['readings'])}", file=sys.stderr)
    for name, c in verdict["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    out["checks"] = verdict["checks"]
    return out
