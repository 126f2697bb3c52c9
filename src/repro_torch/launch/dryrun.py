"""Dry-run of every (arch x shape x mesh) cell on a fake world of H100s
(counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell for 512 placeholder TPU devices).

Each cell's step — the train step (``make_train_step`` with the plan's
microbatches and remat), or ``prefill`` / ``decode_step`` — runs once on
fake tensors, as DTensors placed by the sharding rules
(``build_param_specs``, ``build_cache_specs``, ``input_specs_for``) on a
16 x 16 or 2 x 16 x 16 mesh over a world of 256 or 512 fake ranks
(``mesh.fake_world``), under ``trace_analysis``: rank 0's program is one
device's, so its counts are per device. Nothing is allocated and no card is
needed. The kernels are custom ops whose fake implementations allocate what
their launches allocate, so the memory verdict is the card's, not their
plain versions'.

For each cell it records, in the reference's schema:

    memory      argument / output / temp / alias bytes a device
                (temp = peak - arguments; outputs that are arguments
                updated in place alias them)
    cost        FLOPs and transcendentals a device
    collectives bytes and count by kind; collective_bytes_total

plus ``peak_bytes``, ``trace_s`` and ``op_calls`` (the kernels' custom-op
calls), to ``experiments/dryrun_torch/<arch>__<cell>__<mesh>.json``, which
``repro_torch.launch.roofline`` reads. xLSTM's train_4k and prefill_32k,
whose token loops would unroll into millions of operations, are traced at
one and two time chunks and extrapolated (``BOUNDED``).

Usage (the CPU is enough):
    python -m repro_torch.launch.dryrun --arch qwen3_8b --shape decode_32k
    python -m repro_torch.launch.dryrun --arch qwen3_8b --shape decode_32k --multi-pod
    python -m repro_torch.launch.dryrun --all            # every applicable cell
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs import ARCH_IDS, SHAPES_BY_NAME, cell_applicable, get_config
from ..configs.shapes import SHAPES, ShapeCell
from ..distributed.sharding import (
    ShardingConfig,
    build_cache_specs,
    build_param_specs,
    input_specs_for,
    local_slices,
    placements,
)
from ..distributed.spmd import contiguous_strides
from ..models.layers import abstract_params, logical_specs, tree_map
from ..models.registry import get_model
from ..train.optimizer import AdamWConfig, abstract_opt_state
from ..train.train_step import make_train_step
from .mesh import fake_world, make_production_mesh
from .plan import WHISPER_CROSS_LEN, WHISPER_DECODER_PROMPT, plan_for
from .trace_analysis import analysing, extrapolate, local_tensors

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

#: cells whose time loop would unroll into millions of DTensor operations
#: (xLSTM's token step, a few hundred a token): traced at one and at two time
#: chunks of TIME_CHUNK tokens, every count extrapolated to the cell's length
#: (``trace_analysis.extrapolate``, the port's form of the reference's loop
#: trip counts; its counts are affine in the length)
BOUNDED = {("xlstm_350m", "train_4k"), ("xlstm_350m", "prefill_32k")}
TIME_CHUNK = 64


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


# --------------------------------------------------------------------------- #
# Fake arguments                                                              #
# --------------------------------------------------------------------------- #
class FakeArgs:
    """Makes a cell's arguments: fake tensors of a ``FakeTensorMode``, each
    a DTensor's rank-0 shard on ``mesh`` under its spec (a plain fake tensor
    of the whole shape where ``mesh`` is None: a world of one)."""

    def __init__(self, mesh, device: str = "cpu"):
        from torch._subclasses.fake_tensor import FakeTensorMode

        self.mesh = mesh
        self.device = torch.device(device)
        self.mode = FakeTensorMode()

    def tensor(self, shape, dtype: torch.dtype, spec=()):
        shape = tuple(shape)
        if self.mesh is None:
            with self.mode:
                return torch.empty(shape, dtype=dtype, device=self.device)
        from torch.distributed.tensor import DTensor

        coord = [0] * self.mesh.ndim
        local = tuple(len(range(*s.indices(n)))
                      for s, n in zip(local_slices(shape, spec, self.mesh, coord), shape))
        with self.mode:
            t = torch.empty(local, dtype=dtype, device=self.device)
        return DTensor.from_local(t, self.mesh, placements(spec, self.mesh), run_check=False,
                                  shape=torch.Size(shape), stride=contiguous_strides(shape))

    def tree(self, like, specs):
        """A fake tree shaped like ``like`` (tensors: their shapes and
        dtypes) under the matching tree of ``specs``."""
        if isinstance(like, dict):
            return {k: self.tree(v, specs[k] if specs is not None else None) for k, v in like.items()}
        return self.tensor(like.shape, like.dtype, specs if specs is not None else ())


def _spec_tree(mesh, fn):
    return None if mesh is None else fn()


# --------------------------------------------------------------------------- #
# Cell construction                                                           #
# --------------------------------------------------------------------------- #
def build_cell(arch: str, cell: ShapeCell, mesh, plan: dict, *, cfg=None,
               device: str = "cpu") -> Tuple[Callable[[], Any], Any, FakeArgs]:
    """Returns ``(step, args, fake)``: ``step()`` runs the cell's step on
    ``args`` (a tuple of fake trees) once; ``fake.mode`` is their
    ``FakeTensorMode``. ``mesh`` None traces one card (plain fake tensors,
    on ``device``)."""
    cfg = cfg or get_config(arch)
    scfg: ShardingConfig = plan["sharding"]
    fake = FakeArgs(mesh, device)
    with fake.mode:
        model = get_model(cfg, device=fake.device)
    defs = model.param_defs()
    aparams = abstract_params(defs)
    laxes = logical_specs(defs)
    pspecs = _spec_tree(mesh, lambda: build_param_specs(aparams, laxes, mesh, scfg))
    params = fake.tree(aparams, pspecs)
    b, s = cell.global_batch, cell.seq_len
    in_like, in_specs = input_specs_for(cfg, cell, _ONE_CARD if mesh is None else mesh, scfg)
    inputs = {k: fake.tensor(v.shape, v.dtype, in_specs[k] if mesh is not None else ())
              for k, v in in_like.items()}

    if cell.kind == "train":
        opt_abs = abstract_opt_state(aparams)
        opt_specs = _spec_tree(mesh, lambda: {
            "m": build_param_specs(opt_abs["m"], laxes, mesh, scfg),
            "v": build_param_specs(opt_abs["v"], laxes, mesh, scfg),
            "count": (),
        })
        opt = fake.tree(opt_abs, opt_specs)
        step = make_train_step(model, AdamWConfig(), microbatches=plan["microbatches"],
                               remat=plan["remat"])
        args = (params, opt, inputs)
        return (lambda: step(params, opt, inputs)), args, fake

    def cache_for(max_len: int, **kw):
        with fake.mode:
            like = model.cache_init(b, max_len, **kw)
        specs = _spec_tree(mesh, lambda: build_cache_specs(
            tree_map(lambda t: tuple(t.shape), like), mesh, scfg, cfg.n_kv_heads))
        return fake.tree(like, specs)

    if cell.kind == "prefill":
        if cfg.family == "audio":
            tokens = fake.tensor((b, WHISPER_DECODER_PROMPT), torch.int32,
                                 _batch_spec(mesh, scfg, b))
            cache = cache_for(WHISPER_DECODER_PROMPT, enc_len=s)
            frames = inputs["frames"]
            return (lambda: model.prefill(params, tokens, cache, patch_embeds=frames),
                    (params, tokens, cache, frames), fake)
        cache = cache_for(s)
        tokens = inputs["tokens"]
        if cfg.family == "vlm":
            pe = inputs["patch_embeds"]
            return (lambda: model.prefill(params, tokens, cache, patch_embeds=pe),
                    (params, tokens, cache, pe), fake)
        return (lambda: model.prefill(params, tokens, cache)), (params, tokens, cache), fake

    if cell.kind == "decode":
        cache = cache_for(s, enc_len=WHISPER_CROSS_LEN) if cfg.family == "audio" else cache_for(s)
        tokens = inputs["tokens"]
        return (lambda: model.decode_step(params, tokens, cache)), (params, tokens, cache), fake
    raise ValueError(cell.kind)


#: the axis sizes the rules see for one card: no axis shards anything
_ONE_CARD = {"data": 1, "model": 1}


def _batch_spec(mesh, scfg: ShardingConfig, b: int):
    if mesh is None:
        return ()
    dp = math.prod(dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))[a] for a in scfg.dp_axes)
    return (scfg.dp_axes if len(scfg.dp_axes) > 1 else scfg.dp_axes[0],) if b % dp == 0 else ()


def _storages(tree) -> Dict[int, int]:
    out = {}
    for t in local_tensors(tree):
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def _replicated_constants(fake: FakeArgs):
    """Plain tensors a step makes itself (positions, masks, RoPE tables)
    taken as replicated where they meet DTensors, as XLA takes a jitted
    step's constants."""
    import contextlib

    if fake.mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def trace_step(step: Callable[[], Any], args, fake: FakeArgs) -> dict:
    """Run ``step()`` once under ``trace_analysis``: the memory, cost and
    collective fields of a cell's record, ``peak_bytes`` and ``trace_s``,
    and ``op_calls`` (the kernels' custom-op calls)."""
    t0 = time.time()
    with fake.mode, analysing() as mode, _replicated_constants(fake):
        arg_bytes = mode.add_arguments(args)
        out = step()
        arg_st = _storages(args)
        out_st = _storages(out)
    totals = mode.totals
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    return {
        "trace_s": round(time.time() - t0, 2),
        "memory": {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(sum(out_st.values())),
            "temp_bytes": int(mode.peak_bytes - arg_bytes),
            "alias_bytes": int(alias),
            "generated_code_bytes": 0,
        },
        "peak_bytes": int(mode.peak_bytes),
        "cost": {
            "flops": totals.flops,
            "transcendentals": totals.transcendentals,
            "registered_flops": totals.registered_flops,
        },
        "collectives": totals.as_dict()["collectives"],
        "collective_bytes_total": totals.total_collective_bytes,
        "op_calls": dict(totals.op_calls),
    }


def trace_bounded(arch: str, cell: ShapeCell, mesh, plan: dict, cfg) -> dict:
    """A cell's record from traces of its first one and two time chunks
    (``BOUNDED``), extrapolated to its length."""
    n = cell.seq_len // TIME_CHUNK
    if n * TIME_CHUNK != cell.seq_len or n < 2:
        raise ValueError(f"{cell.name}: {cell.seq_len} tokens are not whole chunks of {TIME_CHUNK}")
    one, two = (trace_step(*build_cell(arch, dataclasses.replace(cell, seq_len=k * TIME_CHUNK),
                                       mesh, plan, cfg=cfg)) for k in (1, 2))
    out = extrapolate(one, two, n)
    out["bounded"] = {"traced_tokens": [TIME_CHUNK, 2 * TIME_CHUNK], "chunks": n}
    return out


def input_specs(arch: str, shape: str, multi_pod: bool = False):
    """The fake arguments of a cell (public helper, as in the reference)."""
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    plan = plan_for(arch, shape, multi_pod)
    _, args, _ = build_cell(arch, SHAPES_BY_NAME[shape], mesh, plan)
    return args


# --------------------------------------------------------------------------- #
def run_cell(arch: str, shape: str, multi_pod: bool, overrides=None,
             save: bool = True, tag: str = "", *, mesh=None, cfg=None,
             cell: Optional[ShapeCell] = None) -> dict:
    """Trace one cell; a failed cell is recorded with its traceback. ``mesh``
    (default the production mesh over a fake world of its size), ``cfg``
    and ``cell`` stand in for the production ones where a caller (the
    tests) gives them."""
    cell = cell or SHAPES_BY_NAME[shape]
    cfg = cfg or get_config(arch)
    ok, why = cell_applicable(cfg, cell)
    if not ok:
        return {"arch": arch, "shape": shape, "status": "skipped", "reason": why}
    if mesh is None:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    plan = plan_for(arch, shape, multi_pod, overrides)
    result = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_name(mesh),
        "chips": int(mesh.size()),
        "microbatches": plan["microbatches"],
        "tag": tag,
    }
    try:
        if (arch, shape) in BOUNDED:
            result.update({"status": "ok", **trace_bounded(arch, cell, mesh, plan, cfg)})
        else:
            step, args, fake = build_cell(arch, cell, mesh, plan, cfg=cfg)
            result.update({"status": "ok", **trace_step(step, args, fake)})
    except Exception as e:  # noqa: BLE001 — a failed cell is a recorded bug
        result.update({
            "status": "failed",
            "error": f"{type(e).__name__}: {e}"[:2000],
            "traceback": traceback.format_exc()[-4000:],
        })
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        out = RESULTS_DIR / f"{arch}__{shape}__{result['mesh']}{suffix}.json"
        out.write_text(json.dumps(result, indent=2))
        result["saved_to"] = str(out)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS, help="architecture id")
    ap.add_argument("--shape", choices=[s.name for s in SHAPES], help="shape cell")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 mesh")
    ap.add_argument("--all", action="store_true", help="run every applicable cell")
    ap.add_argument("--tag", default="", help="variant tag for perf experiments")
    ap.add_argument("--no-fsdp", action="store_true", help="replicate weights over dp")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="override the plan's microbatch count (sizing the plan's table)")
    args = ap.parse_args()

    overrides = {}
    if args.no_fsdp:
        overrides["sharding"] = ShardingConfig(
            dp_axes=("pod", "data") if args.multi_pod else ("data",), fsdp_weights=False)
    if args.microbatches is not None:
        overrides["microbatches"] = args.microbatches
    overrides = overrides or None

    if args.all:
        failures = 0
        for arch in ARCH_IDS:
            for cell in SHAPES:
                r = run_cell(arch, cell.name, args.multi_pod, overrides, tag=args.tag)
                status = r["status"]
                extra = r.get("reason", r.get("error", ""))
                if status == "ok":
                    extra = (f"trace {r['trace_s']} s, peak {r['peak_bytes'] / 2**30:.2f} GiB, "
                             f"mb {r['microbatches']}")
                print(f"{arch:20s} {cell.name:12s} {status:8s} {extra}", flush=True)
                failures += status == "failed"
        return 1 if failures else 0

    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    r = run_cell(args.arch, args.shape, args.multi_pod, overrides, tag=args.tag)
    print(json.dumps({k: v for k, v in r.items() if k != "traceback"}, indent=2))
    if r["status"] == "failed":
        print(r.get("traceback", ""), file=sys.stderr)
    return 1 if r["status"] == "failed" else 0


if __name__ == "__main__":
    sys.exit(main())
