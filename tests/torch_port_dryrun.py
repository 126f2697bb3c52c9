"""Shared set-up of the dry-run parity tests (``test_torch_dryrun.py``,
``test_torch_dryrun_archs.py``, ``test_torch_dryrun_full*.py``) and of
``torch_port_dryrun_parity.py``: the reference's cells compiled in a
subprocess on fake XLA devices (``REF_SCRIPT``, started before the port's
traces so that the two overlap) — the smoke configs, or the published ones
on the production meshes (16 x 16, 2 x 16 x 16) — and the port's same cells
traced on a fake world.

A cell is ``(arch, name, kind, seq_len, batch)``, with an optional sixth
entry: the plan's ``fsdp_weights`` in both packages where a test compares a
cell at a plan other than the port's own.

Full-size cells are held to one bar (``full_size_verdict``): argument bytes
equal (less ``unread_by_the_reference``), and the port does no more than the
reference — dot FLOPs and collective result-buffer elements at most
``BAR`` x the reference's; where it does less by more than the bar on
either term, the cell is a recorded gap (``FULL_SIZE_GAPS``), held within
``BAR - 1`` of its ratios. Collectives compare in elements, not bytes: the
reference's CPU compile carries many bf16 values as float32.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
from torch.utils._pytree import tree_flatten_with_path

ROOT = Path(__file__).resolve().parents[1]
KINDS = {"train_4k": ("train", 32), "prefill_32k": ("prefill", 32), "decode_32k": ("decode", 64)}
BATCH = 8
#: seconds the reference's subprocess may take to compile its cells
REF_BUDGET_S = 300
#: the full-size bar: the port's dot FLOPs and collective elements over the
#: reference's at most this, and a gap below ``2 - BAR`` recorded
BAR = 1.02

REF_SCRIPT = textwrap.dedent("""
    import json, re, sys
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config, get_smoke_config
    from repro.configs.shapes import ShapeCell
    from repro.distributed.sharding import ShardingConfig
    from repro.launch import dryrun, hlo_analysis as ha
    from repro.launch.plan import plan_for

    KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
    OP_NAME = re.compile(r'op_name="([^"]*)"')

    def walk_hlo(text):
        # dot FLOPs (in all and by op_name) and collectives by kind, each
        # times its enclosing loops' trip counts
        comps, entry = ha.parse_hlo(text)
        out = {"dot_flops": 0.0, "dot_flops_by_op": {}, "collective_shapes": {},
               "collectives": {k: {"bytes": 0.0, "count": 0.0, "elements": 0.0} for k in KINDS}}
        def walk(name, mult, stack=(), outer="?"):
            comp = comps.get(name)
            if comp is None or name in stack:
                return
            stack = stack + (name,)
            for op_name in comp.order:
                op = comp.ops[op_name]
                oc = op.opcode
                if oc == "while":
                    m = re.search(r"condition=%?([\\w.\\-]+)", op.line)
                    b = re.search(r"body=%?([\\w.\\-]+)", op.line)
                    trips = ha._trip_count(comps, m.group(1)) if m else 1.0
                    if b:
                        walk(b.group(1), mult * trips, stack, outer)
                    continue
                if oc in ("fusion", "call", "custom-call", "conditional", "async-start", "map",
                          "reduce", "reduce-window", "sort", "scatter", "select-and-scatter"):
                    m = OP_NAME.search(op.line)
                    for cm in ha._ATTR_CALLS.finditer(op.line):
                        walk(cm.group(1), mult, stack, m.group(1) if m else outer)
                if oc == "dot":
                    f = mult * ha._dot_flops(comp, op)
                    out["dot_flops"] += f
                    m = OP_NAME.search(op.line)
                    key = m.group(1) if m else outer
                    out["dot_flops_by_op"][key] = out["dot_flops_by_op"].get(key, 0.0) + f
                base = oc[:-len("-start")] if oc.endswith("-start") else oc
                if base in KINDS:
                    shape = op.shape_str
                    if oc.endswith("-start") and shape.startswith("("):
                        shape = ha._SHAPE_TOKEN.findall(shape)[-1]
                        shape = f"{shape[0]}[{shape[1]}]"
                    elems, nbytes = ha._shape_elems_bytes(shape)
                    c = out["collectives"][base]
                    c["bytes"] += mult * nbytes
                    c["count"] += mult
                    c["elements"] += mult * elems
                    key = f"{base} {re.sub(r'[{][^}]*[}]', '', shape)}"
                    out["collective_shapes"][key] = out["collective_shapes"].get(key, 0.0) + mult
        walk(entry, 1.0)
        return out

    opts = json.loads(sys.argv[3]) if len(sys.argv) > 3 else {}
    axes = tuple(opts.get("axes", ("data", "model")))
    multi_pod = "pod" in axes
    dp_axes = tuple(a for a in axes if a in ("pod", "data"))
    shape = tuple(json.loads(sys.argv[2]))
    mesh = Mesh(np.array(jax.devices()).reshape(shape), axes)
    out = {}
    for arch, name, kind, seq, batch, *fsdp in json.loads(sys.argv[1]):
        cfg = get_config(arch) if opts.get("full") else get_smoke_config(arch)
        dryrun.get_config = lambda a, cfg=cfg: cfg
        overrides = {"microbatches": 1}
        if fsdp:
            overrides["sharding"] = ShardingConfig(dp_axes=dp_axes, fsdp_weights=fsdp[0])
        plan = plan_for(arch, name, multi_pod, overrides)
        fn, args, shards, outs, donate = dryrun.build_cell(
            arch, ShapeCell(name, seq, batch, kind), mesh, plan)
        with mesh:
            comp = jax.jit(fn, in_shardings=shards, out_shardings=outs,
                           donate_argnums=donate).lower(*args).compile()
        rec = walk_hlo(comp.as_text())
        if not opts.get("detail"):
            rec.pop("dot_flops_by_op")
            rec.pop("collective_shapes")
        out[f"{arch}/{name}"] = {
            "argument_bytes": int(comp.memory_analysis().argument_size_in_bytes), **rec}
    print(json.dumps(out))
    print("OK")
""")


def cells_for(archs, *, fsdp_at_serve=()):
    """Every cell kind for each of ``archs`` at batch ``BATCH``; the serve
    cells of the archs in ``fsdp_at_serve`` at FSDP weights."""
    out = []
    for a in archs:
        for name, (kind, seq) in KINDS.items():
            cell = [a, name, kind, seq, BATCH]
            if a in fsdp_at_serve and kind != "train":
                cell.append(True)
            out.append(tuple(cell))
    return out


def full_cells_for(archs, names=tuple(KINDS), *, fsdp_at_serve=()):
    """The full-size cells ``names`` of each of ``archs`` (the production
    shapes' sequence and global batch); the serve cells of the archs in
    ``fsdp_at_serve`` at FSDP weights."""
    from repro_torch.configs import SHAPES_BY_NAME, cell_applicable, get_config

    out = []
    for a in archs:
        for name in names:
            shape = SHAPES_BY_NAME[name]
            if not cell_applicable(get_config(a), shape)[0]:
                continue
            cell = [a, name, shape.kind, shape.seq_len, shape.global_batch]
            if a in fsdp_at_serve and shape.kind != "train":
                cell.append(True)
            out.append(tuple(cell))
    return out


def mesh_axes(mesh_shape):
    return ("pod", "data", "model") if len(mesh_shape) == 3 else ("data", "model")


def start_reference(cells, mesh_shape, *, full: bool = False, detail: bool = False):
    """The reference's subprocess compiling ``cells`` on fake XLA devices
    laid out as ``mesh_shape`` (data x model, or pod x data x model): the
    smoke configs, or the published ones where ``full``; ``detail`` adds
    each cell's dot FLOPs by ``op_name`` and its collectives by shape."""
    n = 1
    for d in mesh_shape:
        n *= d
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={n}",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    opts = {"full": full, "detail": detail, "axes": list(mesh_axes(mesh_shape))}
    return subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, json.dumps(cells), json.dumps(list(mesh_shape)),
         json.dumps(opts)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def stop(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def reference_results(proc, budget: float = REF_BUDGET_S) -> dict:
    """The subprocess's ``{"arch/cell": record}``: ``argument_bytes``,
    ``dot_flops`` and ``collectives`` (bytes, count and result-buffer
    elements by kind)."""
    try:
        stdout, stderr = proc.communicate(timeout=budget)
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"the reference's subprocess ran past {budget} s")
    assert proc.returncode == 0 and "OK" in stdout, stderr[-3000:]
    return json.loads(stdout.splitlines()[-2])


def unread_by_the_reference(arch: str, kind: str, args) -> int:
    """Bytes a device of the arguments the reference's step never reads:
    the cache leaves a prefill replaces whole (every ``length``, a ring's
    K/V and positions, Whisper's cross K/V, RecurrentGemma's attention
    rings) and, in Whisper's decode step, the encoder's parameters and the
    cross attention's K/V projections (the cross K/V come from the cache)."""
    total = 0
    flat = tree_flatten_with_path(args)[0]
    ring = kind == "prefill" and any(
        [getattr(p, "key", None) for p in path][-1:] == ["pos"] for path, _ in flat)
    for path, t in flat:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        names = [k for k in keys if isinstance(k, str)]
        local = t._local_tensor
        n = local.numel() * local.element_size()
        if kind == "prefill" and keys[0] == 2 and (
                names[-1] in ("length", "pos", "cross_k", "cross_v") or names[0] == "attn"
                or (ring and names[-1] in ("k", "v"))):
            total += n
        if kind == "decode" and arch == "whisper_small" and keys[0] == 0 and (
                names[0] in ("encoder", "norm_enc_final")
                or names[1:] in (["cross_attn", "wk"], ["cross_attn", "wv"], ["cross_attn", "bv"])):
            total += n
    return total


def trace_cells(cells, mesh, *, full: bool = False) -> dict:
    """The port's record of each cell on ``mesh`` (one microbatch), with
    ``unread`` (``unread_by_the_reference``) beside it: the smoke configs,
    or the published ones where ``full`` (the bounded cells through
    ``dryrun.trace_bounded``)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.distributed.sharding import ShardingConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.plan import plan_for

    multi_pod = "pod" in mesh.mesh_dim_names
    dp_axes = ("pod", "data") if multi_pod else ("data",)
    out = {}
    for arch, name, kind, seq, batch, *fsdp in cells:
        overrides = {"microbatches": 1}
        if fsdp:
            overrides["sharding"] = ShardingConfig(dp_axes=dp_axes, fsdp_weights=fsdp[0])
        plan = plan_for(arch, name, multi_pod, overrides)
        cfg = get_config(arch) if full else get_smoke_config(arch)
        cell = ShapeCell(name, seq, batch, kind)
        step, args, fake = dryrun.build_cell(arch, cell, mesh, plan, cfg=cfg)
        if full and (arch, name) in dryrun.BOUNDED:
            r = dryrun.trace_bounded(arch, cell, mesh, plan, cfg)
        else:
            r = dryrun.trace_step(step, args, fake)
        r["unread"] = unread_by_the_reference(arch, kind, args)
        out[f"{arch}/{name}"] = r
    return out


def collective_elements(record) -> float:
    """Result-buffer elements of every collective kind of a record (the
    port's or the reference's)."""
    return sum(c["elements"] for c in record["collectives"].values())


def full_size_verdict(port: dict, ref: dict, gap=None) -> dict:
    """A full-size cell against the reference's: ``arg_diff`` (the port's
    argument bytes, less those the reference never reads, minus the
    reference's), ``flops`` and ``elements`` (the port's over the
    reference's), and ``problems``: each way the cell breaks the bar — a
    difference in argument bytes, either ratio above ``BAR``, a ratio below
    ``2 - BAR`` without ``gap`` (its recorded ``(flop_ratio,
    element_ratio, cause)``), a ratio off its recorded one by more than
    ``BAR - 1``, or a recorded gap the cell no longer has."""
    arg_diff = port["memory"]["argument_bytes"] - port["unread"] - ref["argument_bytes"]
    flops = port["cost"]["registered_flops"] / ref["dot_flops"]
    elements = collective_elements(port) / collective_elements(ref)
    tol = BAR - 1
    problems = []
    if arg_diff:
        problems.append(f"argument bytes differ by {arg_diff}")
    for name, r in (("dot FLOPs", flops), ("collective elements", elements)):
        if r > BAR:
            problems.append(f"{name} {r:.4f} x the reference's")
    is_gap = flops < 2 - BAR or elements < 2 - BAR
    if is_gap and gap is None:
        problems.append(f"an unrecorded gap: FLOPs {flops:.4f}, elements {elements:.4f}")
    if gap is not None:
        if not is_gap:
            problems.append("a recorded gap the cell no longer has")
        elif abs(flops - gap[0]) > tol or abs(elements - gap[1]) > tol:
            problems.append(f"the gap moved: FLOPs {flops:.4f} (recorded {gap[0]}), "
                            f"elements {elements:.4f} (recorded {gap[1]})")
    return {"arg_diff": arg_diff, "flops": flops, "elements": elements, "problems": problems}
