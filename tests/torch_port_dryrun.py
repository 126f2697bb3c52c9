"""Shared set-up of the dry-run parity tests (``test_torch_dryrun.py``,
``test_torch_dryrun_archs.py``): the reference's smoke cells compiled in a
subprocess on fake XLA devices (``REF_SCRIPT``, started before the port's
traces so that the two overlap), and the port's same cells traced on a fake
world.

A cell is ``(arch, name, kind, seq_len, batch)``, with an optional sixth
entry: the plan's ``fsdp_weights`` in both packages where a test compares a
cell at a plan other than the port's own.
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

REF_SCRIPT = textwrap.dedent("""
    import json, re, sys
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_smoke_config
    from repro.configs.shapes import ShapeCell
    from repro.distributed.sharding import ShardingConfig
    from repro.launch import dryrun, hlo_analysis as ha
    from repro.launch.plan import plan_for

    def dot_flops(text):
        comps, entry = ha.parse_hlo(text)
        total = [0.0]
        def walk(name, mult, stack=()):
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
                        walk(b.group(1), mult * trips, stack)
                    continue
                if oc in ("fusion", "call", "custom-call", "conditional", "async-start", "map",
                          "reduce", "reduce-window", "sort", "scatter", "select-and-scatter"):
                    for cm in ha._ATTR_CALLS.finditer(op.line):
                        walk(cm.group(1), mult, stack)
                if oc == "dot":
                    total[0] += mult * ha._dot_flops(comp, op)
        walk(entry, 1.0)
        return total[0]

    shape = tuple(json.loads(sys.argv[2]))
    mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
    out = {}
    for arch, name, kind, seq, batch, *fsdp in json.loads(sys.argv[1]):
        cfg = get_smoke_config(arch)
        dryrun.get_config = lambda a, cfg=cfg: cfg
        overrides = {"microbatches": 1}
        if fsdp:
            overrides["sharding"] = ShardingConfig(dp_axes=("data",), fsdp_weights=fsdp[0])
        plan = plan_for(arch, name, False, overrides)
        fn, args, shards, outs, donate = dryrun.build_cell(
            arch, ShapeCell(name, seq, batch, kind), mesh, plan)
        with mesh:
            comp = jax.jit(fn, in_shardings=shards, out_shardings=outs,
                           donate_argnums=donate).lower(*args).compile()
        out[f"{arch}/{name}"] = {
            "argument_bytes": int(comp.memory_analysis().argument_size_in_bytes),
            "dot_flops": dot_flops(comp.as_text()),
        }
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


def start_reference(cells, mesh_shape):
    """The reference's subprocess compiling ``cells`` on fake XLA devices
    laid out as ``mesh_shape`` (data x model)."""
    n = mesh_shape[0] * mesh_shape[1]
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={n}",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, json.dumps(cells), json.dumps(list(mesh_shape))],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def stop(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def reference_results(proc) -> dict:
    """The subprocess's ``{"arch/cell": {"argument_bytes", "dot_flops"}}``."""
    try:
        stdout, stderr = proc.communicate(timeout=REF_BUDGET_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"the reference's subprocess ran past {REF_BUDGET_S} s")
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


def trace_cells(cells, mesh) -> dict:
    """The port's record of each cell on ``mesh`` (one microbatch), with
    ``unread`` (``unread_by_the_reference``) beside it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.distributed.sharding import ShardingConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.plan import plan_for

    out = {}
    for arch, name, kind, seq, batch, *fsdp in cells:
        overrides = {"microbatches": 1}
        if fsdp:
            overrides["sharding"] = ShardingConfig(dp_axes=("data",), fsdp_weights=fsdp[0])
        plan = plan_for(arch, name, False, overrides)
        step, args, fake = dryrun.build_cell(arch, ShapeCell(name, seq, batch, kind), mesh, plan,
                                             cfg=get_smoke_config(arch))
        r = dryrun.trace_step(step, args, fake)
        r["unread"] = unread_by_the_reference(arch, kind, args)
        out[f"{arch}/{name}"] = r
    return out
