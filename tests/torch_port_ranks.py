"""The ranks of the port's multi-process tests (``test_torch_distributed.py``):
each function here runs in one process of a gloo group on the CPU, started by
``torch_port_helpers.run_ranks``, and writes what the test checks under its
output directory. This module imports no JAX (each rank imports it), so a
rank starts in the time torch takes to import."""
import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.collectives import compressed_psum, psum_mean, quantize_int8
from repro_torch.distributed.elastic import build_mesh, remesh_plan, reshard_restore, save_unsharded
from repro_torch.distributed.sharding import ShardingConfig, build_param_specs, distribute, placements
from repro_torch.models.layers import _leaves, abstract_params, logical_specs, tree_map
from repro_torch.models.registry import get_model
from repro_torch.train.dp_compressed import (
    init_error_feedback,
    init_group,
    local_batch,
    make_dp_train_step,
    reduce_gradients,
)
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import _value_and_grad, make_train_step

DP_ARCH, CKPT_ARCH = "granite_3_8b", "qwen3_8b"
DP_BATCH, DP_STEPS = (16, 16), 3
DP_OPT = AdamWConfig(lr=1e-3, warmup_steps=1)
CKPT_STEP = 7


def rank_main(rank, fn, world, store_file, args):
    """A rank's entry: one intra-op thread, the gloo group through a
    FileStore (``file://``), ``fn(rank, world, *args)``, the group closed."""
    torch.set_num_threads(1)
    init_group("cpu", f"file://{store_file}", rank, world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def dp_model():
    cfg = dataclasses.replace(get_smoke_config(DP_ARCH), dtype="float32")
    return get_model(cfg, device="cpu")


def dp_batch(vocab):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, size=DP_BATCH).astype(np.int32)
    return {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(np.roll(tokens, -1, 1))}


def ckpt_model():
    return get_model(get_smoke_config(CKPT_ARCH), device="cpu")


def _copy(tree):
    return tree_map(lambda t: t.clone(), tree)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def _same_on_every_rank(tree) -> bool:
    """Whether every rank holds bit-identical leaves."""
    digest = torch.cat([_bits(t) for _, t in _leaves(tree)]).to(torch.int64)
    weights = torch.arange(1, digest.numel() + 1, dtype=torch.int64) % 65521
    sig = torch.stack([digest.sum(), (digest * weights).sum()])
    every = [torch.zeros_like(sig) for _ in range(dist.get_world_size())]
    dist.all_gather(every, sig)
    return all(torch.equal(s, sig) for s in every)


def collectives(rank, world, inputs, out):
    """Rank ``rank`` takes shard ``rank`` of every input leaf:
    ``compressed_psum`` from the given error feedback, ``psum_mean``, and
    this rank's int8 values."""
    with np.load(inputs) as f:
        g = {k[2:]: torch.from_numpy(f[k][rank]) for k in f.files if k.startswith("g_")}
        e = {k[2:]: torch.from_numpy(f[k][rank]) for k in f.files if k.startswith("e_")}
    q = {k: quantize_int8(g[k] + e[k])[0] for k in g}
    e_in = _copy(e)
    mean_c, e_new = compressed_psum(g, e_in, None)
    assert e_new is e_in                                   # updated in place
    mean_p = psum_mean(g, None)
    torch.save({"q": q, "mean_c": mean_c, "e": e_new, "mean_p": mean_p},
               Path(out) / f"collectives_{rank}.pt")


def world_of_8(rank, world, inputs, out, ckpt_dir):
    collectives(rank, world, inputs, out)
    dp_world(rank, world, out, ckpt_dir)


def dp_world(rank, world, out, ckpt_dir):
    """The data-parallel runs of an 8-rank world:

    * the plain reduced gradient of the global batch at the initial
      parameters;
    * ``DP_STEPS`` compressed and plain DP steps from identical state (loss
      and parameters after each run, and whether every rank holds the same
      parameters);
    * on a one-rank subgroup, the plain DP step against ``make_train_step``
      over ``DP_STEPS`` steps (bit for bit, from rank 0);
    * the smoke Qwen3 parameters sharded on a (4, 2) data/model mesh and
      written unsharded to ``ckpt_dir``."""
    out = Path(out)
    model = dp_model()
    params0 = model.init_params(0)
    batch = dp_batch(model.cfg.vocab_size)

    grads = tree_map(torch.zeros_like, params0)
    _value_and_grad(model, _copy(params0), local_batch(batch), False, grads)
    reduced, _ = reduce_gradients(grads, None, None, compress=False)

    runs = {}
    for compress in (True, False):
        step = make_dp_train_step(model, None, DP_OPT, compress=compress)
        p = _copy(params0)
        o, e = adamw_init(p), init_error_feedback(p)
        losses = []
        for _ in range(DP_STEPS):
            p, o, e, m = step(p, o, e, batch)
            losses.append(float(m["loss"]))
        runs["compressed" if compress else "plain"] = dict(
            params=p, losses=losses, replicated=_same_on_every_rank(p))

    sub, _ = dist.new_subgroups(group_size=1)
    if rank == 0:
        torch.save({"reduced": reduced, "runs": runs, "params0": params0}, out / "dp.pt")
        one = {}
        for name, make in (
            ("dp", lambda: make_dp_train_step(model, sub, DP_OPT, compress=False, remat=True)),
            ("train_step", lambda: make_train_step(model, DP_OPT, microbatches=1, remat=True)),
        ):
            fn = make()
            p = _copy(params0)
            o, e = adamw_init(p), init_error_feedback(p)
            trail = []
            for _ in range(DP_STEPS):
                if name == "dp":
                    p, o, e, m = fn(p, o, e, batch)
                else:
                    p, o, m = fn(p, o, batch)
                trail.append((float(m["loss"]), _copy(p)))
            one[name] = trail
        torch.save(one, out / "one_rank.pt")

    # the checkpoint written from a world of 8 on (4, 2)
    cm = ckpt_model()
    defs = cm.param_defs()
    mesh = build_mesh(remesh_plan((4, 2), ("data", "model"), 8), "cpu")
    specs = build_param_specs(abstract_params(defs), logical_specs(defs), mesh, ShardingConfig())
    full, sharded = dict(_leaves(cm.init_params(0))), {}
    for path, spec in _leaves(specs):
        node = sharded
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = distribute(full[path], mesh, spec)
    save_unsharded(ckpt_dir, CKPT_STEP, sharded)


def expected_shard(full: torch.Tensor, dt) -> torch.Tensor:
    """The block of ``full`` a rank holds under DTensor's placements: for each
    mesh dim in order, a ``Shard(d)`` splits dim ``d`` evenly and keeps the
    rank's piece along it."""
    coord = dt.device_mesh.get_coordinate()
    block = full
    for i, pl in enumerate(dt.placements):
        if pl.is_shard():
            n = dt.device_mesh.size(i)
            block = torch.chunk(block, n, dim=pl.dim)[coord[i]]
    return block


def restore_world(rank, world, ckpt_dirs, expected_files, out):
    """A new world of 4 ranks restores each checkpoint onto the (2, 2)
    mesh ``remesh_plan`` gives for 4 of the old (4, 2) mesh's 8 devices;
    every leaf's ``full_tensor()`` is bit-equal to the saved tree and each
    rank's local shard is its block."""
    plan = remesh_plan((4, 2), ("data", "model"), n_healthy=world)
    mesh = build_mesh(plan, "cpu")
    cm = ckpt_model()
    defs = cm.param_defs()
    ap, la = abstract_params(defs), logical_specs(defs)
    specs = dict(_leaves(build_param_specs(ap, la, mesh, ShardingConfig())))
    report = {"mesh": list(mesh.mesh_dim_names), "shape": list(mesh.mesh.shape), "leaves": 0,
              "sharded": 0}
    for ckpt_dir, exp_file in zip(ckpt_dirs, expected_files):
        want = dict(_leaves(torch.load(exp_file)))
        tree, _ = reshard_restore(ckpt_dir, ap, la, mesh)
        got = dict(_leaves(tree))
        assert set(got) == set(want)
        for path, dt in got.items():
            assert dt.dtype == want[path].dtype, path
            assert tuple(dt.placements) == placements(specs[path], mesh), path
            full = dt.full_tensor()
            assert full.shape == want[path].shape and torch.equal(_bits(full), _bits(want[path])), path
            local = dt.to_local()
            assert torch.equal(_bits(local), _bits(expected_shard(want[path], dt).contiguous())), path
            report["leaves"] += 1
            report["sharded"] += int(local.numel() < full.numel())
    torch.save(report, Path(out) / f"restore_{rank}.pt")


# Qwen3's vocabulary on the smoke widths: the reference's compressed-DP bar
# of 0.05 in loss (set at the smoke vocabulary of 256) is not met there
WIDE_VOCAB, WIDE_SEQ = 151936, 128


def wide_vocab_model():
    cfg = dataclasses.replace(get_smoke_config("qwen3_8b"), vocab_size=WIDE_VOCAB, dtype="float32")
    return get_model(cfg, device="cpu")


def wide_vocab_batch():
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, WIDE_VOCAB, size=(1, WIDE_SEQ)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}


def wide_vocab_dp(rank, world, params_file, out):
    """``DP_STEPS`` compressed and plain DP steps (``DP_OPT``) of the wide-
    vocabulary model from the given parameters; the losses of each run."""
    model = wide_vocab_model()
    params0 = torch.load(params_file)
    batch = {k: torch.from_numpy(v) for k, v in wide_vocab_batch().items()}
    losses = {}
    for compress in (True, False):
        step = make_dp_train_step(model, None, DP_OPT, compress=compress)
        p = _copy(params0)
        o, e = adamw_init(p), init_error_feedback(p)
        run = []
        for _ in range(DP_STEPS):
            p, o, e, m = step(p, o, e, batch)
            run.append(float(m["loss"]))
        losses["compressed" if compress else "plain"] = run
    torch.save(losses, Path(out) / "wide_vocab.pt")
