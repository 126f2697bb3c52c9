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


# --------------------------------------------------------------------------- #
# The models on DTensors against plain tensors (test_torch_spmd_values.py)    #
# --------------------------------------------------------------------------- #
VALUES_B, VALUES_S, VALUES_CACHE = 8, 16, 24


def _values_inputs(cfg, rng):
    """The global batch (train) and prompts (serve) of the values test."""
    b, s, d = VALUES_B, VALUES_S, cfg.d_model
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    extra = {}
    if cfg.family == "audio":
        extra["frames"] = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32))
    batch.update(extra)
    step = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b,)).astype(np.int32))
    return batch, extra, step


def _serve(model, params, tokens, extra, step, batch=VALUES_B):
    """Prefill ``tokens`` into a fresh cache of ``batch`` slots, then one
    decode step of ``step``: the two logits."""
    if model.cfg.family == "audio":
        cache = model.cache_init(batch, VALUES_CACHE, enc_len=VALUES_S)
        prefill, _ = model.prefill(params, tokens, cache, patch_embeds=extra["frames"])
    else:
        cache = model.cache_init(batch, VALUES_CACHE)
        prefill, _ = model.prefill(params, tokens, cache)
    decode, _ = model.decode_step(params, step, cache)
    return prefill, decode


def _on_mesh(tree, specs, mesh):
    return {k: _on_mesh(v, specs[k], mesh) for k, v in tree.items()} if isinstance(tree, dict) \
        else distribute(tree, mesh, specs)


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def spmd_values(rank, world, mesh_shape, archs, fsdp_at_serve, out):
    """Each arch's float32 smoke model on DTensors over a ``mesh_shape``
    (data x model) mesh of the world — the training loss and every
    gradient (the dry-run's plan: FSDP weights, remat), a prefill's logits
    and the next decode step's (TP-only weights, FSDP for the archs in
    ``fsdp_at_serve``) — against the same model run on plain tensors in this
    process (plain tensors a step makes itself taken as replicated, as the
    dry-run takes them). Rank 0 writes ``values_<mesh>.json``: the loss's absolute
    error, each gradient leaf's largest error over its largest magnitude
    (the worst leaf), and the logits' largest absolute errors. An arch
    ``"<arch>@<n>e"`` is its smoke config with ``n`` experts; ``stationary``
    counts the MoE blocks that left their expert weights in place
    (``spmd._stationary_experts``)."""
    import json

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import input_specs_for
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.plan import plan_for

    stationary = [0]
    chooser = spmd._stationary_experts

    def counting(*a, **k):
        bmm = chooser(*a, **k)
        stationary[0] += bmm is not None
        return bmm

    spmd._stationary_experts = counting
    mesh = make_mesh(tuple(mesh_shape), ("data", "model"), "cpu")
    results = {}
    for name in archs:
        arch, _, variant = name.partition("@")
        cfg = _variant(dataclasses.replace(get_smoke_config(arch), dtype="float32"), variant)
        stationary[0] = 0
        plain, sharded = get_model(cfg, device="cpu"), get_model(cfg, device="cpu")
        params = plain.init_params(0)
        defs = plain.param_defs()
        batch, extra, step = _values_inputs(cfg, np.random.default_rng(0))
        r = {}

        # training: loss and gradients
        scfg = plan_for(arch, "train_4k")["sharding"]
        specs = build_param_specs(abstract_params(defs), logical_specs(defs), mesh, scfg)
        _, in_specs = input_specs_for(cfg, ShapeCell("train", VALUES_S, VALUES_B, "train"), mesh, scfg)
        grads = tree_map(torch.zeros_like, params)
        loss = _value_and_grad(plain, _copy(params), batch, True, grads)
        dparams = _on_mesh(params, specs, mesh)
        dgrads = tree_map(torch.zeros_like, dparams)
        dbatch = {k: distribute(v, mesh, in_specs.get(k, ())) for k, v in batch.items()}
        with implicit_replication():
            dloss = _value_and_grad(sharded, dparams, dbatch, True, dgrads)
        r["loss"] = abs(float(_full(dloss)) - float(loss))
        worst = (0.0, "")
        full_grads = dict(_leaves(tree_map(_full, dgrads)))
        for path, g in _leaves(grads):
            err = float((full_grads[path] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
            worst = max(worst, (err, "/".join(path)))
        r["grad"], r["grad_leaf"] = worst

        # serving: a prefill and the next decode step
        scfg = plan_for(arch, "prefill_32k")["sharding"]
        if arch in fsdp_at_serve:
            scfg = dataclasses.replace(scfg, fsdp_weights=True)
        specs = build_param_specs(abstract_params(defs), logical_specs(defs), mesh, scfg)
        with torch.no_grad():
            want = _serve(plain, params, batch["tokens"], extra, step)
        sharded.cache_init = _sharded_cache(sharded, mesh, scfg)
        _, in_specs = input_specs_for(cfg, ShapeCell("prefill", VALUES_S, VALUES_B, "prefill"),
                                      mesh, scfg)
        dextra = {k: distribute(v, mesh, in_specs["frames"]) for k, v in extra.items()}
        dtokens = distribute(batch["tokens"], mesh, in_specs["tokens"])
        dstep = distribute(step, mesh, ("data",) if VALUES_B % mesh_shape[0] == 0 else ())
        with implicit_replication():
            got = _serve(sharded, _on_mesh(params, specs, mesh), dtokens, dextra, dstep)
        r["prefill"], r["decode"] = (float((_full(g) - w).abs().max()) for g, w in zip(got, want))
        r["stationary"] = stationary[0]
        results[name] = r
    if rank == 0:
        (Path(out) / f"values_{mesh_shape[0]}x{mesh_shape[1]}.json").write_text(json.dumps(results))


def _variant(cfg, variant: str):
    """``cfg`` with ``n`` experts (``"<n>e"``) or ``n`` heads and KV heads
    (``"<n>h"``)."""
    if not variant:
        return cfg
    n = int(variant[:-1])
    if variant[-1] == "e":
        return dataclasses.replace(cfg, n_experts=n)
    return dataclasses.replace(cfg, n_heads=n, n_kv_heads=n)


def spmd_values_one(rank, world, archs, out):
    """A batch of one served on DTensors over a (2, 2, 2) mesh of the world
    (pod x data x model: the data and model axes of one size, the batch too
    small for the DP axes, as in the production meshes' long_500k cells):
    each arch's float32 smoke model prefills a prompt of 16 tokens into a
    fresh cache and takes the next decode step, against the same model on
    plain tensors (the serve plan on both DP axes; FSDP weights for Mixtral,
    the reference's plan). Rank 0 writes ``values_one.json``: the logits'
    largest absolute errors by arch (``"<arch>@<n>e"``: ``n`` experts,
    ``"<arch>@<n>h"``: ``n`` heads) and the batch-of-one local forms it
    took, by the calls that took them."""
    import json

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.distributed import op_rules
    from repro_torch.distributed.sharding import input_specs_for
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.plan import plan_for

    op_rules.register()       # RecurrentGemma's RG-LRU scan runs on DTensors
    # the local forms of a batch of one, counted by the calls that took them
    from repro_torch.distributed import spmd

    calls = {}

    def counted(name, fn, took=lambda r: True):
        def run(*a, **k):
            r = fn(*a, **k)
            calls[name] = calls.get(name, 0) + bool(took(r))
            return r
        return run

    for name in ("idle_dp_columns", "_decode_heads_over_dp", "split_rms_norm"):
        setattr(spmd, name, counted(name, getattr(spmd, name)))
    spmd._stationary_experts = counted("_stationary_experts", spmd._stationary_experts,
                                       lambda r: r is not None)
    swap_in = spmd.ModelAxis.project_in

    def project_in(self, x, w, w_side=None):
        calls["ModelAxis.swap"] = calls.get("ModelAxis.swap", 0) + bool(self.swap and w_side is not None)
        return swap_in(self, x, w, w_side)

    spmd.ModelAxis.project_in = project_in
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    results = {}
    for name in archs:
        arch, _, variant = name.partition("@")
        cfg = _variant(dataclasses.replace(get_smoke_config(arch), dtype="float32"), variant)
        plain, sharded = get_model(cfg, device="cpu"), get_model(cfg, device="cpu")
        params = plain.init_params(0)
        defs = plain.param_defs()
        rng = np.random.default_rng(0)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, VALUES_S)).astype(np.int32))
        step = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1,)).astype(np.int32))
        scfg = plan_for(arch, "long_500k", True)["sharding"]
        if arch == "mixtral_8x22b":
            scfg = dataclasses.replace(scfg, fsdp_weights=True)
        specs = build_param_specs(abstract_params(defs), logical_specs(defs), mesh, scfg)
        with torch.no_grad():
            want = _serve(plain, params, tokens, {}, step, batch=1)
        sharded.cache_init = _sharded_cache(sharded, mesh, scfg)
        _, in_specs = input_specs_for(cfg, ShapeCell("prefill", VALUES_S, 1, "prefill"), mesh, scfg)
        with implicit_replication():
            got = _serve(sharded, _on_mesh(params, specs, mesh),
                         distribute(tokens, mesh, in_specs["tokens"]), {}, distribute(step, mesh, ()),
                         batch=1)
        results[name] = {"prefill": float((_full(got[0]) - want[0]).abs().max()),
                         "decode": float((_full(got[1]) - want[1]).abs().max()),
                         "calls": dict(calls)}
        calls.clear()
    if rank == 0:
        (Path(out) / "values_one.json").write_text(json.dumps(results))


def _sharded_cache(model, mesh, scfg):
    """``model.cache_init`` on ``mesh``: each leaf zeros (the plain init's),
    distributed under ``build_cache_specs``."""
    from repro_torch.distributed.sharding import build_cache_specs

    init = model.cache_init

    def cache_init(*a, **k):
        cache = init(*a, **k)
        specs = build_cache_specs(tree_map(lambda t: tuple(t.shape), cache), mesh, scfg,
                                  model.cfg.n_kv_heads)
        return _on_mesh(cache, specs, mesh)

    return cache_init
