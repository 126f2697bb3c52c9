"""The port's distribution layer against the reference's
(``repro.distributed``, ``repro.train.dp_compressed``) on the CPU.

* Sharding rules: the port's ``logical_specs`` equal the reference's for
  every arch (smoke and full configs; defs only, nothing allocated), and its
  parameter (and ``abstract_opt_state`` m / v), cache and input specs equal
  the reference's on (4, 2) data/model, (2, 2, 2) pod/data/model and (8,)
  data meshes. The reference's specs come from one subprocess on 8 fake XLA
  devices that dumps them as JSON. On the (8,) mesh the default rules name
  the absent "model" axis and both packages raise ``KeyError`` for weights
  and caches; a rule set without TP (FSDP alone) is compared there too.
* Collectives: ``compressed_psum`` and ``psum_mean`` on 8 gloo ranks
  against the reference's under a jitted ``shard_map`` on 8 fake devices,
  on the same per-shard gradients and error feedback (numpy seed), the
  shards' scales 16x apart. Each rank's int8 values may differ from the
  reference's by at most 1 (XLA may turn ``/ scale`` into ``* (1/scale)``
  and flip a rounding tie), and the test counts how many do. The reduced
  means agree within 1e-6 relative, the error feedback (``gf - q * scale``,
  a cancellation) within 4 float32 ulps of ``gf``; each plus, where int8
  values differ, what the flips move: ``scale_max / 8`` a differing rank in
  the mean, ``scale_max`` in that rank's error feedback.
* The DP step: the reference's compressed-DP numerics test on 8 gloo ranks
  (float32 smoke Granite, a 16x16 global batch, lr 1e-3, warmup 1, 3 steps:
  compressed against plain within 0.05 in loss and 9e-3 in every leaf); the
  8-rank plain reduced gradient against the single-process gradient of the
  whole batch within 1e-5 of each leaf's largest magnitude; the plain DP
  step on a one-rank gloo group bit-equal to ``make_train_step``.
* Elastic restore: a checkpoint written by the reference's
  ``save_checkpoint`` and one written by the port from a world of 8 ranks
  on a (4, 2) mesh, each restored by ``reshard_restore`` in a new world of
  4 ranks on the (2, 2) mesh ``remesh_plan`` gives: every ``full_tensor()``
  bit-equal to the saved tree and each rank's local shard its block.

Ranks rendezvous through a FileStore under the test's temp dir
(``torch_port_helpers.run_ranks``; their bodies are in
``torch_port_ranks``)."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from repro.checkpoint import save_checkpoint as ref_save_checkpoint
from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.distributed import collectives as ref_coll
from repro.distributed.elastic import remesh_plan as ref_remesh_plan
from repro.models.layers import init_params as ref_init_params
from repro.models.layers import logical_specs as ref_logical_specs
from repro.models.registry import get_model as ref_get_model
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.elastic import remesh_plan
from repro_torch.distributed.sharding import (
    ShardingConfig,
    _spec_for,
    build_cache_specs,
    build_param_specs,
    input_specs_for,
)
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import ParamDef, _leaves, abstract_params, logical_specs, tree_map
from repro_torch.models.registry import get_model
from repro_torch.train.dp_compressed import init_group
from repro_torch.train.optimizer import abstract_opt_state
from repro_torch.train.train_step import _value_and_grad
from torch_port_helpers import run_ranks

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ARCH_IDS + ["llama_65b"]
WORLD = 8
TP_AXES = ("vocab", "mlp", "heads", "kv_heads", "experts", "rnn")
# mesh → (shape, axis names, {rule set: ShardingConfig kwargs})
MESHES = {
    "data4_model2": ((4, 2), ("data", "model"), {"default": {}}),
    "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"),
                          {"multi_pod": {"dp_axes": ["pod", "data"]}}),
    "data8": ((8,), ("data",), {"default": {}, "fsdp_only": {
        "logical_rules": [[a, None] for a in TP_AXES]}}),
}
CELLS = [(m, r) for m, (_, _, rule_sets) in MESHES.items() for r in rule_sets]
SMOKE_CACHE, FULL_CACHE = (8, 64), (128, 32768)

REF_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
    from repro.distributed.collectives import compressed_psum, psum_mean, quantize_int8
    from repro.distributed.sharding import (ShardingConfig, build_cache_specs,
                                            build_param_specs, input_specs_for)
    from repro.models.layers import abstract_params, logical_specs
    from repro.models.registry import get_model
    from repro.train.optimizer import abstract_opt_state

    meshes, inputs, out = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
    smoke_cache, full_cache = (8, 64), (128, 32768)

    def spec(s):
        return [list(e) if isinstance(e, tuple) else e for e in s.spec]

    def flat(tree):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {"/".join(str(p.key) for p in path): spec(s) for path, s in leaves}

    def attempt(fn):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001
            return {"error": type(e).__name__}

    def scfg_of(kw):
        kw = dict(kw)
        if "dp_axes" in kw:
            kw["dp_axes"] = tuple(kw["dp_axes"])
        if "logical_rules" in kw:
            kw["logical_rules"] = tuple(tuple(r) for r in kw["logical_rules"])
        return ShardingConfig(**kw)

    specs = {}
    for mname, (shape, axes, rule_sets) in meshes.items():
        mesh = jax.make_mesh(tuple(shape), tuple(axes))
        for rname, kw in rule_sets.items():
            scfg = scfg_of(kw)
            cell = specs.setdefault(mname + "/" + rname, {})
            for arch in ARCH_IDS + ["llama_65b"]:
                for size, get in (("smoke", get_smoke_config), ("full", get_config)):
                    cfg = get(arch)
                    model = get_model(cfg)
                    defs = model.param_defs()
                    ap, la = abstract_params(defs), logical_specs(defs)
                    oa = abstract_opt_state(ap)
                    b, s = smoke_cache if size == "smoke" else full_cache
                    cell[arch + "/" + size] = {
                        "params": attempt(lambda: flat(build_param_specs(ap, la, mesh, scfg))),
                        "m": attempt(lambda: flat(build_param_specs(oa["m"], la, mesh, scfg))),
                        "v": attempt(lambda: flat(build_param_specs(oa["v"], la, mesh, scfg))),
                        "cache": attempt(lambda: flat(build_cache_specs(
                            model.cache_shape(b, s), mesh, scfg, cfg.n_kv_heads))),
                    }
                    if size == "full":
                        for sc in SHAPES:
                            def one():
                                avals, shards = input_specs_for(cfg, sc, mesh, scfg)
                                return {k: [list(avals[k].shape), str(avals[k].dtype),
                                            spec(shards[k])] for k in avals}
                            cell[arch + "/" + size]["inputs/" + sc.name] = attempt(one)
    json.dump(specs, open(out + "/specs.json", "w"))

    mesh = jax.make_mesh((8,), ("data",))
    with np.load(inputs) as f:
        g = {k[2:]: jnp.asarray(f[k]) for k in f.files if k.startswith("g_")}
        e = {k[2:]: jnp.asarray(f[k]) for k in f.files if k.startswith("e_")}

    def body(g, e):
        q = {k: quantize_int8(g[k] + e[k])[0] for k in g}
        mean_c, new_e = compressed_psum(g, e, "data")
        return q, mean_c, new_e, psum_mean(g, "data")

    rep, sh = P(), P("data")
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(sh, sh), out_specs=(sh, rep, sh, rep),
                           check_rep=False))
    q, mean_c, new_e, mean_p = jax.tree_util.tree_map(np.asarray, fn(g, e))
    np.savez(out + "/collectives.npz",
             **{"q_" + k: v for k, v in q.items()}, **{"c_" + k: v for k, v in mean_c.items()},
             **{"e_" + k: v for k, v in new_e.items()}, **{"p_" + k: v for k, v in mean_p.items()})
    print("OK")
""")


def _collective_inputs(path):
    """Per-shard gradients and error feedback, (8, ...) a leaf: shard i of
    "w" scaled by 2^(i mod 4 - 2) (scales 16x apart), "b" a vector leaf, "z"
    all zeros on every shard (the scale's 1e-12 floor)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((WORLD, 24, 40)).astype(np.float32)
    w *= (2.0 ** (np.arange(WORLD) % 4 - 2))[:, None, None].astype(np.float32)
    arrays = {"w": w, "b": rng.standard_normal((WORLD, 300)).astype(np.float32),
              "z": np.zeros((WORLD, 8, 4), np.float32)}
    out = {}
    for k, a in arrays.items():
        out["g_" + k] = a
        out["e_" + k] = (1e-3 * rng.standard_normal(a.shape)).astype(np.float32)
    np.savez(path, **out)
    return out


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("distributed")


@pytest.fixture(scope="module")
def inputs(workdir):
    path = workdir / "collective_inputs.npz"
    return path, _collective_inputs(path)


@pytest.fixture(scope="module")
def reference_proc(workdir, inputs):
    """The reference's subprocess on 8 fake devices, started before the ranks
    run so that the two overlap."""
    out = workdir / "reference"
    out.mkdir()
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, json.dumps(MESHES), str(inputs[0]), str(out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference(reference_proc):
    proc, out = reference_proc
    try:
        stdout, stderr = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail("the reference's subprocess ran past 300 s")
    assert proc.returncode == 0 and "OK" in stdout, stderr[-3000:]
    specs = json.loads((out / "specs.json").read_text())
    with np.load(out / "collectives.npz") as f:
        coll_out = {k: f[k] for k in f.files}
    return specs, coll_out


@pytest.fixture(scope="module")
def world8(workdir, inputs, reference_proc):
    out, ckpt = workdir / "world8", workdir / "port_ckpt"
    out.mkdir()
    run_ranks(ranks.world_of_8, WORLD, workdir, str(inputs[0]), str(out), str(ckpt))
    return out, ckpt


# --------------------------------------------------------------------------- #
# Sharding rules                                                              #
# --------------------------------------------------------------------------- #
def test_spec_builder_shape_checks():
    mesh = {"data": 4, "model": 2}
    rules = ShardingConfig().rules()
    # weight (embed, mlp): fsdp over data + tp over model
    assert _spec_for((64, 128), ("embed", "mlp"), rules, mesh, True, ("data",)) == ("data", "model")
    # vocab-dim weight: no fsdp on embed
    assert _spec_for((100, 64), ("vocab", "embed"), rules, mesh, True, ("data",)) == ("model",)
    # non-divisible dims degrade to replication (batch=1)
    assert _spec_for((1, 7), ("batch", "mlp"), rules, mesh, False, ("data",)) == ()
    # an axis is never used twice
    s = _spec_for((8, 8, 8), ("experts", "mlp", "heads"), rules, mesh, False, ("data",))
    assert str(s).count("model") == 1, s


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_specs_match_reference(arch):
    for ref_get, get in ((ref_get_smoke_config, get_smoke_config), (ref_get_config, get_config)):
        ref_defs = ref_get_model(ref_get(arch)).param_defs()
        want = {p: tuple(a) for p, a in _leaves(ref_logical_specs(ref_defs))}
        defs = get_model(get(arch), device="cpu").param_defs()
        assert dict(_leaves(logical_specs(defs))) == want
        avals = dict(_leaves(abstract_params(defs)))
        assert all(t.device.type == "meta" for t in avals.values())
        ref_avals = dict(_leaves(jax.tree_util.tree_map(
            lambda d: d, ref_defs, is_leaf=lambda x: hasattr(x, "axes"))))
        assert {p: tuple(t.shape) for p, t in avals.items()} == \
            {p: tuple(d.shape) for p, d in ref_avals.items()}


def test_param_def_checks_its_axes_rank():
    with pytest.raises(ValueError):
        ParamDef((2, 3), axes=("embed",))


def test_dp_group_on_cuda_raises_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_group("cuda", f"file://{tmp_path}/filestore", 0, 1)


def _json_spec(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _attempt(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001
        return {"error": type(e).__name__}


def _port_cell(mesh_name, rule_set):
    shape, axes, rule_sets = MESHES[mesh_name]
    mesh = dict(zip(axes, shape))
    kw = dict(rule_sets[rule_set])
    if "dp_axes" in kw:
        kw["dp_axes"] = tuple(kw["dp_axes"])
    if "logical_rules" in kw:
        kw["logical_rules"] = tuple(tuple(r) for r in kw["logical_rules"])
    return mesh, ShardingConfig(**kw)


def _flat(tree):
    return {"/".join(p): _json_spec(s) for p, s in _leaves(tree)}


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_param_and_optimizer_specs_match_reference(reference, cell):
    mesh, scfg = _port_cell(*cell)
    want = reference[0]["/".join(cell)]
    for arch in ARCHS:
        for size, get in (("smoke", get_smoke_config), ("full", get_config)):
            defs = get_model(get(arch), device="cpu").param_defs()
            ap, la = abstract_params(defs), logical_specs(defs)
            oa = abstract_opt_state(ap)
            got = {
                "params": _attempt(lambda: _flat(build_param_specs(ap, la, mesh, scfg))),
                "m": _attempt(lambda: _flat(build_param_specs(oa["m"], la, mesh, scfg))),
                "v": _attempt(lambda: _flat(build_param_specs(oa["v"], la, mesh, scfg))),
            }
            ref = want[f"{arch}/{size}"]
            # the default rules name "model", which the (8,) mesh lacks
            assert ("error" in ref["params"]) == (cell == ("data8", "default"))
            assert got == {k: ref[k] for k in got}, (arch, size)


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_cache_specs_match_reference(reference, cell):
    mesh, scfg = _port_cell(*cell)
    want = reference[0]["/".join(cell)]
    for arch in ARCHS:
        for size, get in (("smoke", get_smoke_config), ("full", get_config)):
            cfg = get(arch)
            b, s = SMOKE_CACHE if size == "smoke" else FULL_CACHE
            cache = get_model(cfg, device="cpu").cache_shape(b, s)
            got = _attempt(lambda: _flat(build_cache_specs(cache, mesh, scfg, cfg.n_kv_heads)))
            assert got == want[f"{arch}/{size}"]["cache"], (arch, size)


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_input_specs_match_reference(reference, cell):
    mesh, scfg = _port_cell(*cell)
    want = reference[0]["/".join(cell)]
    for arch in ARCHS:
        cfg = get_config(arch)
        for sc in SHAPES:
            def one():
                avals, shards = input_specs_for(cfg, sc, mesh, scfg)
                assert all(t.device.type == "meta" for t in avals.values())
                return {k: [list(avals[k].shape), str(avals[k].dtype).split(".")[-1],
                            _json_spec(shards[k])] for k in avals}
            assert _attempt(one) == want[f"{arch}/full"]["inputs/" + sc.name], (arch, sc.name)


@pytest.mark.parametrize("case", [
    ((4, 2), ("data", "model"), 4),
    ((2, 16, 16), ("pod", "data", "model"), 300),
    ((2, 16, 16), ("pod", "data", "model"), 8),
    ((2, 16, 16), ("pod", "data", "model"), 512),
    ((2, 8, 4), ("pod", "data", "model"), 33),
    ((8,), ("data",), 5),
], ids=str)
def test_remesh_plan_matches_reference(case):
    old, axes, n = case
    want, got = _attempt(lambda: ref_remesh_plan(old, axes, n_healthy=n)), \
        _attempt(lambda: remesh_plan(old, axes, n_healthy=n))
    if isinstance(want, dict):
        assert got == want                                  # both refuse
        return
    assert (got.old_shape, got.new_shape, got.axis_names, got.lost_devices) == \
        (want.old_shape, want.new_shape, want.axis_names, want.lost_devices)
    assert got.healthy_fraction == want.healthy_fraction


def test_remesh_plan_preserves_model_axis():
    plan = remesh_plan((4, 2), ("data", "model"), n_healthy=4)
    assert plan.new_shape == (2, 2), plan
    plan = remesh_plan((2, 16, 16), ("pod", "data", "model"), n_healthy=300)
    assert plan.new_shape[2] == 16                      # TP width preserved
    assert np.prod(plan.new_shape) == 256               # largest pow2 fit
    with pytest.raises(ValueError):
        remesh_plan((2, 16, 16), ("pod", "data", "model"), n_healthy=8)


# --------------------------------------------------------------------------- #
# Collectives                                                                 #
# --------------------------------------------------------------------------- #
def test_quantize_int8_matches_reference():
    rng = np.random.default_rng(3)
    cases = [rng.standard_normal((33, 17)).astype(np.float32) * 5.0,
             np.zeros((4, 4), np.float32),
             np.linspace(-1.0, 1.0, 255, dtype=np.float32)]
    for x in cases:
        rq, rs = ref_coll.quantize_int8(jax.numpy.asarray(x))
        q, s = coll.quantize_int8(torch.from_numpy(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)
        np.testing.assert_array_equal(coll.dequantize_int8(q, s).numpy(),
                                      np.asarray(ref_coll.dequantize_int8(rq, rs)))


def _rank_outputs(out):
    return [torch.load(out / f"collectives_{r}.pt") for r in range(WORLD)]


def test_compressed_psum_matches_reference(world8, reference, inputs):
    got = _rank_outputs(world8[0])
    ref = reference[1]
    flips = 0
    for k in ("w", "b", "z"):
        q = np.stack([g["q"][k].numpy() for g in got])
        dq = np.abs(q.astype(np.int32) - ref["q_" + k].astype(np.int32))
        assert dq.max() <= 1, k
        flips += int(np.count_nonzero(dq))
        scale_max = max(float(np.abs(inputs[1]["g_" + k][r] + inputs[1]["e_" + k][r]).max())
                        for r in range(WORLD)) / 127.0
        slack = dq.sum(axis=0) * max(scale_max, 1e-12 / 127) / WORLD
        for r, g in enumerate(got):
            mean = g["mean_c"][k].numpy()
            np.testing.assert_array_less(np.abs(mean - ref["c_" + k][0]),
                                         1e-6 * np.abs(ref["c_" + k][0]) + slack + 1e-12)
            gf = inputs[1]["g_" + k][r] + inputs[1]["e_" + k][r]
            e_tol = 4 * np.spacing(np.abs(gf)) + dq[r] * scale_max + 1e-12
            np.testing.assert_array_less(np.abs(g["e"][k].numpy() - ref["e_" + k][r]), e_tol)
    total = sum(inputs[1]["g_" + k].size for k in ("w", "b", "z"))
    print(f"int8 values that differ from the reference's by 1: {flips} of {total}")
    assert flips <= total // 1000


def test_psum_mean_matches_reference(world8, reference):
    for g in _rank_outputs(world8[0]):
        for k in ("w", "b", "z"):
            np.testing.assert_allclose(g["mean_p"][k].numpy(), reference[1]["p_" + k][0],
                                       rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------- #
# The data-parallel step                                                      #
# --------------------------------------------------------------------------- #
def test_compressed_dp_step_tracks_the_plain_one(world8):
    runs = torch.load(world8[0] / "dp.pt")["runs"]
    c, u = runs["compressed"], runs["plain"]
    assert abs(c["losses"][-1] - u["losses"][-1]) < 0.05, (c["losses"], u["losses"])
    worst = max(float((a - b).abs().max()) for (_, a), (_, b)
                in zip(_leaves(c["params"]), _leaves(u["params"])))
    # Adam's steps are ~lr each: after 3 the compressed trajectory may sit a
    # few lr's worth of quantization noise away (the reference's bar)
    assert worst < 3 * 3 * 1e-3, worst
    assert u["losses"][-1] < u["losses"][0]


def test_dp_ranks_stay_replicated(world8):
    runs = torch.load(world8[0] / "dp.pt")["runs"]
    assert runs["compressed"]["replicated"] and runs["plain"]["replicated"]


def test_reduced_gradient_equals_the_whole_batch_gradient(world8):
    saved = torch.load(world8[0] / "dp.pt")
    model = ranks.dp_model()
    params = tree_map(lambda t: t.clone(), saved["params0"])
    grads = tree_map(torch.zeros_like, params)
    _value_and_grad(model, params, ranks.dp_batch(model.cfg.vocab_size), False, grads)
    reduced = dict(_leaves(saved["reduced"]))
    for path, g in _leaves(grads):
        err = float((reduced[path] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
        assert err <= 1e-5, (path, err)


def test_one_rank_plain_dp_step_is_train_step_bit_for_bit(world8):
    one = torch.load(world8[0] / "one_rank.pt")
    for (l_dp, p_dp), (l_ts, p_ts) in zip(one["dp"], one["train_step"]):
        assert l_dp == l_ts
        for (path, a), (_, b) in zip(_leaves(p_dp), _leaves(p_ts)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), path


# --------------------------------------------------------------------------- #
# Elastic restore                                                             #
# --------------------------------------------------------------------------- #
def test_reshard_restore_onto_a_smaller_mesh_in_a_new_world(world8, workdir):
    port_dir = world8[1]
    ref_dir, out = workdir / "ref_ckpt", workdir / "restore"
    out.mkdir()
    ref_cfg = ref_get_smoke_config(ranks.CKPT_ARCH)
    ref_params = ref_init_params(jax.random.key(0), ref_get_model(ref_cfg).param_defs())
    ref_save_checkpoint(ref_dir, ranks.CKPT_STEP, ref_params)
    want_ref = workdir / "ref_expected.pt"
    torch.save(params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params),
                                 get_smoke_config(ranks.CKPT_ARCH), "cpu"), want_ref)
    want_port = workdir / "port_expected.pt"
    torch.save(ranks.ckpt_model().init_params(0), want_port)
    run_ranks(ranks.restore_world, 4, workdir, [str(ref_dir), str(port_dir)],
              [str(want_ref), str(want_port)], str(out))
    n_leaves = len(list(_leaves(ranks.ckpt_model().param_defs())))
    for r in range(4):
        rep = torch.load(out / f"restore_{r}.pt")
        assert rep["mesh"] == ["data", "model"] and rep["shape"] == [2, 2]
        assert rep["leaves"] == 2 * n_leaves
        assert rep["sharded"] > 0
