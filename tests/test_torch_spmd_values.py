"""The models' DTensor paths on real values: the local forms of
``distributed.spmd`` and the hints of ``distributed.sharding`` run on 8 gloo
ranks over a (2, 4) and a (1, 8) mesh (data x model), and must compute what
the same model computes on plain tensors in one process.

For StarCoder2 (6 query heads, which do not divide a model axis of 4),
Qwen3, Whisper, xLSTM and Mixtral (its sliding-window ring), each float32
smoke model runs its training loss with every gradient, a prefill of 16
tokens a row into a fresh cache and the next decode step
(``torch_port_ranks.spmd_values``): the dry-run's plan for training (FSDP
weights, remat) and TP-only weights at serve, but Mixtral's serve at FSDP
weights (the reference's plan). On (1, 8) no smoke model's heads divide the
model axis, so the prefills run sequence-parallel (every layer on sequence
shards, the MLP's weights gathered) and xLSTM splits its stream's columns
and its projections' contraction; on (2, 4) StarCoder2 and xLSTM take the
other partitions (``PERF.md``): StarCoder2's attention weight gradients in
FSDP blocks, each moved to its owner's row, and its layer norms on each
rank's rows. Mixtral with three experts (``mixtral_8x22b@3e``: they do not
divide a model axis of 4, so each rank holds a slice of every expert's FFN)
runs its decode step with the expert weights left where they lie on (2, 4)
(``spmd._stationary_experts``; ``test_the_decode_step_leaves_the_experts_in_place``).

A batch of one (the production meshes' long_500k cells: the batch too
small for the DP axes) is served on a (2, 2, 2) mesh (pod x data x model;
``torch_port_ranks.spmd_values_one``): Qwen3, Mixtral (FSDP weights, the
reference's plan; with four and with three experts), RecurrentGemma and
xLSTM with one head (its contraction split), a prefill and the next decode
step against plain tensors, each taking the local forms that use the idle
DP axes (``test_a_batch_of_one_takes_its_local_forms``).

Tolerances (float32): the loss within ``LOSS_TOL``; every gradient leaf
within ``GRAD_TOL`` of its largest magnitude (the card's gradient gate);
the prefill's and the decode step's logits within ``LOGIT_TOL``.
"""
import json
from pathlib import Path

import pytest

import torch_port_ranks as ranks
from torch_port_helpers import run_ranks

ARCHS = ("starcoder2_7b", "qwen3_8b", "whisper_small", "xlstm_350m", "mixtral_8x22b",
         "mixtral_8x22b@3e")
MESHES = ((2, 4), (1, 8))
LOSS_TOL, GRAD_TOL, LOGIT_TOL = 1e-5, 5e-4, 1e-4


@pytest.fixture(scope="module")
def values(tmp_path_factory):
    out = {}
    for shape in MESHES:
        work = tmp_path_factory.mktemp(f"values_{shape[0]}x{shape[1]}")
        run_ranks(ranks.spmd_values, 8, work, list(shape), list(ARCHS), ["mixtral_8x22b"],
                  str(work))
        out[shape] = json.loads((Path(work) / f"values_{shape[0]}x{shape[1]}.json").read_text())
    return out


CASES = [(shape, arch) for shape in MESHES for arch in ARCHS]


def _id(case):
    (d, m), arch = case
    return f"{d}x{m}-{arch}"


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_training_loss_and_gradients_match_plain_tensors(values, case):
    shape, arch = case
    r = values[shape][arch]
    assert r["loss"] <= LOSS_TOL, r["loss"]
    assert r["grad"] <= GRAD_TOL, (r["grad_leaf"], r["grad"])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_prefill_logits_match_plain_tensors(values, case):
    shape, arch = case
    assert values[shape][arch]["prefill"] <= LOGIT_TOL


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_decode_logits_match_plain_tensors(values, case):
    shape, arch = case
    assert values[shape][arch]["decode"] <= LOGIT_TOL


def test_the_decode_step_leaves_the_experts_in_place(values):
    """On (2, 4) three experts shard by their FFN width and the few tokens
    of a decode step move to the FSDP-sharded expert weights."""
    assert values[(2, 4)]["mixtral_8x22b@3e"]["stationary"] > 0


ONE = ("qwen3_8b", "mixtral_8x22b", "mixtral_8x22b@3e", "recurrentgemma_9b", "xlstm_350m@1h")
#: the local forms each batch-of-one arch must take (``spmd``)
ONE_FORMS = {"mixtral_8x22b@3e": ("_stationary_experts", "split_rms_norm"),
             "mixtral_8x22b": ("split_rms_norm",),
             "recurrentgemma_9b": ("idle_dp_columns", "_decode_heads_over_dp"),
             "xlstm_350m@1h": ("ModelAxis.swap",)}


@pytest.fixture(scope="module")
def values_one(tmp_path_factory):
    work = tmp_path_factory.mktemp("values_one")
    run_ranks(ranks.spmd_values_one, 8, work, list(ONE), str(work))
    return json.loads((Path(work) / "values_one.json").read_text())


@pytest.mark.parametrize("arch", ONE)
def test_a_batch_of_one_matches_plain_tensors(values_one, arch):
    r = values_one[arch]
    assert r["prefill"] <= LOGIT_TOL and r["decode"] <= LOGIT_TOL, r


@pytest.mark.parametrize("arch", list(ONE_FORMS))
def test_a_batch_of_one_takes_its_local_forms(values_one, arch):
    calls = values_one[arch]["calls"]
    assert all(calls.get(form, 0) > 0 for form in ONE_FORMS[arch]), calls
