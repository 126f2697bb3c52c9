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
model axis, so the prefills run sequence-parallel and xLSTM splits its
projections' contraction; on (2, 4) StarCoder2 and xLSTM take the other
partitions (``PERF.md``).

Tolerances (float32): the loss within ``LOSS_TOL``; every gradient leaf
within ``GRAD_TOL`` of its largest magnitude (the card's gradient gate);
the prefill's and the decode step's logits within ``LOGIT_TOL``.
"""
import json
from pathlib import Path

import pytest

import torch_port_ranks as ranks
from torch_port_helpers import run_ranks

ARCHS = ("starcoder2_7b", "qwen3_8b", "whisper_small", "xlstm_350m", "mixtral_8x22b")
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
