"""``test_torch_dryrun_full.py``'s bar on the ``train_4k`` cells it leaves
out: Mixtral-8x22B, OLMoE-1B-7B, Granite-3-8B, Nemotron-4-15B,
Qwen2-VL-7B, RecurrentGemma-9B (its (rec, rec, attn) periods checkpointed
in both packages) and Whisper-small, full size on 16 x 16 at one
microbatch, held to ``FULL_SIZE_GAPS`` there. xLSTM's ``train_4k`` (a bounded trace of about
ten minutes) is left to ``torch_port_dryrun_parity.py``.
"""
import pytest

from test_torch_dryrun_full import cells_of, run_full, verdict
from torch_port_dryrun import full_cells_for

CELLS = full_cells_for(("mixtral_8x22b", "olmoe_1b_7b", "granite_3_8b", "nemotron_4_15b", "qwen2_vl_7b",
                        "recurrentgemma_9b", "whisper_small"), ("train_4k",))


@pytest.fixture(scope="module")
def records():
    return run_full(CELLS)


@pytest.mark.parametrize("cell", cells_of(CELLS))
def test_argument_bytes_equal_the_reference(records, cell):
    assert verdict(records, cell)["arg_diff"] == 0


@pytest.mark.parametrize("cell", cells_of(CELLS))
def test_port_does_no_more_than_the_reference(records, cell):
    v = verdict(records, cell)
    assert v["flops"] <= 1.02 and v["elements"] <= 1.02, v


@pytest.mark.parametrize("cell", cells_of(CELLS))
def test_gaps_are_recorded_and_held(records, cell):
    v = verdict(records, cell)
    assert not v["problems"], v["problems"]
