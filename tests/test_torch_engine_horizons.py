"""Engine options, port against reference: the fused decode horizon pinned
(2 on the paged layout, 3 on the dense one) and capped (3, paged), an
``eos_id`` on both layouts, and paged prompts longer than ``max_len``. On
the float32 smoke Qwen3 with 4 slots, the cost model pinned, stragglers
off and both engines on a scripted clock (``torch_port_engine``), each
setting must give the reference's token streams, stage list, counters and
``summary()``.

EOS serves close with ``finish_serve(validate=False)``: on a workload with
known lengths a request that stops at its EOS has decoded fewer tokens than
it asked for, which the reference's own validation refuses (ROADMAP §3,
reference caveats)."""
import pytest

from torch_port_engine import DENSE, PAGED, assert_same, fcfs, gsm8k, serve_both

# a token several of this workload's greedy streams emit mid-stream (the
# smoke model never samples token 7 on it, so an eos_id of 7 would stop nothing)
EOS = 219


@pytest.mark.parametrize("layout,kw", [
    ("paged", dict(decode_horizon=2)),
    ("dense", dict(decode_horizon=3)),
    ("paged", dict(max_decode_horizon=3)),
], ids=["paged-pinned-2", "dense-pinned-3", "paged-capped-3"])
def test_horizon_gives_the_reference_serve(layout, kw):
    port, ref, _ = serve_both(gsm8k, fcfs, dict({"dense": DENSE, "paged": PAGED}[layout], **kw))
    assert_same(port, ref)
    rounds = {s["rounds"] for s in port["stages"] if s["kind"] == "decode"}
    if "decode_horizon" in kw:
        # a pinned K dispatches exactly K, or a power of two under a budget
        assert kw["decode_horizon"] in rounds
        assert rounds <= {kw["decode_horizon"], 1, 2}
    else:
        assert max(rounds) <= kw["max_decode_horizon"] and rounds <= {1, 2}


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_eos_gives_the_reference_serve(layout):
    port, ref, _ = serve_both(gsm8k, fcfs, dict({"dense": DENSE, "paged": PAGED}[layout],
                                                eos_id=EOS), validate=False)
    assert_same(port, ref)
    # a decoded EOS ends its stream (a first token sampled at prefill is not
    # checked, in either package), and some stream stopped there
    streams = port["streams"].values()
    assert all(EOS not in s[1:-1] for s in streams)
    assert any(len(s) > 1 and s[-1] == EOS for s in streams)


def test_paged_prompts_longer_than_max_len_give_the_reference_serve():
    def long(pkg):
        reqs = gsm8k(pkg, seed=3, n_requests=8, input_mean=60, input_std=10, input_max=90)
        assert any(r.n_prefill > PAGED["max_len"] for r in reqs)
        return reqs

    port, ref, _ = serve_both(long, fcfs, PAGED)
    assert_same(port, ref)
    assert len(port["streams"]) == 8 and all(port["streams"].values())
