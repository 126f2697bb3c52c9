"""Engine options, port against reference: the replica's speed factor (2
on the dense layout, 0.5 on the paged one). On the float32 smoke Qwen3 with
4 slots, the cost model pinned, stragglers off and both engines on a
scripted clock (``torch_port_engine``), each setting must give the
reference's token streams, stage list, counters and ``summary()``, and
every stage must last the scripted clock's step over the speed factor."""
import pytest

from torch_port_engine import DENSE, PAGED, assert_same, fcfs, gsm8k, serve_both


@pytest.mark.parametrize("layout,speed", [("dense", 2.0), ("paged", 0.5)])
def test_speed_factor_gives_the_reference_serve(layout, speed):
    port, ref, _ = serve_both(gsm8k, fcfs, {"dense": DENSE, "paged": PAGED}[layout],
                              speed_factor=speed)
    assert_same(port, ref)
    # the scripted clock gives every stage 2**-10 s of wall time
    assert {round(s["t_end"] - s["t_start"], 9) for s in port["stages"]} == {
        round(2.0 ** -10 / speed, 9)}
