"""Engine checkpoints mid-serve, port against reference: the port's engine
``state_dict`` taken after 3, 7 and 12 stages of a serve on each layout is
restored into a fresh engine (its dispatches warmed first, so the restore
lands in state that is already in use), which takes over the serve session
and finishes it. The restored serve must give the streams and the stage
list of the reference's uninterrupted serve (float32 smoke Qwen3, 4 slots,
cost model pinned, stragglers off, scripted clock)."""
import pytest
import torch

from torch_port_engine import (
    DENSE,
    PAGED,
    PORT,
    REF,
    engine,
    fcfs,
    gsm8k,
    outcome,
    run,
    scripted_clock,
)

LAYOUTS = {"paged": PAGED, "dense": DENSE}
_reference = {}


def reference(layout):
    """The reference engine's uninterrupted serve of the workload."""
    if layout not in _reference:
        eng = engine(REF, LAYOUTS[layout])
        with scripted_clock():
            reqs = gsm8k(REF)
            _reference[layout] = outcome(eng, run(eng, reqs, fcfs(REF, reqs)))
    return _reference[layout]


@pytest.mark.parametrize("steps", [3, 7, 12])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_restored_engine_finishes_the_reference_serve(layout, steps):
    ref = reference(layout)
    with scripted_clock():
        reqs = gsm8k(PORT)
        first = run(engine(PORT, LAYOUTS[layout]), reqs, fcfs(PORT, reqs), steps=steps)
        if layout == "paged" and steps == 3:
            assert first._chunking, "the checkpoint should catch a prompt mid-chunk"
        state = first.state_dict()
        # the checkpoint holds copies: nothing of the first engine leaks in
        for t in first.slots.cache.values():
            t.fill_(-1 if t.dtype == torch.int32 else 7)
        second = engine(PORT, LAYOUTS[layout])
        second.warm_serving_shapes()
        second.generated = {rid: list(toks) for rid, toks in first.generated.items()}
        second.load_state_dict(state, {r.rid: r for r in reqs})
        second._sv = first._sv
        while second.serve_step() != "done":
            pass
        trace = second.finish_serve()
    port = outcome(second, trace)
    assert port["streams"] == ref["streams"]
    assert port["stages"] == ref["stages"]
