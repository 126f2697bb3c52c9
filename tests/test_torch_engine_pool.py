"""Engine options, port against reference: a page pool too small for every
slot (upfront and on-demand reservation, and with the prefix cache). On the
float32 smoke Qwen3 with 4 slots, the cost model pinned, stragglers off and
both engines on a scripted clock (``torch_port_engine``), each setting must
give the reference's token streams, stage list, counters and
``summary()``."""
import pytest

from torch_port_engine import (
    PAGED,
    PORT,
    assert_same,
    engine,
    fcfs,
    gsm8k,
    outcome,
    run,
    scripted_clock,
    serve_both,
)

POOL = dict(PAGED, num_pages=10)
# longer outputs than the default workload's: every slot would need 4 of the
# 10 pages, so admissions wait and on-demand growth preempts
POOL_SPEC = dict(input_mean=20, output_mean=24, output_std=6, output_mu0=24, output_max=40)

_outcomes = {}


def pool_outcome(reserve):
    """(port, reference, port engine) of the pool workload on ``reserve``,
    served once a module; "roomy" (the default pool) serves the port only."""
    if reserve not in _outcomes:
        make = lambda pkg: gsm8k(pkg, **POOL_SPEC)
        if reserve == "roomy":
            eng = engine(PORT, PAGED)
            with scripted_clock():
                reqs = make(PORT)
                _outcomes[reserve] = (outcome(eng, run(eng, reqs, lagrangian(PORT, reqs))),)
        else:
            _outcomes[reserve] = serve_both(make, lagrangian, dict(POOL, page_reserve=reserve))
    return _outcomes[reserve]


def lagrangian(pkg, reqs):
    """A queue-backed schedule, so a preempted request can be re-queued."""
    return fcfs(pkg, reqs, "LagrangianPolicy")


@pytest.mark.parametrize("reserve", ["upfront", "ondemand"])
def test_small_pool_gives_the_reference_serve(reserve):
    port, ref, eng = pool_outcome(reserve)
    assert_same(port, ref)
    assert eng.slots.allocator.num_pages == 10
    assert eng.slots.allocator.num_free == 10            # every page back at drain
    if reserve == "ondemand":
        assert port["meta"]["preemption_events"] > 0


def test_small_pool_with_prefix_cache_gives_the_reference_serve():
    def shared(pkg):
        spec = pkg.data.WorkloadSpec(n_requests=10, input_mean=24, input_std=6,
                                     output_mean=14, output_std=5, output_max=20, input_max=40)
        return pkg.data.shared_prefix_workload(spec, seed=5, n_groups=2, prefix_mean=16.0,
                                               prefix_std=2.0, known_lengths=True)

    port, ref, eng = serve_both(shared, lagrangian, dict(POOL, prefix_cache=True))
    assert_same(port, ref)
    assert port["meta"]["cached_prefill_tokens"] > 0
    assert port["meta"]["preemption_events"] >= 1


def test_pool_options_change_the_schedule():
    """The pool settings are different schedules from the roomy pool's, so
    the comparisons above would notice one served as another; greedy, the
    pool moves no token."""
    roomy = pool_outcome("roomy")[0]
    for reserve in ("upfront", "ondemand"):
        small = pool_outcome(reserve)[0]
        assert small["stages"] != roomy["stages"]
        assert small["streams"] == roomy["streams"]
