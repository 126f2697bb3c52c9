"""Engine options, port against reference: the iteration policies and the
arrival-gated queue. On the float32 smoke Qwen3 with 4 slots, the cost
model pinned, stragglers off and both engines on a scripted clock
(``torch_port_engine``), each setting must give the reference's token
streams, stage list, counters and ``summary()``:

* ``ArrivalQueueScheduler`` arrivals on the paged layout with mixed steps,
  with alternating stages, and on the dense layout;
* the ``PrefillFirst``, ``DecodeFirst``, ``BalancedLagrangian``,
  ``Amortized``, ``UtilizationWeighted`` and ``DynamicBatch`` policies on
  the paged mixed layout, and ``BalancedLagrangian`` and ``DynamicBatch``
  on the dense one.

One engine of each package serves every setting of a layout (a serve resets
the engine's per-serve state)."""
import pytest

from torch_port_engine import (
    ALTERNATING,
    DENSE,
    PAGED,
    PORT,
    REF,
    arrivals,
    assert_same,
    engine,
    fcfs,
    gsm8k,
    serve_both,
)

LAYOUTS = {"paged": PAGED, "alternating": ALTERNATING, "dense": DENSE}
PAGED_POLICIES = ("PrefillFirstPolicy", "DecodeFirstPolicy", "BalancedLagrangianPolicy",
                  "AmortizedPolicy", "UtilizationWeightedPolicy", "DynamicBatchPolicy")
DENSE_POLICIES = ("BalancedLagrangianPolicy", "DynamicBatchPolicy")
# two requests every 4 stage times of the scripted clock (2**-10 s a stage),
# so the queue empties and refills while slots decode
ARRIVAL_GAP = 4 * 2.0 ** -10

_engines = {}


def engines(layout):
    if layout not in _engines:
        _engines[layout] = (engine(REF, LAYOUTS[layout]), engine(PORT, LAYOUTS[layout]))
    return _engines[layout]


def arriving(pkg):
    reqs = gsm8k(pkg, seed=7)
    for i, r in enumerate(reqs):
        r.arrival = (i // 2) * ARRIVAL_GAP
    return reqs


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_arrivals_give_the_reference_serve(layout):
    port, ref, eng = serve_both(arriving, arrivals, engines=engines(layout))
    assert_same(port, ref)
    # the queue ran dry at least once: requests were admitted after t = 0
    assert port["summary"]["makespan_s"] > max(r.arrival for r in arriving(PORT))


@pytest.mark.parametrize("policy", PAGED_POLICIES)
def test_paged_policy_gives_the_reference_serve(policy):
    port, ref, _ = serve_both(gsm8k, lambda pkg, reqs: fcfs(pkg, reqs, policy),
                              engines=engines("paged"))
    assert_same(port, ref)


@pytest.mark.parametrize("policy", DENSE_POLICIES)
def test_dense_policy_gives_the_reference_serve(policy):
    port, ref, _ = serve_both(gsm8k, lambda pkg, reqs: fcfs(pkg, reqs, policy),
                              engines=engines("dense"))
    assert_same(port, ref)


def test_policies_schedule_differently():
    """Where two policies are different schedules on this workload, the
    comparisons above would notice one served as the other: prefill-first
    and decode-first on the paged layout, prefill-first and the balanced
    Lagrangian rule on the dense one. (Under the pinned cost model the
    other paged policies give prefill-first's schedule, in both packages:
    mixed steps run the chunks inside the decode rounds.)"""
    def schedule(layout, policy):
        port, ref, _ = serve_both(gsm8k, lambda pkg, reqs: fcfs(pkg, reqs, policy),
                                  engines=engines(layout))
        assert_same(port, ref)
        return [(s["kind"], s["tokens"]) for s in port["stages"]]

    assert schedule("paged", "PrefillFirstPolicy") != schedule("paged", "DecodeFirstPolicy")
    assert schedule("dense", "PrefillFirstPolicy") != schedule("dense", "BalancedLagrangianPolicy")
