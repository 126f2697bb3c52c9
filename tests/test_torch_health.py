"""Port parity, failure detection: the port's ``ReplicaHealthMonitor``
against the reference's on the same seeded beat sequences (states, events,
transitions and ``state_dict``), and the reference's monitor unit cases run
against the port alone. No model, no fleet, no wall clock."""
import numpy as np
import pytest

from repro.serving.health import HealthConfig as RefHealthConfig
from repro.serving.health import ReplicaHealthMonitor as RefMonitor
from repro_torch.serving.fleet import ReplicaFault
from repro_torch.serving.health import (
    ALIVE,
    CONDEMNED,
    SUSPECT,
    HealthConfig,
    ReplicaHealthMonitor,
)


def _script(seed, n_replicas, n_events=300):
    """A seeded beat sequence: each replica beats at its own cadence (some
    stall, some degrade x4 for a while), with stage durations against
    predictions, and the fleet evaluates between beats."""
    rng = np.random.default_rng(seed)
    cadence = rng.uniform(0.005, 0.03, size=n_replicas)
    stall = {int(rng.integers(0, n_replicas)): (float(rng.uniform(0.5, 2.0)), float(rng.uniform(2.5, 4.0)))}
    slow = {int(rng.integers(0, n_replicas)): (float(rng.uniform(0.5, 1.5)), float(rng.uniform(2.0, 3.0)))}
    nxt = rng.uniform(0.0, 0.01, size=n_replicas)
    events = []
    for _ in range(n_events):
        i = int(np.argmin(nxt))
        t = float(nxt[i])
        lo, hi = stall.get(i, (np.inf, np.inf))
        if lo <= t < hi:
            nxt[i] = hi                      # silence: no beat in the window
            events.append(("evaluate", t))
            continue
        pred = float(cadence[i])
        a, b = slow.get(i, (np.inf, np.inf))
        dur = pred * (4.0 if a <= t < b else 1.0) * float(rng.uniform(0.9, 1.1))
        if rng.random() < 0.2:
            events.append(("beat", i, t, None, None, 0))     # bare liveness beat
        else:
            events.append(("beat", i, t, dur, pred, int(t > 2.8)))
        events.append(("evaluate", t))
        nxt[i] = t + dur
    return events


def _play(monitor, events):
    states, newly = [], []
    for ev in events:
        if ev[0] == "beat":
            _, i, t, dur, pred, version = ev
            monitor.beat(i, t, duration_s=dur, predicted_s=pred, model_version=version)
        else:
            newly.append(monitor.evaluate(ev[1]))
        states.append([monitor.state(i) for i in range(monitor.n_replicas)])
    return states, newly


@pytest.mark.parametrize("detector", ["adaptive", "fixed"])
@pytest.mark.parametrize("seed", range(4))
def test_monitor_matches_the_reference(seed, detector):
    n = 2 + seed % 3
    events = _script(seed, n)
    kw = dict(detector=detector, fixed_timeout_s=0.2, baseline_beats=4, degraded_window=4)
    ref, mon = RefMonitor(n, RefHealthConfig(**kw)), ReplicaHealthMonitor(n, HealthConfig(**kw))
    assert _play(mon, events) == _play(ref, events)
    for key in ("suspect_events", "false_suspicions", "condemned_events", "degraded_events"):
        assert getattr(mon, key) == getattr(ref, key)
    assert mon.transitions == ref.transitions
    assert mon.state_dict() == ref.state_dict()
    # the script exercised the state machine
    assert mon.suspect_events > 0


def test_monitor_state_dict_loads_across_packages():
    events = _script(7, 3)
    ref = RefMonitor(3, RefHealthConfig())
    _play(ref, events)
    mon = ReplicaHealthMonitor(3, HealthConfig())
    mon.load_state_dict(ref.state_dict())
    assert mon.state_dict() == ref.state_dict()
    tail = [("evaluate", 10.0), ("beat", 0, 10.01, 0.01, 0.01, 1), ("evaluate", 10.5)]
    assert _play(mon, tail) == _play(ref, tail)
    assert mon.state_dict() == ref.state_dict()


# --------------------------------------------------------------------------- #
# The reference's monitor unit cases, against the port                        #
# --------------------------------------------------------------------------- #
def _beaten_monitor(cfg=None, cadence=0.01, n=10):
    mon = ReplicaHealthMonitor(2, cfg or HealthConfig())
    for k in range(n):
        mon.beat(0, k * cadence)
        mon.beat(1, k * cadence)
    return mon


def test_silence_escalates_suspect_then_condemned():
    mon = _beaten_monitor()
    t0 = 9 * 0.01
    assert mon.evaluate(t0 + 0.01) == []
    assert mon.state(0) == ALIVE
    newly = []
    t = t0
    while not newly and t < t0 + 10.0:
        t += 0.01
        mon.beat(1, t)
        newly = mon.evaluate(t)
    assert newly == [0]
    assert mon.state(0) == CONDEMNED
    assert mon.state(1) == ALIVE
    assert mon.suspect_events == 1 and mon.condemned_events == 1
    assert mon.evaluate(t + 1.0, replicas=[0]) == []
    mon.beat(0, t + 1.0)
    assert mon.state(0) == CONDEMNED
    states = [tr["state"] for tr in mon.transitions if tr["replica"] == 0]
    assert states == [SUSPECT, CONDEMNED]


def test_condemnation_gated_on_warmup_beats():
    mon = ReplicaHealthMonitor(1, HealthConfig(warmup_beats=4))
    mon.beat(0, 0.0)
    mon.evaluate(100.0)
    assert mon.state(0) == SUSPECT
    assert mon.condemned_events == 0


def test_beat_clears_suspicion_and_counts_false_positive():
    mon = _beaten_monitor()
    t = 9 * 0.01
    while mon.state(0) != SUSPECT:
        t += 0.01
        mon.beat(1, t)
        mon.evaluate(t)
    assert mon.state(0) != CONDEMNED
    mon.beat(0, t)
    assert mon.state(0) == ALIVE
    assert mon.false_suspicions == 1
    assert mon.replicas[0].suspect_since is None


def test_fixed_detector_scores_silence_against_timeout():
    cfg = HealthConfig(detector="fixed", fixed_timeout_s=0.1, condemn_factor=2.0, warmup_beats=1)
    mon = ReplicaHealthMonitor(1, cfg)
    mon.beat(0, 0.0)
    assert mon.suspicion(0, 0.05) == pytest.approx(0.5)
    mon.evaluate(0.05)
    assert mon.state(0) == ALIVE
    mon.evaluate(0.11)
    assert mon.state(0) == SUSPECT
    mon.evaluate(0.21)
    assert mon.state(0) == CONDEMNED


def test_same_instant_beats_do_not_collapse_gap_stats():
    mon = ReplicaHealthMonitor(1, HealthConfig())
    mon.beat(0, 0.0)
    for _ in range(50):
        mon.beat(0, 0.01)
    assert mon.replicas[0].gaps == [0.01]
    assert mon.evaluate(0.02) == []
    assert mon.state(0) == ALIVE


def test_degraded_flagged_and_recovers():
    cfg = HealthConfig(baseline_beats=4, degraded_window=4)
    mon = ReplicaHealthMonitor(1, cfg)
    t = 0.0
    for _ in range(cfg.baseline_beats):
        t += 0.01
        mon.beat(0, t, duration_s=0.01, predicted_s=0.01)
    assert mon.replicas[0].slowdown_baseline == pytest.approx(1.0)
    for _ in range(cfg.degraded_window):
        t += 0.04
        mon.beat(0, t, duration_s=0.04, predicted_s=0.01)
    assert mon.replicas[0].degraded
    assert mon.state(0) == SUSPECT
    assert mon.replicas[0].suspect_reason == "degraded"
    assert mon.degraded_events == 1
    assert not mon.is_healthy(0)
    for _ in range(cfg.degraded_window):
        t += 0.01
        mon.beat(0, t, duration_s=0.01, predicted_s=0.01)
    assert not mon.replicas[0].degraded
    assert mon.state(0) == ALIVE
    assert mon.false_suspicions == 1


def test_degraded_needs_full_window_not_one_spike():
    cfg = HealthConfig(baseline_beats=4, degraded_window=4)
    mon = ReplicaHealthMonitor(1, cfg)
    t = 0.0
    for _ in range(cfg.baseline_beats):
        t += 0.01
        mon.beat(0, t, duration_s=0.01, predicted_s=0.01)
    mon.beat(0, t + 0.5, duration_s=0.5, predicted_s=0.01)
    t += 0.5
    for _ in range(3):
        t += 0.01
        mon.beat(0, t, duration_s=0.01, predicted_s=0.01)
    assert not mon.replicas[0].degraded
    assert mon.state(0) == ALIVE


def test_model_version_change_recaptures_baseline():
    cfg = HealthConfig(baseline_beats=4, degraded_window=4)
    mon = ReplicaHealthMonitor(1, cfg)
    t = 0.0
    for _ in range(cfg.baseline_beats):
        t += 0.01
        mon.beat(0, t, duration_s=0.01, predicted_s=0.01, model_version=0)
    assert mon.replicas[0].slowdown_baseline == pytest.approx(1.0)
    for _ in range(cfg.baseline_beats + cfg.degraded_window):
        t += 0.01
        mon.beat(0, t, duration_s=0.04, predicted_s=0.01, model_version=1)
    assert mon.replicas[0].slowdown_baseline == pytest.approx(4.0)
    assert not mon.replicas[0].degraded
    assert mon.state(0) == ALIVE


def test_health_config_validation():
    with pytest.raises(ValueError):
        HealthConfig(detector="psychic")
    with pytest.raises(ValueError):
        HealthConfig(suspect_sigma=8.0, condemn_sigma=8.0)
    with pytest.raises(ValueError):
        HealthConfig(fixed_timeout_s=0.0)
    with pytest.raises(ValueError):
        HealthConfig(degraded_factor=1.0)


def test_monitor_state_dict_round_trips_suspicion():
    mon = _beaten_monitor()
    t = 9 * 0.01
    while mon.state(0) != SUSPECT:
        t += 0.01
        mon.beat(1, t)
        mon.evaluate(t)
    blob = mon.state_dict()
    mon2 = ReplicaHealthMonitor(2, HealthConfig())
    mon2.load_state_dict(blob)
    assert mon2.state(0) == SUSPECT
    assert mon2.replicas[0].suspect_since == mon.replicas[0].suspect_since
    assert mon2.replicas[0].gaps == mon.replicas[0].gaps
    assert mon2.suspect_events == mon.suspect_events
    assert mon2.transitions == mon.transitions
    with pytest.raises(ValueError):
        ReplicaHealthMonitor(3, HealthConfig()).load_state_dict(blob)


def test_hang_fault_validation():
    with pytest.raises(ValueError):
        ReplicaFault(replica=0, at_s=1.0, kind="hang")
    with pytest.raises(ValueError):
        ReplicaFault(replica=0, at_s=1.0, kind="hang", until_s=0.5)
    with pytest.raises(ValueError):
        ReplicaFault(replica=0, at_s=1.0, kind="degrade", speed_factor=0.0)
