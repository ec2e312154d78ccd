"""The port's copy of the fault-tolerance policy (`repro_torch.runtime`)
against the JAX package's on the same inputs: heartbeats, stragglers, the
restart budget and elastic mesh shapes (tests/test_fault_tolerance.py
without its trainer case: the trainer is ROADMAP queue 1 item 11)."""
import pytest

from repro import runtime as jruntime
from repro_torch import runtime


@pytest.mark.parametrize("lib", [runtime, jruntime], ids=["port", "reference"])
def test_heartbeat_liveness(lib):
    hb = lib.HeartbeatMonitor(n_hosts=4, timeout_s=10)
    for h in range(3):
        hb.beat(h, now=100.0)
    assert hb.alive(now=105.0) == [0, 1, 2]
    assert hb.dead(now=105.0) == [3]
    assert hb.alive(now=120.0) == []


def test_straggler_detection_equals_reference():
    ours = runtime.StragglerDetector(n_hosts=4, ratio=1.5, min_samples=3)
    theirs = jruntime.StragglerDetector(n_hosts=4, ratio=1.5, min_samples=3)
    for step in range(6):
        for h in range(4):
            t = 1.0 + 0.01 * step if h != 2 else 3.0
            ours.record(h, t)
            theirs.record(h, t)
        assert ours.stragglers() == theirs.stragglers()
        assert ours.median() == theirs.median()
    assert ours.stragglers() == [2]
    assert 0.9 < ours.median() < 1.1


def test_restart_policy_budget():
    rp = runtime.RestartPolicy(max_restarts=3, backoff_base_s=1.0)
    delays = [rp.on_failure() for _ in range(3)]
    assert delays == [1.0, 2.0, 4.0]
    with pytest.raises(RuntimeError, match="restart budget exhausted"):
        rp.on_failure()
    rp.on_success_window()
    assert rp.on_failure() == 4.0  # forgiveness freed one slot
    capped = runtime.RestartPolicy(max_restarts=20, backoff_base_s=1.0, backoff_cap_s=5.0)
    assert [capped.on_failure() for _ in range(5)] == [1.0, 2.0, 4.0, 5.0, 5.0]


@pytest.mark.parametrize("hosts,chips,tp,pod", [(128, 4, 16, 256), (64, 4, 16, 256),
                                                (60, 4, 16, 256), (2, 4, 16, 256),
                                                (300, 8, 8, 512), (3, 1, 1, 2)])
def test_elastic_mesh_shape_equals_reference(hosts, chips, tp, pod):
    got = runtime.elastic_mesh_shape(hosts, chips, model_parallel=tp, pod_size_chips=pod)
    assert got == jruntime.elastic_mesh_shape(hosts, chips, model_parallel=tp,
                                              pod_size_chips=pod)


def test_elastic_mesh_shape_cases():
    assert runtime.elastic_mesh_shape(128, 4, model_parallel=16) == (2, 16, 16)
    assert runtime.elastic_mesh_shape(64, 4, model_parallel=16) == (16, 16)
    assert runtime.elastic_mesh_shape(60, 4, model_parallel=16) == (15, 16)
    assert runtime.elastic_mesh_shape(2, 4, model_parallel=16) == ()
