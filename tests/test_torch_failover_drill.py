"""Port parity: `chaos.master_failover` on the CPU with GPT nano.

The primary master is SIGKILLed mid-shard under a training worker; the
warm standby promotes fenced, the worker never restarts, and every loss
is bitwise an uninterrupted run's (the JAX drill's invariants,
dlrover_wuqiong_tpu/chaos.py `master_failover`).  A file of its own so
that the standby's parity cases and this drill each stay well inside a
minute alone.
"""

import pytest
from torch_threads import one_torch_thread  # noqa: F401

#: torch threads of a drill's processes on the CPU.  Under a parallel
#: test run (several xdist workers on a few cores) a drill's trainer at
#: torch's default (one OpenMP thread a core, spinning while it waits)
#: in the test process and in its worker subprocess oversubscribes the
#: cores so far that a nano drill of ~25 s ran for minutes.  The
#: reference and the worker both take this count, so their losses stay
#: bitwise equal.
DRILL_THREADS = 2


@pytest.fixture
def few_threads(monkeypatch):
    """`DRILL_THREADS` torch threads here and in every subprocess the
    test starts; OpenMP threads that sleep rather than spin."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(DRILL_THREADS)
    monkeypatch.setenv("OMP_NUM_THREADS", str(DRILL_THREADS))
    monkeypatch.setenv("OMP_WAIT_POLICY", "PASSIVE")
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_master_failover_drill_at_nano_on_cpu(few_threads):
    from dlrover_wuqiong_tpu_torch import chaos

    r = chaos.master_failover(model="nano", device="cpu")
    assert r["ok"], {k: v for k, v in r.items() if k != "degraded"}
    assert r["losses_bitwise"] and r["steps"] == 144
    assert r["worker_generations"] == 1 and r["cli_rc"] == 0
    assert r["client_failovers"] >= 1 and r["epoch_fenced"]
    assert r["promoted_epoch"] == r["pre_kill"]["epoch"] + 2 == 3
    assert r["promotion_gap_s"] < r["restart_the_world_s"]
    assert r["corpse_fenced"] and r["corpse_mutation_refused"]
    assert r["timeline_byte_equal"] and "failover" in \
        r["timeline_incidents"]
    assert r["standby"]["frames_folded"] > 0
    assert r["goodput_wall"] <= 1.0
    assert sum(r["launches"].values()) == 0  # the CPU runs plain versions
