"""Port parity: the master-backed serving worker and its control plane.

Held against the JAX package on the CPU, every comparison exact:

- wire: for each ported message, the port's frame (`serialize.dumps`) is
  byte-equal to JAX's on the same field values, each side loads the
  other's frame, and the port's fields equal
  `dlrover_wuqiong_tpu/analysis/schema.lock.json` (read as a file);
- `ServeQueueManager`: each `tests/test_serving.py` TestServeQueueManager
  sequence, run on both queues, gives the same answers, `summary()` and
  `export_state()`;
- RPC: the port's master answers a JAX `RpcClient`, and the port's
  `MasterClient` drives a JAX master; a retried lease with the same idem
  key gets the same requests; a dead master raises
  `MasterUnreachableError` within a small grace; the buffered stats verb
  parks its frame and flushes it after the master comes up;
- the worker (``device="cpu"``, GPT nano) against the port's master:
  greedy tokens equal JAX's `LocalServer` tokens on the same weights
  (through `convert`), with ``quant=""`` and ``"int8"``; sampled tokens
  equal the port's alone-decode at the JAX drill's geometry (3 slots, 4
  fused tokens), bitwise;
- a deterministic in-process drain: generation 1 runs a fixed number of
  loop turns and is abandoned holding leases, `NodeFailure` requeues
  them, generation 2 drains: zero dropped, requeues attributed, results
  bitwise an alone-decode's, and one complete trace tree per request
  from the flight dumps.

The SIGKILL drill with worker subprocesses runs on the card, in
chip_smoke.py (phase 6b); `python -m dlrover_wuqiong_tpu_torch.chaos
serve-drain --device cpu` runs it here by hand.
"""

import dataclasses
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_wuqiong_tpu.common import comm as jcomm
from dlrover_wuqiong_tpu.common import messages as jmsg
from dlrover_wuqiong_tpu.common import serialize as jser
from dlrover_wuqiong_tpu.common.global_context import Context as JaxContext
from dlrover_wuqiong_tpu.master.serve_queue import (
    ServeQueueManager as JaxServeQueueManager,
)
from dlrover_wuqiong_tpu.models.gpt import GPT as JaxGPT
from dlrover_wuqiong_tpu.models.gpt import GPTConfig as JaxGPTConfig
from dlrover_wuqiong_tpu.serving import LocalServer as JaxLocalServer
from dlrover_wuqiong_tpu.serving import ServeSpec as JaxServeSpec
from dlrover_wuqiong_tpu.serving import ServingEngine as JaxServingEngine
from dlrover_wuqiong_tpu.telemetry import recorder as jrec
from dlrover_wuqiong_tpu.telemetry import spans as jspans
from dlrover_wuqiong_tpu_torch import chaos
from dlrover_wuqiong_tpu_torch.agent.master_client import MasterClient
from dlrover_wuqiong_tpu_torch.common import comm as tcomm
from dlrover_wuqiong_tpu_torch.common import messages as tmsg
from dlrover_wuqiong_tpu_torch.common import serialize as tser
from dlrover_wuqiong_tpu_torch.common.global_context import get_context
from dlrover_wuqiong_tpu_torch.convert import params_from_jax
from dlrover_wuqiong_tpu_torch.master.master import JobMaster
from dlrover_wuqiong_tpu_torch.master.serve_queue import ServeQueueManager
from dlrover_wuqiong_tpu_torch.master.servicer import MasterServicer
from dlrover_wuqiong_tpu_torch.models.gpt import GPTConfig, init_params
from dlrover_wuqiong_tpu_torch.serving import (
    ServeSpec,
    ServingEngine,
    ServingWorker,
)
from dlrover_wuqiong_tpu_torch.telemetry import recorder as trec
from dlrover_wuqiong_tpu_torch.telemetry import spans as tspans
from dlrover_wuqiong_tpu_torch.telemetry.serving import ServeLedger
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK = os.path.join(REPO, "dlrover_wuqiong_tpu", "analysis",
                    "schema.lock.json")

PORTED = ("OkResponse", "NodeMeta", "NodeFailure", "ServeRequest",
          "ServeSubmitRequest", "ServeSubmitAck", "ServeLeaseRequest",
          "ServeLease", "ServeResult", "ServeResultReport",
          "ServeResultQuery", "ServeResultResponse", "ServeStatsReport",
          "ServeStatsQuery", "ServeSummary")

#: the elastic trainer's records, which share the registry (their frames
#: are held against JAX's in tests/test_torch_elastic.py)
ELASTIC_PORTED = (
    "JoinRendezvousRequest", "CommWorldRequest", "RendezvousState",
    "WaitingNodeNumRequest", "WaitingNodeNumResponse", "HeartBeat",
    "HeartbeatResponse", "NodeEventReport", "GlobalStep", "ModelInfo",
    "CustomMetric", "GoodputLedgerReport", "GoodputQuery", "GoodputSummary",
    "KVStoreSetRequest", "KVStoreGetRequest", "KVStoreMultiGetRequest",
    "KVStoreAddRequest", "KVStoreResponse")

#: the dataset-sharding and journal records (their frames are held
#: against JAX's in tests/test_torch_master_restart.py)
SHARDING_PORTED = (
    "DatasetShardParams", "ShardConfig", "TaskRequest", "Task", "TaskResult",
    "ShardCheckpointRequest", "ShardCheckpoint", "JournalStatsQuery",
    "JournalStats")

#: the journal-shipping and timeline records (their frames are held
#: against JAX's in tests/test_torch_standby.py)
STANDBY_PORTED = ("FetchJournalRequest", "FetchJournalResponse",
                  "TimelineQuery", "TimelineResponse")

#: a short grace for every client that may dial a dead master (the
#: default, 120 s, would park a test for two minutes)
GRACE_S = 0.5


@pytest.fixture
def master():
    m = JobMaster(port=0, host="127.0.0.1")
    m.start()
    yield m
    m.stop()


@pytest.fixture
def client(master):
    c = MasterClient(master.addr, node_id=1, node_type="serve-worker",
                     outage_grace_s=GRACE_S)
    yield c
    c.close()


# ------------------------------------------------------------------ wire


def _sample(mod, name: str, depth: int = 0):
    """An instance of message `name` from `mod` with every field set away
    from its default (nested messages included)."""
    cls = getattr(mod, name)
    kw = {}
    for i, f in enumerate(dataclasses.fields(cls)):
        t = str(f.type)
        if t == "str":
            kw[f.name] = f"{f.name}-{i}"
        elif t == "bool":
            kw[f.name] = False
        elif t == "int":
            kw[f.name] = 7 + i
        elif t == "float":
            kw[f.name] = 0.25 + i
        elif t == "List[int]":
            kw[f.name] = [3, 1, 4 + i]
        elif t == "List[str]":
            kw[f.name] = ["a", f"b{i}"]
        elif t == "Dict[str, int]":
            kw[f.name] = {"finished": 3 + i, "requeued": 1}
        elif t == "Dict[str, float]":
            kw[f.name] = {"decode": 1.5 + i, "idle": 0.125}
        elif t.startswith("List[") and depth == 0:
            kw[f.name] = [_sample(mod, t[5:-1], depth + 1)
                          for _ in range(2)]
        else:
            raise AssertionError(f"{name}.{f.name}: no sample for {t}")
    return cls(**kw)


@pytest.mark.parametrize("name", PORTED)
def test_frames_byte_equal_and_cross_load(name):
    """The port's frame of each message is JAX's, byte for byte, and each
    side decodes the other's frame into its own class, field for field."""
    jobj, tobj = _sample(jmsg, name), _sample(tmsg, name)
    jframe, tframe = jser.dumps(jobj), tser.dumps(tobj)
    assert tframe == jframe
    back_t = tser.loads(jframe)
    back_j = jser.loads(tframe)
    assert type(back_t) is getattr(tmsg, name)
    assert type(back_j) is getattr(jmsg, name)
    assert back_t == tobj and back_j == jobj
    # defaults too
    assert tser.dumps(getattr(tmsg, name)()) == \
        jser.dumps(getattr(jmsg, name)())


def _lock_fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        if f.default_factory is not dataclasses.MISSING:
            default = f"factory:{f.default_factory.__name__}"
        else:
            default = repr(f.default)
        out.append({"default": default, "name": f.name})
    return out


@pytest.mark.parametrize("name", PORTED)
def test_fields_equal_schema_lock(name):
    """Names, order and defaults of each ported message equal the JAX
    package's committed wire surface, and its dataclass's annotations."""
    with open(LOCK) as f:
        lock = json.load(f)["messages"][name]["fields"]
    cls = getattr(tmsg, name)
    assert _lock_fields(cls) == [{"default": e["default"], "name": e["name"]}
                                 for e in lock]
    assert [(f.name, str(f.type)) for f in dataclasses.fields(cls)] == \
        [(f.name, str(f.type))
         for f in dataclasses.fields(getattr(jmsg, name))]


def test_registry_holds_only_ported_messages_under_jax_names():
    assert set(tser._MESSAGE_REGISTRY) == \
        set(PORTED) | set(ELASTIC_PORTED) | set(SHARDING_PORTED) \
        | set(STANDBY_PORTED)  # noqa: SLF001
    for name, cls in tser._MESSAGE_REGISTRY.items():  # noqa: SLF001
        assert cls.__name__ == name
        assert name in jser._MESSAGE_REGISTRY  # noqa: SLF001


def test_wire_constants_equal_jax():
    assert tcomm._LEN.format == jcomm._LEN.format  # noqa: SLF001
    assert tcomm.MAX_FRAME == jcomm.MAX_FRAME
    assert tcomm.TRANSPORT_ERRORS == jcomm.TRANSPORT_ERRORS
    assert get_context().master_outage_grace_s == \
        JaxContext().master_outage_grace_s


# ------------------------------------------------------------ serve queue


def _req(m, rid):
    return m.ServeRequest(request_id=rid, prompt=[1, 2, 3],
                          max_new_tokens=4, seed=0)


def _res(m, rid, tokens=(7, 8, 9, 10)):
    return m.ServeResult(request_id=rid, tokens=list(tokens),
                         latency_s=0.5, ttft_s=0.1)


def _ids(reqs):
    return [r.request_id for r in reqs]


def _submit_dedupes_pending_and_done(q, m):
    out = [q.submit([_req(m, "a"), _req(m, "b"), _req(m, "a")]),
           q.submit([_req(m, "a")])]
    q.lease(1, 2)
    q.complete([_res(m, "a")])
    out.append(q.submit([_req(m, "a")]))
    return out


def _lease_is_fifo(q, m):
    q.submit([_req(m, f"r{i}") for i in range(4)])
    return [_ids(q.lease(1, 2)), _ids(q.lease(2, 9)), _ids(q.lease(3, 1))]


def _recover_requeues_to_front_in_order(q, m):
    q.submit([_req(m, f"r{i}") for i in range(4)])
    q.lease(1, 2)
    return [q.recover_node(1), _ids(q.lease(2, 4)), q.recover_node(99)]


def _complete_is_idempotent(q, m):
    q.submit([_req(m, "a")])
    q.lease(1, 1)
    return [q.complete([_res(m, "a")]), q.complete([_res(m, "a")])]


def _lease_exact_replays_assignment(q, m):
    q.submit([_req(m, "a"), _req(m, "b")])
    q.lease_exact(7, ["b"])
    out = [_ids(q.lease(1, 5)), q.summary().leased, q.recover_node(7)]
    return out + [_ids(q.lease(2, 5))]


def _summary_attributes_requeues_master_side(q, m):
    q.submit([_req(m, "a"), _req(m, "b")])
    q.lease(1, 2)
    return [q.recover_node(1)]


def _take_results_pops_and_counts_pending(q, m):
    q.submit([_req(m, "a"), _req(m, "b")])
    q.lease(1, 2)
    q.complete([_res(m, "a")])
    results, pending = q.take_results(["a", "b"])
    again, pending2 = q.take_results(["a", "b"])
    return [_ids(results), pending, _ids(again), pending2]


def _collect_stats_latest_sent_wins(q, m):
    q.collect_stats(m.ServeStatsReport(
        node_id=1, counters={"finished": 9}, sent_at=200.0, wall_s=2.0,
        states={"decode": 1.0}, p99_ms=5.0))
    q.collect_stats(m.ServeStatsReport(  # stale BUFFERED drain
        node_id=1, counters={"finished": 3}, sent_at=100.0))
    q.collect_stats(m.ServeStatsReport(
        node_id=2, counters={"finished": 1, "requeued": 2}, sent_at=1.0,
        wall_s=4.0, active_slots=3, ttft_p50_ms=2.5))
    return []


SEQUENCES = [_submit_dedupes_pending_and_done, _lease_is_fifo,
             _recover_requeues_to_front_in_order, _complete_is_idempotent,
             _lease_exact_replays_assignment,
             _summary_attributes_requeues_master_side,
             _take_results_pops_and_counts_pending,
             _collect_stats_latest_sent_wins]


def _plain(x):
    """Dataclasses (of either package) as dicts, for comparing state."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"__msg__": type(x).__name__, **{
            f.name: _plain(getattr(x, f.name))
            for f in dataclasses.fields(x)}}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("seq", SEQUENCES, ids=lambda f: f.__name__[1:])
def test_serve_queue_matches_jax(seq):
    """The same operations on both queues give the same answers, summary
    and exported state (tests/test_serving.py TestServeQueueManager)."""
    jq, tq = JaxServeQueueManager(), ServeQueueManager()
    assert _plain(seq(tq, tmsg)) == _plain(seq(jq, jmsg))
    assert _plain(tq.summary()) == _plain(jq.summary())
    assert _plain(tq.export_state()) == _plain(jq.export_state())
    # and a queue restored from JAX's exported state answers the same
    tq2 = ServeQueueManager()
    tq2.restore_state(tser.loads(jser.dumps(jq.export_state())))
    assert _plain(tq2.export_state()) == _plain(jq.export_state())


# -------------------------------------------------------------------- rpc


def test_port_master_answers_jax_client(master):
    """A JAX RpcClient's frames go through the port's master: submit,
    lease, results, stats and summary, each answer decoded into JAX's
    classes; a verb the port does not answer comes back as an RpcError."""
    jc = jcomm.RpcClient(master.addr, node_id=5, node_type="chaos")
    try:
        reqs = [jmsg.ServeRequest(request_id=f"j{i}", prompt=[i + 1],
                                  max_new_tokens=3, seed=i)
                for i in range(3)]
        ack = jc.report(jmsg.ServeSubmitRequest(node_id=5, requests=reqs),
                        idem="jax-submit-1")
        assert isinstance(ack, jmsg.ServeSubmitAck)
        assert (ack.accepted, ack.queue_depth) == (3, 3)
        lease = jc.get(jmsg.ServeLeaseRequest(node_id=5, max_requests=2),
                       idem="jax-lease-1")
        assert isinstance(lease, jmsg.ServeLease)
        assert lease.requests == reqs[:2]
        ok = jc.report(jmsg.ServeResultReport(node_id=5, results=[
            jmsg.ServeResult(request_id="j0", tokens=[4, 5, 6])]))
        assert isinstance(ok, jmsg.OkResponse) and ok.success
        jc.report(jmsg.ServeStatsReport(node_id=5, counters={"finished": 1},
                                        sent_at=1.0))
        got = jc.get(jmsg.ServeResultQuery(request_ids=["j0", "j1"]))
        assert isinstance(got, jmsg.ServeResultResponse)
        assert [r.tokens for r in got.results] == [[4, 5, 6]]
        assert got.pending == 1
        summ = jc.get(jmsg.ServeStatsQuery())
        assert isinstance(summ, jmsg.ServeSummary)
        assert (summ.queue_depth, summ.leased, summ.done_total,
                summ.workers) == (1, 1, 1, 1)
        assert jc.epoch == 1
        with pytest.raises(jcomm.RpcError, match="PerfQuery"):
            jc.get(jmsg.PerfQuery())
    finally:
        jc.close()


def test_port_client_drives_jax_master():
    """The port's MasterClient runs the worker's verbs against a JAX
    master: register, submit, lease, results, stats, summary, failure."""
    from dlrover_wuqiong_tpu.master.master import JobMaster as JaxJobMaster

    jm = JaxJobMaster(port=0)
    jm.prepare()
    c = MasterClient(f"127.0.0.1:{jm.port}", node_id=3,
                     node_type="serve-worker", outage_grace_s=GRACE_S)
    try:
        assert c.register_node(node_rank=3).success
        reqs = [tmsg.ServeRequest(request_id=f"t{i}", prompt=[i + 1],
                                  max_new_tokens=2, seed=i)
                for i in range(3)]
        assert c.submit_serve_requests(reqs).accepted == 3
        leased = c.lease_serve_requests(max_requests=2)
        assert leased == reqs[:2]
        assert all(type(r) is tmsg.ServeRequest for r in leased)
        c.report_serve_results([tmsg.ServeResult(request_id="t0",
                                                 tokens=[1, 2])])
        c.report_serve_stats(ServeLedger().snapshot(), active_slots=1)
        assert c.report_failure("test", level="process").success
        summ = c.get_serve_summary()
        assert isinstance(summ, tmsg.ServeSummary)
        # t1 was leased by node 3 and requeued by its failure
        assert (summ.done_total, summ.requeued_total, summ.queue_depth,
                summ.workers) == (1, 1, 2, 1)
        got = c.get_serve_results(["t0"])
        assert [r.tokens for r in got.results] == [[1, 2]]
        assert c.epoch == jm.epoch
    finally:
        c.close()
        jm.stop()


def test_retried_lease_with_same_idem_returns_same_requests(master):
    reqs = [tmsg.ServeRequest(request_id=f"r{i}", prompt=[1])
            for i in range(4)]
    master.serve_queue.submit(reqs)
    rc = tcomm.RpcClient(master.addr, node_id=1)
    try:
        payload = tmsg.ServeLeaseRequest(node_id=1, max_requests=2)
        first = rc.get(payload, idem="w1:lease:1")
        retry = rc.get(payload, idem="w1:lease:1")
        fresh = rc.get(payload, idem="w1:lease:2")
    finally:
        rc.close()
    assert _ids(first.requests) == _ids(retry.requests) == ["r0", "r1"]
    assert _ids(fresh.requests) == ["r2", "r3"]
    assert master.serve_summary().leased == 4


def test_unreachable_master_raises_within_grace():
    port = tcomm.find_free_port()
    c = MasterClient(f"127.0.0.1:{port}", node_id=1,
                     outage_grace_s=GRACE_S)
    try:
        t0 = time.monotonic()
        with pytest.raises(tcomm.MasterUnreachableError):
            c.lease_serve_requests(max_requests=1)
        assert time.monotonic() - t0 < 10 * GRACE_S
        assert not tcomm.addr_connectable(f"127.0.0.1:{port}", 0.2)
    finally:
        c.close()


def test_buffered_stats_park_and_flush_after_reconnect():
    port = tcomm.find_free_port()
    c = MasterClient(f"127.0.0.1:{port}", node_id=4,
                     outage_grace_s=GRACE_S)
    m = None
    try:
        resp = c.report_serve_stats(ServeLedger().snapshot(),
                                    active_slots=2)
        assert isinstance(resp, tmsg.OkResponse)  # the default, no wait
        assert c.degraded_stats()["pending"] == 1
        m = JobMaster(port=port, host="127.0.0.1")
        m.start()
        assert m.serve_summary().workers == 0
        c.get_serve_summary()  # a successful verb drains the buffer
        st = c.degraded_stats()
        assert (st["pending"], st["buffered_total"],
                st["flushed_total"]) == (0, 1, 1)
        summ = m.serve_summary()
        assert summ.workers == 1 and summ.active_slots == 2
    finally:
        c.close()
        if m is not None:
            m.stop()


def test_servicer_rejects_verbs_it_does_not_answer(master):
    s = MasterServicer(master)
    for verb, payload in (("get", tmsg.OkResponse()),
                          ("report", tmsg.ServeLease())):
        with pytest.raises(ValueError, match=r"unknown (get|report) "
                           r"message: \w+ .*ROADMAP items 13 and 15"):
            s.handle(verb, 1, "worker", payload)


def test_node_registration_and_failure_reach_the_master(master, client):
    client.register_node(node_rank=1)
    node = master.job_manager.get_node(1)
    assert node.config_resource.accelerator_type == "gpu"
    master.serve_queue.submit([tmsg.ServeRequest(request_id="a")])
    client.lease_serve_requests(max_requests=1)
    assert client.report_failure("killed").success
    assert master.job_manager.error_monitor.error_class_history(1) == [
        (0, "unknown")]
    assert node.relaunch_count == 1
    summ = master.serve_summary()
    assert (summ.requeued_total, summ.queue_depth) == (1, 1)


# ---------------------------------------------------------------- tracing


def test_rpc_spans_nest_across_the_wire(master, client):
    """rpc:<verb> on the client, serve:<verb> on the master under it, in
    one trace, and both in the flight recorder."""
    tspans.clear_spans()
    trec.reset_recorder()
    with tspans.span("outer") as outer:
        client.get_serve_summary()
    recs = {r["name"]: r for r in tspans.spans_snapshot()}
    rpc, served = recs["rpc:get"], recs["serve:get"]
    assert rpc["trace_id"] == served["trace_id"] == outer["trace_id"]
    assert rpc["parent_span"] == outer["span_id"]
    assert served["parent_span"] == rpc["span_id"]
    assert rpc["attrs"]["msg"] == "ServeStatsQuery"
    assert "retry:get" in recs
    names = {e["name"] for e in trec.get_recorder().snapshot()
             if e["kind"] == "span"}
    assert {"rpc:get", "serve:get", "outer"} <= names


def test_spans_env_context_and_dump_schema_equal_jax(tmp_path):
    """The child hand-off carries the same variables as JAX's, and a
    flight dump has JAX's keys; its ledger is null until something (a
    checkpoint save) starts the goodput ledger."""
    from dlrover_wuqiong_tpu_torch.telemetry.ledger import reset_ledger

    reset_ledger()
    with tspans.span("a"):
        with tspans.env_context() as tenv:
            pass
    with jspans.span("a"):
        with jspans.env_context() as jenv:
            pass
    assert sorted(tenv) == sorted(jenv) and len(tenv) == 2
    assert tspans.current_trace() is None
    assert tspans.inject() is None
    tpath = trec.get_recorder().flush(str(tmp_path / "t"), "test")
    jpath = jrec.get_recorder().flush(str(tmp_path / "j"), "test")
    with open(tpath) as f:
        tdump = json.load(f)
    with open(jpath) as f:
        jdump = json.load(f)
    assert sorted(tdump) == sorted(jdump)
    assert tdump["schema"] == jdump["schema"]
    assert tdump["ledger"] is None and tdump["perf"] is None
    assert [d["_file"] for d in trec.load_flight_dumps(
        str(tmp_path / "t"))] == [os.path.basename(tpath)]


# ----------------------------------------------------------------- worker

GREEDY = [("g0", [1, 7, 13], 10), ("g1", [2, 9], 9),
          ("g2", [3, 4, 5, 6, 10, 11, 12, 500], 11), ("g3", [8], 7),
          ("g4", [5, 5], 8)]
WORKER = dict(max_slots=2, max_len=48, max_prompt_len=8, fused_tokens=2)


@pytest.fixture(scope="module")
def nano_f32():
    jcfg = dataclasses.replace(JaxGPTConfig.nano(), dtype=jnp.float32)
    tcfg = dataclasses.replace(GPTConfig.nano(), dtype=torch.float32)
    jparams = JaxGPT(jcfg).init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _run_worker(master, engine, ids, ckpt_dir="", timeout=120.0):
    """Run a ServingWorker (node 2) in a thread until the master holds a
    result for every id in `ids`, stop it; returns {request_id: tokens}."""
    cli = MasterClient(master.addr, node_id=2, node_type="serve-worker",
                       outage_grace_s=GRACE_S)
    sub = MasterClient(master.addr, node_id=91, node_type="chaos",
                       outage_grace_s=GRACE_S)
    worker = ServingWorker(cli, engine, ckpt_dir=ckpt_dir, stats_every=1,
                           idle_sleep_s=0.005)
    th = threading.Thread(target=worker.run, kwargs={"max_seconds": timeout})
    th.start()
    try:
        deadline = time.monotonic() + timeout
        while master.serve_summary().done_total < len(ids):
            assert time.monotonic() < deadline, "worker never drained"
            assert th.is_alive(), "worker exited early"
            time.sleep(0.01)
        worker.stop()
        th.join(timeout=30)
        assert not th.is_alive()
        got = sub.get_serve_results(list(ids))
        return {r.request_id: list(r.tokens) for r in got.results}
    finally:
        worker.stop()
        th.join(timeout=30)
        cli.close()
        sub.close()


def _submit(master, reqs):
    sub = MasterClient(master.addr, node_id=90, node_type="chaos",
                       outage_grace_s=GRACE_S)
    try:
        assert sub.submit_serve_requests(reqs).accepted == len(reqs)
    finally:
        sub.close()


@pytest.mark.parametrize("quant", ["", "int8"])
def test_worker_greedy_tokens_match_jax_local_server(master, nano_f32,
                                                     quant):
    jcfg, jparams, tcfg, tparams = nano_f32
    spec = dict(WORKER, quant=quant)
    jsrv = JaxLocalServer(JaxServingEngine(jcfg, jparams,
                                           JaxServeSpec(**spec)))
    for rid, prompt, n in GREEDY:
        jsrv.submit(rid, prompt, max_new_tokens=n, seed=0, temperature=0.0)
    want = jsrv.drain()
    engine = ServingEngine(tcfg, tparams, ServeSpec(**spec), device="cpu")
    reqs = [tmsg.ServeRequest(request_id=rid, prompt=prompt,
                              max_new_tokens=n, temperature=0.0)
            for rid, prompt, n in GREEDY]
    _submit(master, reqs)
    got = _run_worker(master, engine, _ids(reqs))
    assert got == want
    assert all(len(got[rid]) == n for rid, _, n in GREEDY)


def _drill_engine(spec):
    """The drill workers' model (serving/__main__.py): GPT nano, seed 0
    on the CPU."""
    cfg = GPTConfig.nano()
    return ServingEngine(cfg, init_params(cfg, 0, device="cpu"),
                         ServeSpec(**spec), device="cpu")


def test_worker_sampled_tokens_match_alone_decode(master):
    """Sampled requests through the worker (2 slots, 2 fused tokens) equal
    the alone-decode at the JAX drill's geometry (3 slots, 4 fused)."""
    reqs = chaos.drill_requests(6, 12)
    _submit(master, reqs)
    got = _run_worker(master, _drill_engine(chaos.WORKER_SPEC), _ids(reqs))
    assert got == chaos.alone_decode(reqs, chaos.JAX_REFERENCE_SPEC, "cpu")
    assert all(len(t) == 12 for t in got.values())


def test_failed_lease_credits_degraded_and_keeps_decoding():
    port = tcomm.find_free_port()
    c = MasterClient(f"127.0.0.1:{port}", node_id=1,
                     outage_grace_s=GRACE_S)
    try:
        worker = ServingWorker(c, _drill_engine(chaos.WORKER_SPEC))
        worker.ledger = ServeLedger()
        worker.scheduler.ledger = worker.ledger
        held = chaos.drill_requests(1, 4)[0]
        worker.scheduler.submit(held)
        worker._lease()  # noqa: SLF001 — one loop turn's lease
        worker.scheduler.step()
        assert worker.ledger.snapshot()["states"]["degraded"] > 0
        assert worker.scheduler.active() == 1  # still decoding it
    finally:
        c.close()


def test_in_process_drain_after_abandoned_generation(master, tmp_path):
    """Generation 1 runs 6 loop turns and is abandoned holding leases;
    NodeFailure requeues them; generation 2 drains.  Zero dropped,
    requeues attributed, results bitwise the alone-decode's at the JAX
    drill's geometry, one complete trace tree per request."""
    ckpt = str(tmp_path / "ckpt")
    trec.reset_recorder()
    reqs = chaos.drill_requests(8, 10)
    ids = _ids(reqs)
    _submit(master, reqs)
    gen1 = MasterClient(master.addr, node_id=1, node_type="serve-worker",
                        outage_grace_s=GRACE_S)
    try:
        w1 = ServingWorker(gen1, _drill_engine(chaos.WORKER_SPEC),
                           ckpt_dir=ckpt, stats_every=1)
        for _ in range(6):  # the body of ServingWorker.run, 6 turns
            w1._lease()  # noqa: SLF001
            w1.scheduler.step()
            w1._report_results()  # noqa: SLF001
            w1._windows += 1  # noqa: SLF001
            w1._push_stats()  # noqa: SLF001
        summ = master.serve_summary()
        assert 0 < summ.done_total < len(reqs) and summ.leased == 2
        gen1.report_failure("abandoned", level="process")
    finally:
        gen1.close()
    assert master.serve_summary().requeued_total == 2

    got = _run_worker(master, _drill_engine(chaos.WORKER_SPEC), ids,
                      ckpt_dir=ckpt)
    assert sorted(got) == sorted(ids)
    assert all(len(t) == 10 for t in got.values())
    summ = master.serve_summary()
    assert summ.requeued_total == 2 and summ.counters["requeued"] >= 2
    assert summ.done_total == len(reqs) and summ.leased == 0
    assert got == chaos.alone_decode(reqs, chaos.JAX_REFERENCE_SPEC, "cpu")
    trees = chaos.trace_trees(ckpt, ids)
    assert trees["complete"] and trees["flight_dumps"] > 0
