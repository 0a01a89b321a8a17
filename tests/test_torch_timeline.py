"""Port parity: the incident timeline and its offline report.

Held against the JAX package on the CPU:

- ``tests/test_timeline.py``'s cases on both packages' `timeline` module:
  the monotonic→wall anchoring under skewed process clocks, the journal
  events' (epoch, seq) order with nondecreasing-clamped walls and
  ts-less frames, the epoch tags across a bump, the add-only envelope
  and records (against ``schema.lock.json``), the flight envelope's
  anchor fields, byte-equal determinism, the cross-generation trace
  tree with the re-flush dedup, the counts, the narrative's attribution
  and policy answer, and the Perfetto export;
- the port's `incident_json` on the same journal and flight artifacts is
  byte-equal to JAX's: one journal dir, and two after a failover (the
  merged union, ``failover`` as its own incident kind);
- the port's ``python -m dlrover_wuqiong_tpu_torch.telemetry.incident_report``
  keeps the tool's contract (rc 2 without an address, ``-h`` to stderr,
  rc 1 on a missing dir) and hashes to the assembler's bytes, as JAX's
  ``tools/incident_report.py`` does on the same artifacts;
- the port master's `TimelineQuery` verb answers the offline bytes and
  journals nothing; `MasterClient.get_timeline` is polling-class.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest

from dlrover_wuqiong_tpu.common import messages as jmsg
from dlrover_wuqiong_tpu.master import journal as jjournal
from dlrover_wuqiong_tpu.telemetry import recorder as jrec
from dlrover_wuqiong_tpu.telemetry import timeline as jtl
from dlrover_wuqiong_tpu_torch.agent.master_client import MasterClient
from dlrover_wuqiong_tpu_torch.common import messages as tmsg
from dlrover_wuqiong_tpu_torch.master import journal as tjournal
from dlrover_wuqiong_tpu_torch.master.master import JobMaster
from dlrover_wuqiong_tpu_torch.telemetry import recorder as trec
from dlrover_wuqiong_tpu_torch.telemetry import timeline as ttl
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK = os.path.join(REPO, "dlrover_wuqiong_tpu", "analysis",
                    "schema.lock.json")

#: each package's (timeline module, MasterJournal, FlightRecorder)
MODS = {"jax": (jtl, jjournal.MasterJournal, jrec.FlightRecorder),
        "torch": (ttl, tjournal.MasterJournal, trec.FlightRecorder)}


@pytest.fixture(params=tuple(MODS))
def mods(request):
    return MODS[request.param]


def _write_dump(ckpt_dir, role, pid, flushed_at, flushed_mono, events,
                ledger=None, serve_ledger=None, seq=1, reason="test"):
    """A flight dump written straight in the envelope schema — the tests
    need pids and clocks no single process could produce."""
    out = os.path.join(ckpt_dir, "flight")
    os.makedirs(out, exist_ok=True)
    payload = {"schema": 1, "role": role, "pid": pid, "reason": reason,
               "flushed_at": flushed_at, "flushed_mono": flushed_mono,
               "ledger": ledger, "serve_ledger": serve_ledger,
               "events": events}
    path = os.path.join(out, f"{role}-{pid}-{reason}-{seq}.json")
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def _span(trace_id, span_id, name, t_wall, t_mono, pid, role="worker",
          parent=""):
    return {"t_wall": t_wall, "t_mono": t_mono, "kind": "span",
            "name": name,
            "data": {"trace_id": trace_id, "span_id": span_id,
                     "name": name, "parent_span": parent, "pid": pid,
                     "role": role, "t_wall": t_wall, "dur_s": 0.5,
                     "status": "ok", "attrs": {}}}


# -------------------------------------------------------------- anchoring
# tests/test_timeline.py:63-110, on both packages


class TestAnchoring:
    def test_skewed_wall_clock_is_corrected(self, mods):
        tl = mods[0]
        dump = {"flushed_at": 1000.0, "flushed_mono": 400.0}
        evt = {"t_wall": 1045.0, "t_mono": 395.0}  # wall lies, mono doesn't
        assert tl.anchored_wall(dump, evt) == pytest.approx(995.0)

    def test_two_skewed_processes_interleave_correctly(self, tmp_path,
                                                        mods):
        tl = mods[0]
        ck = str(tmp_path)
        _write_dump(ck, "workerA", 111, 1000.0, 500.0, [
            {"t_wall": 1090.0, "t_mono": 490.0, "kind": "mark",
             "name": "a-early", "data": {}},
            {"t_wall": 1098.0, "t_mono": 498.0, "kind": "mark",
             "name": "a-late", "data": {}}])
        _write_dump(ck, "workerB", 222, 1000.0, 800.0, [
            {"t_wall": 987.0, "t_mono": 794.0, "kind": "mark",
             "name": "b-mid", "data": {}}])
        events, _ = tl.read_flight_events(ck)
        marks = [e for e in events if e["kind"] == "mark"]
        assert [e["name"] for e in sorted(marks,
                                          key=lambda e: e["t_wall"])] == \
            ["a-early", "b-mid", "a-late"]
        by_name = {e["name"]: e["t_wall"] for e in marks}
        assert by_name["a-early"] == pytest.approx(990.0)
        assert by_name["b-mid"] == pytest.approx(994.0)
        assert by_name["a-late"] == pytest.approx(998.0)

    def test_old_dump_without_anchor_falls_back_to_wall(self, mods):
        tl = mods[0]
        assert tl.anchored_wall({"flushed_at": 1000.0},
                                {"t_wall": 990.0}) == 990.0
        assert tl.anchored_wall(
            {"flushed_at": 1000.0, "flushed_mono": 1.0},
            {"t_wall": 990.0}) == 990.0


# ---------------------------------------------------------- journal order
# tests/test_timeline.py:115-180, on both packages


class TestJournalEvents:
    def test_append_stamps_wall_ts(self, tmp_path, mods):
        MasterJournal = mods[1]
        j = MasterJournal(str(tmp_path / "j"), fsync=False)
        j.append("register", {"node_id": 0})
        j.close()
        with open(tmp_path / "j" / "journal.frames", "rb") as f:
            frames = [json.loads(ln) for ln in f.read().splitlines() if ln]
        assert all("ts" in fr and fr["ts"] > 0 for fr in frames)

    def test_ts_less_frames_tolerated(self, tmp_path, mods):
        tl = mods[0]
        jd = tmp_path / "j"
        jd.mkdir()
        with open(jd / "journal.frames", "w") as f:
            f.write(json.dumps({"seq": 1, "kind": "epoch", "ts": 100.0,
                                "data": {"epoch": 1}}) + "\n")
            f.write(json.dumps({"seq": 2, "kind": "register",
                                "data": {"node_id": 0}}) + "\n")
        events = tl.read_journal_events(str(jd))
        assert [(e["seq"], e["t_wall"]) for e in events] == \
            [(1, 100.0), (2, 100.0)]

    def test_regressing_wall_clamped_to_causal_order(self, tmp_path, mods):
        tl = mods[0]
        jd = tmp_path / "j"
        jd.mkdir()
        with open(jd / "journal.frames", "w") as f:
            for seq, ts in ((1, 100.0), (2, 90.0), (3, 95.0)):
                f.write(json.dumps({"seq": seq, "kind": "register",
                                    "ts": ts, "data": {}}) + "\n")
        events = tl.read_journal_events(str(jd))
        walls = [e["t_wall"] for e in events]
        assert walls == sorted(walls)
        assert [e["seq"] for e in events] == [1, 2, 3]

    def test_epoch_tagging_across_bump(self, tmp_path, mods):
        tl, MasterJournal = mods[0], mods[1]
        jd = str(tmp_path / "j")
        for kind in ("register", "heartbeat"):  # two incarnations
            j = MasterJournal(jd, fsync=False)
            j.load()
            j.open_epoch()
            j.append(kind, {"node_id": 0})
            j.close()
        events = tl.read_journal_events(jd)
        keys = [(e["epoch"], e["seq"]) for e in events]
        assert keys == sorted(keys) and len(keys) == len(set(keys))
        assert [e["epoch"] for e in events] == [1, 1, 2, 2]

    def test_torn_tail_dropped(self, tmp_path, mods):
        tl = mods[0]
        jd = tmp_path / "j"
        jd.mkdir()
        with open(jd / "journal.frames", "w") as f:
            f.write(json.dumps({"seq": 1, "kind": "kv_set", "ts": 1.0,
                                "data": {}}) + "\n")
            f.write('{"seq": 2, "kind": "kv')
        assert [e["seq"] for e in tl.read_journal_events(str(jd))] == [1]


# ------------------------------------------------------------ schema pins
# tests/test_timeline.py:186-241, on the port


class TestAddOnlySchemas:
    def test_event_keys_equal_jax(self):
        assert ttl.TIMELINE_EVENT_KEYS == jtl.TIMELINE_EVENT_KEYS
        assert ttl.TIMELINE_SCHEMA_VERSION == jtl.TIMELINE_SCHEMA_VERSION
        with open(LOCK) as f:
            lock = json.load(f)
        for k in lock["registries"]["TIMELINE_EVENT_KEYS"]:
            assert k in ttl.TIMELINE_EVENT_KEYS, f"removed event key {k!r}"

    @pytest.mark.parametrize("name", ["TimelineQuery", "TimelineResponse",
                                      "FetchJournalRequest",
                                      "FetchJournalResponse"])
    def test_records_equal_schema_lock(self, name):
        with open(LOCK) as f:
            lock = json.load(f)["messages"][name]["fields"]
        got = [f.name for f in dataclasses.fields(getattr(tmsg, name))]
        assert got == [e["name"] for e in lock]
        assert got == [f.name for f in
                       dataclasses.fields(getattr(jmsg, name))]

    def test_flight_envelope_anchor_fields(self, tmp_path, mods):
        rec = mods[2]()
        rec.record("mark", "x", {})
        path = rec.flush(str(tmp_path), "t")
        with open(path) as f:
            dump = json.load(f)
        for key in ("schema", "role", "pid", "reason", "flushed_at",
                    "flushed_mono", "ledger", "serve_ledger", "events"):
            assert key in dump, f"removed envelope key {key!r}"
        for key in ("t_wall", "t_mono", "kind", "name", "data"):
            assert key in dump["events"][0], f"removed event key {key!r}"

    def test_event_builder_matches_pin(self, mods):
        tl = mods[0]
        e = tl._event("journal", "k", "n", 1.0)  # noqa: SLF001
        assert tuple(e.keys()) == tl.TIMELINE_EVENT_KEYS


# --------------------------------------------------------------- assembly
# tests/test_timeline.py:247-330, on both packages


def _incident_fixture(tmp_path, MasterJournal):
    jd = str(tmp_path / "journal")
    ck = str(tmp_path / "ckpt")
    j = MasterJournal(jd, fsync=False)
    j.load()
    j.open_epoch()
    j.append("register", {"node_id": 0})
    j.close()
    j2 = MasterJournal(jd, fsync=False)  # restarted master
    j2.load()
    j2.open_epoch()
    j2.append("policy", {"decision": {"decision_id": 7,
                                      "reason": "drill"}})
    j2.close()
    tid = "t" * 32
    _write_dump(ck, "worker", 111, 1000.0, 500.0, [
        _span(tid, "a" * 16, "serve:admit", 1090.0, 490.0, 111)],
        ledger={"wall_s": 10.0, "states": {"productive": 8.0,
                                           "degraded": 2.0}},
        seq=1)
    # generation 2: the re-flush carries gen-1's admit span AGAIN
    # (cumulative ring) plus its own child spans
    _write_dump(ck, "worker", 222, 1002.0, 900.0, [
        _span(tid, "a" * 16, "serve:admit", 1090.0, 890.0, 111),
        _span(tid, "b" * 16, "serve:decode", 1001.0, 899.0, 222,
              parent="a" * 16),
        _span(tid, "c" * 16, "serve:finish", 1001.5, 899.5, 222,
              parent="a" * 16)],
        ledger={"wall_s": 5.0, "states": {"productive": 4.0,
                                          "restore_storage": 1.0}},
        seq=1)
    return jd, ck, tid


class TestAssembly:
    def test_byte_equal_determinism(self, tmp_path, mods):
        tl = mods[0]
        jd, ck, _ = _incident_fixture(tmp_path, mods[1])
        a = tl.incident_json(tl.assemble_incident(journal_dir=jd,
                                                  ckpt_dir=ck))
        b = tl.incident_json(tl.assemble_incident(journal_dir=jd,
                                                  ckpt_dir=ck))
        assert a == b
        assert tl.incident_sha256(a) == tl.incident_sha256(b)

    def test_cross_generation_one_tree(self, tmp_path, mods):
        tl = mods[0]
        jd, ck, tid = _incident_fixture(tmp_path, mods[1])
        report = tl.assemble_incident(journal_dir=jd, ckpt_dir=ck)
        spans = [e for e in report["events"] if e["kind"] == "span"]
        assert len(spans) == 3  # the re-flushed admit span appears ONCE
        roots = tl.trace_tree(report["events"], tid)
        assert len(roots) == 1
        root = roots[0]
        assert root["name"] == "serve:admit"
        assert sorted(c["name"] for c in root["children"]) == \
            ["serve:decode", "serve:finish"]
        pids = {root["pid"]} | {c["pid"] for c in root["children"]}
        assert pids == {111, 222}

    def test_events_json_safe_and_ordered(self, tmp_path, mods):
        tl = mods[0]
        jd, ck, _ = _incident_fixture(tmp_path, mods[1])
        report = tl.assemble_incident(journal_dir=jd, ckpt_dir=ck)
        json.dumps(report)  # no typed-JSON leftovers
        walls = [e["t_wall"] for e in report["events"]]
        assert walls == sorted(walls)
        jkeys = [(e["epoch"], e["seq"]) for e in report["events"]
                 if e["source"] == "journal"]
        assert jkeys == sorted(jkeys) and len(jkeys) == len(set(jkeys))

    def test_counts(self, tmp_path, mods):
        tl = mods[0]
        jd, ck, _ = _incident_fixture(tmp_path, mods[1])
        c = tl.assemble_incident(journal_dir=jd, ckpt_dir=ck)["counts"]
        assert c["journal_events"] == 4  # two epochs + two appends
        assert c["spans"] == 3 and c["traces"] == 1
        assert c["epochs"] == [1, 2]
        assert [list(p) for p in c["processes"]] == [["worker", 111],
                                                      ["worker", 222]]


def _failover_dirs(tmp_path, MasterJournal):
    """A primary's journal and its standby's: the standby holds the same
    first frames byte for byte, then a ``failover`` frame and epoch 3."""
    jp, js = str(tmp_path / "primary"), str(tmp_path / "standby")
    p = MasterJournal(jp, fsync=False)
    p.load()
    p.open_epoch()
    p.append("kv_set", {"key": "k", "value": b"v"})
    p.append("lease", {"holder": "1", "lease_epoch": 1, "ttl_s": 1.0})
    _, _, frames, _ = p.fetch_batch(0)
    p.append("kv_set", {"key": "lost", "value": b"x"})  # never shipped
    p.close()
    s = MasterJournal(js, fsync=False)
    s.load()
    s.ingest_frames(frames)
    s.append("failover", {"from_epoch": 1, "new_epoch": 3,
                          "last_shipped_seq": 3, "holder": "2"})
    s.epoch = 2
    s.open_epoch()
    s.append("kv_set", {"key": "after", "value": b"y"})
    s.close()
    return jp, js


def test_incident_json_byte_equal_jax_one_journal(tmp_path):
    jd, ck, _ = _incident_fixture(tmp_path, jjournal.MasterJournal)
    got = {name: m[0].incident_json(m[0].assemble_incident(
        journal_dir=jd, ckpt_dir=ck)) for name, m in MODS.items()}
    assert got["torch"] == got["jax"]
    assert jtl.incident_sha256(got["jax"]) == \
        ttl.incident_sha256(got["torch"])


@pytest.mark.parametrize("writer", tuple(MODS))
def test_incident_json_byte_equal_jax_after_failover(tmp_path, writer):
    """The failover's two journals (written by either package) and a
    worker's flight dump give the same bytes through either assembler:
    the union deduped on (epoch, seq, kind), the takeover a
    ``failover`` incident."""
    jp, js = _failover_dirs(tmp_path, MODS[writer][1])
    ck = str(tmp_path / "ckpt")
    _write_dump(ck, "worker", 5, 1000.0, 50.0, [
        {"t_wall": 999.0, "t_mono": 49.0, "kind": "mark", "name": "m",
         "data": {}}],
        ledger={"wall_s": 4.0, "states": {"productive": 3.0,
                                          "degraded": 0.5}})
    got = {name: m[0].incident_json(m[0].assemble_incident(
        journal_dir=js, ckpt_dir=ck, journal_dirs=[jp]))
        for name, m in MODS.items()}
    assert got["torch"] == got["jax"]
    rep = json.loads(got["torch"])
    assert [i["kind"] for i in rep["narrative"]["incidents"]] == \
        ["failover"]
    assert rep["narrative"]["incidents"][0]["lost_s"] == 0.5
    keys = [(e["epoch"], e["seq"], e["kind"]) for e in rep["events"]
            if e["source"] == "journal"]
    # 3 shared frames once, the primary's unshipped one, the standby's 3
    assert len(keys) == len(set(keys)) == 7
    # the drills' causal gate reads this union as one causal log: the
    # unshipped frame and the failover frame share (epoch, seq), which
    # only the failover drill's two dirs explain
    from dlrover_wuqiong_tpu_torch import chaos

    assert len({k[:2] for k in keys}) == 6
    assert chaos._causal(rep, js, jp)
    assert not chaos._causal(rep)  # master_kill's one journal: JAX's rule
    assert rep["counts"]["epochs"] == [1, 3]


@pytest.mark.parametrize("fault", ["prefix", "tail"])
def test_causal_gate_fails_a_planted_divergence(tmp_path, fault):
    """The failover drill's causal gate admits only the unshipped tail
    beside the ``failover`` frame.  A mirror that diverges inside the
    shipped prefix, or a standby frame other than the failover at the
    old epoch above it, shares an (epoch, seq) with the primary and
    fails the gate."""
    from dlrover_wuqiong_tpu_torch import chaos

    jp, js = str(tmp_path / "primary"), str(tmp_path / "standby")
    p = tjournal.MasterJournal(jp, fsync=False)
    p.load()
    p.open_epoch()
    p.append("kv_set", {"key": "k", "value": b"v"})
    p.append("lease", {"holder": "1", "lease_epoch": 1, "ttl_s": 1.0})
    _, _, frames, _ = p.fetch_batch(0)
    p.append("kv_set", {"key": "lost", "value": b"x"})  # never shipped
    p.close()
    s = tjournal.MasterJournal(js, fsync=False)
    s.load()
    if fault == "prefix":  # seq 2 shipped as another kind
        s.ingest_frames(frames[:1])
        s.append("lease", {"holder": "1", "lease_epoch": 1, "ttl_s": 1.0})
        s.ingest_frames(frames[2:])
    else:  # the standby's own frame at (1, 4), its failover at (1, 5)
        s.ingest_frames(frames)
        s.append("lease", {"holder": "2", "lease_epoch": 1, "ttl_s": 1.0})
    s.append("failover", {"from_epoch": 1, "new_epoch": 3,
                          "last_shipped_seq": 3, "holder": "2"})
    s.epoch = 2
    s.open_epoch()
    s.close()
    rep = json.loads(ttl.incident_json(ttl.assemble_incident(
        journal_dir=js, ckpt_dir="", journal_dirs=[jp])))
    keys = [(e["epoch"], e["seq"]) for e in rep["events"]
            if e["source"] == "journal"]
    assert len(keys) > len(set(keys))  # the planted collision is there
    assert not chaos._causal(rep, js, jp)


# -------------------------------------------------------------- narrative
# tests/test_timeline.py:336-375, on both packages


class TestNarrative:
    def test_attribution_and_policy_answer(self, tmp_path, mods):
        tl, MasterJournal = mods[0], mods[1]
        jd = str(tmp_path / "j")
        j = MasterJournal(jd, fsync=False)
        j.append("epoch", {"epoch": 2})            # master restart
        j.append("recover", {"node_id": 3})        # worker failure
        j.append("policy", {"decision": {"decision_id": 9,
                                         "reason": "raise-cadence"}})
        j.close()
        ledgers = [{"role": "worker", "pid": 1, "ledger": {
            "wall_s": 20.0,
            "states": {"productive": 15.0, "degraded": 2.5,
                       "restore_storage": 1.0, "rework": 0.5}}}]
        narr = tl.build_narrative(tl.read_journal_events(jd), ledgers)
        kinds = {i["kind"]: i for i in narr["incidents"]}
        assert kinds["master_restart"]["attributed_state"] == "degraded"
        assert kinds["master_restart"]["lost_s"] == pytest.approx(2.5)
        assert kinds["worker_failure"]["attributed_state"] == "restore"
        assert kinds["worker_failure"]["lost_s"] == pytest.approx(1.5)
        for i in narr["incidents"]:
            assert i["policy_response"]["decision_id"] == 9
        assert narr["productive_s"] == pytest.approx(15.0)
        assert narr["goodput_fraction"] == pytest.approx(15.0 / 20.0)

    def test_no_incident_without_trigger(self, tmp_path, mods):
        tl, MasterJournal = mods[0], mods[1]
        jd = str(tmp_path / "j")
        j = MasterJournal(jd, fsync=False)
        j.append("register", {"node_id": 0})
        j.close()
        narr = tl.build_narrative(tl.read_journal_events(jd), [])
        assert narr["incidents"] == []
        assert narr["policy_decisions"] == 0

    def test_failover_epoch_is_its_own_kind(self, tmp_path, mods):
        tl = mods[0]
        jp, js = _failover_dirs(tmp_path, mods[1])
        events = tl.read_journal_events_multi([js, jp])
        narr = tl.build_narrative(events, [])
        assert [i["kind"] for i in narr["incidents"]] == ["failover"]
        # a plain restart's epoch stays a master_restart
        j = mods[1](str(tmp_path / "r"), fsync=False)
        j.append("epoch", {"epoch": 2})
        j.close()
        narr = tl.build_narrative(
            tl.read_journal_events(str(tmp_path / "r")), [])
        assert [i["kind"] for i in narr["incidents"]] == ["master_restart"]


# --------------------------------------------------------------- perfetto


class TestPerfettoExport:
    def test_export_contains_processes_spans_instants(self, tmp_path,
                                                      mods):
        tl, MasterJournal = mods[0], mods[1]
        jd = str(tmp_path / "journal")
        ck = str(tmp_path / "ckpt")
        j = MasterJournal(jd, fsync=False)
        j.append("register", {"node_id": 0})
        j.close()
        tid = "t" * 32
        _write_dump(ck, "worker", 111, 1000.0, 500.0, [
            _span(tid, "a" * 16, "serve:admit", 999.0, 499.0, 111),
            {"t_wall": 999.5, "t_mono": 499.5, "kind": "mark",
             "name": "m", "data": {}}])
        report = tl.assemble_incident(journal_dir=jd, ckpt_dir=ck)
        out = str(tmp_path / "trace.json")
        assert tl.export_perfetto(report, out) > 0
        with open(out) as f:
            rows = json.load(f)["traceEvents"]
        assert {"M", "X", "i"} <= {r["ph"] for r in rows}
        meta = {r["pid"]: r["args"]["name"] for r in rows
                if r["ph"] == "M"}
        assert meta[0] == "master(journal)"
        assert meta[111] == "worker"

    def test_export_equal_jax(self, tmp_path):
        jd, ck, _ = _incident_fixture(tmp_path, tjournal.MasterJournal)
        out = {}
        for name, m in MODS.items():
            path = str(tmp_path / f"{name}.json")
            m[0].export_perfetto(m[0].assemble_incident(
                journal_dir=jd, ckpt_dir=ck), path)
            with open(path) as f:
                out[name] = json.load(f)
        assert out["torch"] == out["jax"]


# ------------------------------------------------------------ CLI contract
# tests/test_timeline.py:381-414, on the port's module


def _run_port(*args):
    env = {k: v for k, v in os.environ.items()
           if k not in ("DWT_MASTER_ADDR", "PYTHONPATH")}
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m",
         "dlrover_wuqiong_tpu_torch.telemetry.incident_report", *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=60)


class TestIncidentReportCLI:
    def test_no_addr_rc2(self):
        p = _run_port()
        assert p.returncode == 2
        assert "error" in json.loads(p.stdout)

    def test_help_rc0_stdout_clean(self):
        p = _run_port("-h")
        assert p.returncode == 0
        assert p.stdout.strip() == ""
        assert "incident" in p.stderr.lower()

    def test_offline_sha_matches_both_tools(self, tmp_path):
        jp, js = _failover_dirs(tmp_path, tjournal.MasterJournal)
        content = ttl.incident_json(ttl.assemble_incident(
            journal_dir=js, journal_dirs=[jp]))
        p = _run_port("--journal", f"{js},{jp}")
        assert p.returncode == 0, p.stdout + p.stderr
        line = json.loads(p.stdout)
        assert line["timeline_sha256"] == ttl.incident_sha256(content)
        assert line["source"] == "disk"
        assert line["events"] == line["journal_events"] > 0
        assert (line["incidents"], line["failovers"]) == (1, 1)
        env = {k: v for k, v in os.environ.items()
               if k != "DWT_MASTER_ADDR"}
        q = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools",
                                          "incident_report.py"),
             "--journal", f"{js},{jp}"],
            capture_output=True, text=True, env=env, timeout=120)
        assert q.returncode == 0, q.stdout + q.stderr
        assert json.loads(q.stdout) == line  # the JAX tool's same line

    def test_bad_journal_rc1(self, tmp_path):
        p = _run_port("--journal", str(tmp_path / "missing"))
        assert p.returncode == 1
        assert "error" in json.loads(p.stdout)

    def test_sinks_write_events_and_perfetto(self, tmp_path):
        jd, ck, _ = _incident_fixture(tmp_path, tjournal.MasterJournal)
        ev, pf = str(tmp_path / "ev.json"), str(tmp_path / "pf.json")
        p = _run_port("--journal", jd, "--flight", ck, "--events-out", ev,
                      "--perfetto", pf)
        assert p.returncode == 0, p.stdout + p.stderr
        with open(ev) as f:
            assert f.read() == ttl.incident_json(ttl.assemble_incident(
                journal_dir=jd, ckpt_dir=ck))
        with open(pf) as f:
            assert json.load(f)["traceEvents"]


# ------------------------------------------------------------ the verb


def test_master_timeline_verb_answers_offline_bytes(tmp_path):
    jd = str(tmp_path / "journal")
    ck = str(tmp_path / "ckpt")
    _write_dump(ck, "worker", 9, 1000.0, 10.0, [
        {"t_wall": 999.0, "t_mono": 9.0, "kind": "mark", "name": "m",
         "data": {}}])
    m = JobMaster(port=0, host="127.0.0.1", journal_dir=jd)
    m.start()
    mc = MasterClient(m.addr, node_id=0, outage_grace_s=0.5)
    try:
        mc.kv_store_set("k", b"v")
        before = m.journal_stats().durable_seq
        resp = mc.get_timeline(ckpt_dir=ck)
        assert m.journal_stats().durable_seq == before  # never journaled
        offline = ttl.incident_json(ttl.assemble_incident(
            journal_dir=jd, ckpt_dir=ck))
        assert resp.content == offline
        assert resp.events == len(json.loads(offline)["events"])
    finally:
        mc.close()
        m.stop()
    # polling class: a dead master fails fast, no grace spent
    t0 = time.monotonic()
    dead = MasterClient(m.addr, node_id=0, outage_grace_s=30.0)
    try:
        with pytest.raises(Exception):
            dead.get_timeline()
    finally:
        dead.close()
    assert time.monotonic() - t0 < 10.0
