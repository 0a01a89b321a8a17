"""Incident timeline: ONE causally-ordered event stream across the plane.

Parity: dlrover_wuqiong_tpu/telemetry/timeline.py, copied (stdlib only)
with the same event envelope (`TIMELINE_EVENT_KEYS`), the same ordering
and dedup rules and the same canonical JSON, so the port's
`incident_json` over a set of journal dirs and flight dumps is
byte-equal to JAX's over the same artifacts (tests/test_torch_timeline.py).
Flight dumps are read with the port's `telemetry.recorder.load_flight_dumps`
and the Perfetto export writes through the port's
`telemetry.spans.dump_chrome_trace`.

The master journal (master/journal.py) and the flight-recorder dumps
(recorder.py, with their spans and goodput ledgers) merge into one event
stream that a post-mortem or the live `TimelineQuery` verb can reason
over:

- **Master events** come from the journal and are causally ordered by
  ``(fencing epoch, seq)`` — the wall ``ts`` each frame carries is used
  ONLY to interleave with worker events; within the journal a stepped
  wall clock cannot reorder frames because assembly clamps ``t_wall``
  nondecreasing in (epoch, seq) order.
- **Worker events** come from flight dumps and are ordered by
  per-process monotonic→wall anchoring: ``wall = t_mono + (flushed_at -
  flushed_mono)``, so a worker whose wall clock stepped mid-incident
  still lands its own events in true order.  Dumps from before the
  monotonic fields fall back to ``t_wall``.
- **Correlation** is by ``trace_id`` across processes and worker
  generations; spans dedupe by ``(trace_id, span_id)`` because the
  recorder ring re-flushes cumulatively.

DETERMINISM CONTRACT: `assemble_incident` is a pure function of the disk
artifacts (no clock reads, no process state), and `incident_json` is
canonical (sorted keys, fixed separators) — the live TimelineQuery
answer and the offline reconstruction
(``python -m dlrover_wuqiong_tpu_torch.telemetry.incident_report``) are
byte-equal, which the master-kill and master-failover drills gate on.

Across a warm-standby failover the incident spans TWO journal dirs — the
old primary's and the promoted standby's.  Because journal shipping
mirrors frames VERBATIM (master/journal.py ingest_frames) the shared
prefix is byte-identical in both dirs, so `read_journal_events_multi`
dedups on ``(epoch, seq, kind)`` first-wins in dir order and the union
still reads as ONE causal log; the ``epoch`` frame a `failover` frame
announced narrates as a ``failover`` incident instead of a
``master_restart``.
"""


from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Tuple

TIMELINE_SCHEMA_VERSION = 1

#: ADD-ONLY event envelope (tests/test_timeline.py pins JAX's, and
#: tests/test_torch_timeline.py holds this one equal to it): every
#: event in the assembled stream carries exactly these keys.
TIMELINE_EVENT_KEYS = (
    "schema", "source", "kind", "name", "t_wall", "epoch", "seq",
    "role", "pid", "trace_id", "span_id", "dur_s", "data",
)

#: ledger states the narrative attributes to a worker-failure incident
_RESTORE_STATES = ("restore_shm", "restore_replica", "restore_storage",
                   "rework")

#: ledger states a hot-swap transition credits (JAX trainer/hotswap.py;
#: the port's hot swap is ROADMAP item 7b part 3):
#: hydrate rides ``restore_replica``, cutover rides ``rework``
_HOTSWAP_STATES = ("restore_replica", "rework")

_JOURNAL_FILE = "journal.frames"
_SNAPSHOT_FILE = "snapshot.frame"


def _event(source: str, kind: str, name: str, t_wall: float,
           epoch: int = 0, seq: int = 0, role: str = "", pid: int = 0,
           trace_id: str = "", span_id: str = "", dur_s: float = 0.0,
           data: Optional[Dict] = None) -> Dict:
    return {
        "schema": TIMELINE_SCHEMA_VERSION,
        "source": source, "kind": kind, "name": name,
        "t_wall": round(float(t_wall), 6),
        "epoch": int(epoch), "seq": int(seq),
        "role": str(role), "pid": int(pid),
        "trace_id": str(trace_id), "span_id": str(span_id),
        "dur_s": round(float(dur_s), 6),
        "data": data or {},
    }


# --------------------------------------------------------- journal side


def _plain(v: Any) -> Any:
    """Typed-JSON wire encoding → plain JSON (common/serialize.py shape).

    ``{"__msg__": T, "fields": {...}}`` collapses to its fields WITHOUT
    instantiating message classes — assembly must stay deterministic and
    JSON-serializable even for frame kinds newer than this reader.
    """
    if isinstance(v, dict):
        if "__msg__" in v:
            return {k: _plain(x) for k, x in v.get("fields", {}).items()}
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v


def _summary(data: Any, depth: int = 0) -> Dict:
    """Compact, deterministic projection of a frame's data: scalars and
    short scalar lists survive, big payloads become counts — the
    timeline carries event IDENTITY, not the full payload."""
    if not isinstance(data, dict):
        return {"value": data if isinstance(data, (int, float, bool, str))
                else repr(type(data).__name__)}
    out: Dict = {}
    for k, v in sorted(data.items()):
        k = str(k)
        if v is None or isinstance(v, (bool, int, float)):
            out[k] = v
        elif isinstance(v, str):
            out[k] = v if len(v) <= 120 else v[:117] + "..."
        elif isinstance(v, list):
            if len(v) <= 16 and all(
                    isinstance(x, (bool, int, float, str)) for x in v):
                out[k] = v
            else:
                out[k + "_n"] = len(v)
        elif isinstance(v, dict):
            if depth < 1:
                out[k] = _summary(v, depth + 1)
            else:
                out[k + "_keys"] = sorted(str(x) for x in v)[:8]
    return out


def _frame_data(kind: str, data: Dict) -> Dict:
    """Per-kind summary; serve_result keeps its request ids — the
    exactly-once drill gate needs result identity, not token payloads."""
    out = _summary(data)
    if kind == "serve_result" and isinstance(data.get("results"), list):
        out["request_ids"] = [
            str(r.get("request_id", "")) for r in data["results"]
            if isinstance(r, dict)]
    return out


def read_journal_events(journal_dir: str) -> List[Dict]:
    """All intact journal frames as timeline events, (epoch, seq) order.

    Reads raw lines (same torn-tail drop as MasterJournal.load, which
    never acked the torn frame) and tags each frame with the fencing
    epoch current at append time; the snapshot contributes one event
    carrying its watermark.  ``t_wall`` is clamped nondecreasing in
    stream order so a wall step between master incarnations cannot fold
    the merge order back over the causal order.
    """
    events: List[Dict] = []
    if not journal_dir or not os.path.isdir(journal_dir):
        return events
    epoch = 0
    last_wall = 0.0
    snap_path = os.path.join(journal_dir, _SNAPSHOT_FILE)
    if os.path.exists(snap_path):
        try:
            with open(snap_path, "rb") as f:
                frame = json.loads(f.read().decode("utf-8"))
            epoch = int(frame.get("epoch", 0))
            last_wall = float(frame.get("ts", 0.0) or 0.0)
            state = frame.get("state") or {}
            events.append(_event(
                "journal", "snapshot", "journal:snapshot", last_wall,
                epoch=epoch, seq=int(frame.get("seq", 0)), role="master",
                data={"covers_seq": int(frame.get("seq", 0)),
                      "state_keys": sorted(str(k) for k in state),
                      "policy_n": len(state.get("policy") or [])}))
        except (OSError, ValueError):
            pass
    path = os.path.join(journal_dir, _JOURNAL_FILE)
    if not os.path.exists(path):
        return events
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    for line in lines:
        if not line.strip():
            continue
        try:
            frame = json.loads(line.decode("utf-8"))
        except ValueError:
            break  # torn tail — never acked, drop (journal.py contract)
        kind = str(frame.get("kind", ""))
        seq = int(frame.get("seq", 0))
        data = _plain(frame.get("data") or {})
        if kind == "epoch":
            epoch = int(data.get("epoch", epoch))
        # old frames have no ts: inherit the last seen wall (tolerant
        # replay, satellite contract) — ordering is (epoch, seq) anyway
        wall = float(frame.get("ts", 0.0) or 0.0)
        last_wall = max(last_wall, wall)
        events.append(_event(
            "journal", kind, f"journal:{kind}", last_wall, epoch=epoch,
            seq=seq, role="master", data=_frame_data(kind, data)))
    return events


def read_journal_events_multi(journal_dirs: List[str]) -> List[Dict]:
    """Events from one or more journal dirs as ONE (epoch, seq) stream.

    A warm standby's journal (master/standby.py) is a verbatim mirror
    of the primary's plus its own post-promotion tail, so across a
    failover the SAME frame exists byte-identical in both dirs: dedup
    is ``(epoch, seq, kind)`` first-wins in dir order, then the union
    sorts by ``(epoch, seq)`` and ``t_wall`` re-clamps nondecreasing.
    With zero or one dirs this IS `read_journal_events` — the
    single-journal path stays byte-identical.
    """
    dirs = [d for d in journal_dirs if d]
    if len(dirs) <= 1:
        return read_journal_events(dirs[0] if dirs else "")
    seen: set = set()
    merged: List[Dict] = []
    for d in dirs:
        for e in read_journal_events(d):
            key = (e["epoch"], e["seq"], e["kind"])
            if key in seen:
                continue
            seen.add(key)
            merged.append(e)
    merged.sort(key=lambda e: (e["epoch"], e["seq"]))
    last_wall = 0.0
    for e in merged:
        last_wall = max(last_wall, e["t_wall"])
        e["t_wall"] = last_wall
    return merged


# ---------------------------------------------------------- flight side


def anchored_wall(dump: Dict, evt: Dict) -> float:
    """Monotonic→wall anchor for one event of one dump.

    ``wall = t_mono + (flushed_at - flushed_mono)`` when both clocks are
    present (recorder.py stamps them back to back at flush); pre-anchor
    dumps fall back to the event's recorded wall clock.
    """
    fa = dump.get("flushed_at")
    fm = dump.get("flushed_mono")
    tm = evt.get("t_mono")
    if fa is not None and fm is not None and tm is not None:
        return float(tm) + (float(fa) - float(fm))
    return float(evt.get("t_wall", 0.0) or 0.0)


def read_flight_events(ckpt_dir: str) -> Tuple[List[Dict], List[Dict]]:
    """(events, latest_ledgers) from ``$ckpt_dir/flight/`` dumps.

    Spans dedupe by (trace_id, span_id), other events by their recorded
    clocks — the ring re-flushes cumulatively, and an event must appear
    ONCE no matter how many dumps carried it.  First flush wins the
    anchor (deterministic: load_flight_dumps orders by flushed_at, then
    filename).  ``latest_ledgers`` is one entry per (role, pid): the
    last embedded goodput/serve ledger snapshots, for the narrative.
    """
    from .recorder import load_flight_dumps

    events: List[Dict] = []
    ledgers: Dict[Tuple[str, int], Dict] = {}
    if not ckpt_dir:
        return events, []
    seen_spans: set = set()
    seen_other: set = set()
    for dump in load_flight_dumps(ckpt_dir):
        role = str(dump.get("role", ""))
        pid = int(dump.get("pid", 0) or 0)
        ledgers[(role, pid)] = {
            "role": role, "pid": pid,
            "ledger": dump.get("ledger"),
            "serve_ledger": dump.get("serve_ledger"),
        }
        events.append(_event(
            "flight", "flush", f"flight:{dump.get('reason', '')}",
            float(dump.get("flushed_at", 0.0) or 0.0), role=role, pid=pid,
            data={"reason": str(dump.get("reason", "")),
                  "file": str(dump.get("_file", "")),
                  "events_n": len(dump.get("events") or [])}))
        for evt in dump.get("events") or []:
            kind = str(evt.get("kind", ""))
            wall = anchored_wall(dump, evt)
            if kind == "span":
                rec = evt.get("data") or {}
                key = (rec.get("trace_id", ""), rec.get("span_id", ""))
                if key in seen_spans:
                    continue
                seen_spans.add(key)
                events.append(_event(
                    "flight", "span", str(rec.get("name", "")), wall,
                    role=str(rec.get("role", role)),
                    pid=int(rec.get("pid", pid) or 0),
                    trace_id=str(rec.get("trace_id", "")),
                    span_id=str(rec.get("span_id", "")),
                    dur_s=float(rec.get("dur_s", 0.0) or 0.0),
                    data={"parent_span": str(rec.get("parent_span", "")),
                          "status": str(rec.get("status", "ok")),
                          "attrs": _summary(rec.get("attrs") or {})}))
            else:
                key = (pid, kind, str(evt.get("name", "")),
                       repr(evt.get("t_wall")), repr(evt.get("t_mono")))
                if key in seen_other:
                    continue
                seen_other.add(key)
                events.append(_event(
                    "flight", kind, str(evt.get("name", "")), wall,
                    role=role, pid=pid,
                    data=_summary(evt.get("data") or {})))
    latest = [ledgers[k] for k in sorted(ledgers)]
    return events, latest


# ------------------------------------------------------------- assembly


def _merge(journal_events: List[Dict], flight_events: List[Dict]
           ) -> List[Dict]:
    """One stream: journal events keep (epoch, seq) order (their clamped
    t_wall already respects it), flight events interleave by anchored
    wall; ties break journal-first, then causally/by-process."""
    keyed = []
    for i, e in enumerate(journal_events):
        keyed.append(((e["t_wall"], 0, e["epoch"], e["seq"], 0, i), e))
    for i, e in enumerate(flight_events):
        keyed.append(((e["t_wall"], 1, 0, 0, e["pid"], i), e))
    keyed.sort(key=lambda kv: kv[0])
    return [e for _, e in keyed]


def _policy_decisions(journal_events: List[Dict]) -> List[Dict]:
    out = []
    for e in journal_events:
        if e["kind"] != "policy":
            continue
        d = e["data"].get("decision")
        out.append({"seq": e["seq"], "epoch": e["epoch"],
                    "t_wall": e["t_wall"],
                    "decision": d if isinstance(d, dict) else {}})
    return out


def build_narrative(journal_events: List[Dict], ledgers: List[Dict]
                    ) -> Dict:
    """Automated downtime attribution: which seconds were lost, to which
    ledger state, triggered by which journaled event, answered by which
    policy decision.

    Incident triggers are journal facts — an ``epoch`` frame beyond the
    first is a master restart (lost seconds attribute to ``degraded``:
    every second a verb burned blocked on the dead master), a ``recover``
    frame is a worker failure (lost seconds attribute to the restore_*
    + rework states).  The answering decision is the first journaled
    ``policy`` frame at or after the trigger in (epoch, seq) order.
    """
    states: Dict[str, float] = {}
    wall = 0.0
    productive = 0.0
    for entry in ledgers:
        led = entry.get("ledger") or {}
        wall += float(led.get("wall_s", 0.0) or 0.0)
        for k, v in (led.get("states") or {}).items():
            states[str(k)] = states.get(str(k), 0.0) + float(v)
    productive = states.get("productive", 0.0)
    lost = {k: round(v, 6) for k, v in sorted(states.items())
            if k != "productive" and v > 0}
    decisions = _policy_decisions(journal_events)

    def _answer(epoch: int, seq: int) -> Optional[Dict]:
        for d in decisions:
            if (d["epoch"], d["seq"]) >= (epoch, seq):
                dec = d["decision"]
                return {"decision_id": dec.get("decision_id"),
                        "seq": d["seq"], "reason": dec.get("reason", "")}
        return None

    # mesh_transition frames aggregate per transition id: one journaled
    # propose→fence→hydrate→cutover→release ladder narrates as ONE
    # incident (in-place hot-swap, JAX master/mesh_transition.py), anchored
    # at its propose frame.  Downtime attributes to the two ledger
    # states the survivor credits (JAX trainer/hotswap.py): restore_replica
    # for hydrate, rework for cutover.
    mesh: Dict[int, Dict] = {}
    for e in journal_events:
        if e["kind"] != "mesh_transition":
            continue
        d = e["data"]
        tid = int(d.get("tid", 0) or 0)
        if not tid:
            continue
        t = mesh.setdefault(tid, {"phases": [], "final": "propose",
                                  "acks": 0})
        ev = str(d.get("event", ""))
        if ev == "propose":
            survivors = d.get("survivors")
            t["dead_node_id"] = d.get("dead_node_id")
            t["fence_epoch"] = d.get("fence_epoch")
            t["survivors_n"] = (len(survivors)
                                if isinstance(survivors, list)
                                else int(d.get("survivors_n", 0) or 0))
        elif ev == "phase":
            ph = str(d.get("phase", ""))
            t["phases"].append(ph)
            t["final"] = ph
        elif ev == "abort":
            t["final"] = "aborted"
        elif ev == "ack":
            t["acks"] += 1

    # epochs a journaled ``failover`` frame announced: the matching
    # ``epoch`` frame is a fenced standby PROMOTION, not a restart of
    # the same process (warm-standby HA, master/standby.py)
    failover_epochs = {
        int(e["data"].get("new_epoch", 0) or 0)
        for e in journal_events if e["kind"] == "failover"}

    incidents: List[Dict] = []
    for e in journal_events:
        if e["kind"] == "epoch" and int(
                e["data"].get("epoch", 0) or 0) >= 2:
            opened = int(e["data"].get("epoch", 0) or 0)
            incidents.append({
                "kind": ("failover" if opened in failover_epochs
                         else "master_restart"),
                "epoch": e["epoch"], "seq": e["seq"],
                "t_wall": e["t_wall"],
                "attributed_state": "degraded",
                "lost_s": round(states.get("degraded", 0.0), 6),
                "trigger": {"kind": "epoch", "seq": e["seq"]},
                "policy_response": _answer(e["epoch"], e["seq"]),
            })
        elif e["kind"] == "recover":
            restore = sum(states.get(s, 0.0) for s in _RESTORE_STATES)
            incidents.append({
                "kind": "worker_failure",
                "epoch": e["epoch"], "seq": e["seq"],
                "t_wall": e["t_wall"],
                "attributed_state": "restore",
                "lost_s": round(restore, 6),
                "trigger": {"kind": "recover", "seq": e["seq"],
                            "node_id": e["data"].get("node_id")},
                "policy_response": _answer(e["epoch"], e["seq"]),
            })
        elif (e["kind"] == "mesh_transition"
              and str(e["data"].get("event", "")) == "propose"):
            tid = int(e["data"].get("tid", 0) or 0)
            t = mesh.get(tid, {})
            swap = sum(states.get(s, 0.0) for s in _HOTSWAP_STATES)
            incidents.append({
                "kind": "mesh_transition",
                "epoch": e["epoch"], "seq": e["seq"],
                "t_wall": e["t_wall"],
                "attributed_state": "hotswap",
                "lost_s": round(swap, 6),
                "trigger": {"kind": "mesh_transition", "seq": e["seq"],
                            "node_id": t.get("dead_node_id"),
                            "transition_id": tid},
                "phase": str(t.get("final", "propose")),
                "phases": list(t.get("phases", [])),
                "acks": int(t.get("acks", 0)),
                "fence_epoch": t.get("fence_epoch"),
                "survivors_n": int(t.get("survivors_n", 0) or 0),
                "policy_response": _answer(e["epoch"], e["seq"]),
            })
    total = max(wall, sum(states.values()))
    return {
        "schema": TIMELINE_SCHEMA_VERSION,
        "wall_s": round(wall, 6),
        "productive_s": round(productive, 6),
        "goodput_fraction": round(
            (productive / total) if total > 0 else 0.0, 6),
        "lost_seconds": lost,
        "incidents": incidents,
        "policy_decisions": len(decisions),
    }


def assemble_incident(journal_dir: str = "", ckpt_dir: str = "",
                      journal_dirs: Optional[List[str]] = None) -> Dict:
    """The whole incident: merged event stream + narrative + counts.

    Pure function of the disk artifacts — the live TimelineQuery verb
    (master/master.py timeline_report) runs THIS on the master's own
    journal dir, so `telemetry/incident_report.py --journal/--flight` on the
    same artifacts reconstructs byte-equal canonical JSON.

    ``journal_dirs`` lists FURTHER journal dirs to merge after
    ``journal_dir`` (warm-standby failover post-mortems span the old
    primary's dir and the promoted standby's); with at most one
    effective dir the output is byte-identical to the single-journal
    path.  Live and offline must pass the SAME ordered dir list for
    byte-equality.
    """
    dirs: List[str] = []
    for d in [journal_dir, *(journal_dirs or [])]:
        if d and d not in dirs:
            dirs.append(d)
    journal_events = read_journal_events_multi(dirs)
    flight_events, ledgers = read_flight_events(ckpt_dir)
    events = _merge(journal_events, flight_events)
    traces = sorted({e["trace_id"] for e in events if e["trace_id"]})
    epochs = sorted({e["epoch"] for e in journal_events if e["epoch"] > 0})
    return {
        "schema": TIMELINE_SCHEMA_VERSION,
        "events": events,
        "narrative": build_narrative(journal_events, ledgers),
        "counts": {
            "events": len(events),
            "journal_events": len(journal_events),
            "flight_events": len(flight_events),
            "spans": sum(1 for e in events if e["kind"] == "span"),
            "traces": len(traces),
            "epochs": epochs,
            "processes": sorted({(e["role"], e["pid"])
                                 for e in flight_events}),
        },
    }


def incident_json(report: Dict) -> str:
    """Canonical serialization — the byte-equality unit the drills and
    `timeline_sha256` hash over (sorted keys, fixed separators)."""
    return json.dumps(report, sort_keys=True, separators=(",", ":"))


def incident_sha256(content: str) -> str:
    return hashlib.sha256(content.encode("utf-8")).hexdigest()


def trace_tree(events: List[Dict], trace_id: str) -> List[Dict]:
    """Span forest for one trace across processes/generations: roots
    (parent absent from the trace) with nested ``children``, each node
    ordered by t_wall — one request admitted by generation 1 and
    finished by generation 2 reads as ONE tree."""
    spans = [e for e in events
             if e["kind"] == "span" and e["trace_id"] == trace_id]
    nodes = {e["span_id"]: {**e, "children": []} for e in spans}
    roots = []
    for e in sorted(spans, key=lambda s: (s["t_wall"], s["span_id"])):
        parent = e["data"].get("parent_span", "")
        node = nodes[e["span_id"]]
        if parent and parent in nodes:
            nodes[parent]["children"].append(node)
        else:
            roots.append(node)
    return roots


# ------------------------------------------------------ Perfetto export


def export_perfetto(report: Dict, path: str) -> int:
    """Whole-incident Chrome/Perfetto trace: span events become duration
    slices per (pid, role) process track, journal frames and flight
    flushes become instant marks on their process's track
    (spans.dump_chrome_trace grew multi-process metadata for this)."""
    from .spans import dump_chrome_trace

    events = report.get("events") or []
    spans = []
    instants = []
    names: Dict[int, str] = {}
    for e in events:
        if e["source"] == "journal":
            names.setdefault(0, "master(journal)")
            instants.append({
                "name": e["name"], "t_wall": e["t_wall"], "pid": 0,
                "args": {"epoch": e["epoch"], "seq": e["seq"],
                         "kind": e["kind"]}})
            continue
        names.setdefault(e["pid"], e["role"] or f"pid{e['pid']}")
        if e["kind"] == "span":
            spans.append({
                "name": e["name"], "t_wall": e["t_wall"],
                "dur_s": e["dur_s"], "pid": e["pid"], "role": e["role"],
                "trace_id": e["trace_id"], "span_id": e["span_id"],
                "parent_span": e["data"].get("parent_span", ""),
                "status": e["data"].get("status", "ok"),
                "attrs": e["data"].get("attrs", {})})
        else:
            instants.append({
                "name": e["name"], "t_wall": e["t_wall"], "pid": e["pid"],
                "args": {"kind": e["kind"]}})
    return dump_chrome_trace(path, extra_spans=spans,
                             instant_events=instants,
                             process_names=names, include_buffer=False)
