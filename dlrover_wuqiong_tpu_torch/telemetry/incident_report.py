"""Incident-timeline report: ONE JSON line for the operator.

Parity: tools/incident_report.py and the rc/error contract of the JAX
package's common/report_cli.py, copied into the port (the tool imports
the JAX package).  Two sources, one byte-identical timeline
(telemetry/timeline.py):

    python -m dlrover_wuqiong_tpu_torch.telemetry.incident_report \\
        [--addr HOST:PORT] [--ckpt DIR]
    python -m dlrover_wuqiong_tpu_torch.telemetry.incident_report \\
        --journal DIR[,DIR2] [--flight CKPT_DIR]

Live mode asks the master (`TimelineQuery`, POLLING class) to assemble
the timeline from its own journal directory plus the flight dumps under
``--ckpt`` (``--flight`` when only that is given), and folds the
journal-shipping gauges (shipped_seq, standby_lag_frames, lease_epoch,
is_leader) into the summary line.  Offline mode runs the SAME assembler
over the disk artifacts alone — a post-mortem needs no process alive.
Because the assembler is a pure function of the artifacts, the two
produce byte-equal canonical JSON; ``timeline_sha256`` in the summary
line is the proof handle (the chaos drills compare it with the live
bytes).

``--journal`` takes a comma-separated dir list for a failover's
post-mortem (the old primary's dir and the promoted standby's): the
journals merge in (epoch, seq) order with the byte-identical shipped
frames deduped; a live `MasterClient.get_timeline` given the same
ordered list (the answering master's own dir first) gives the same
bytes.  The offline flags win over ``--addr``.

``--events-out FILE`` writes the canonical incident JSON; ``--perfetto
FILE`` a chrome://tracing / Perfetto trace of the whole incident.

Summary fields: source bookkeeping, event/span/trace/epoch/process
counts, incidents with their lost seconds, failovers, goodput_fraction
and timeline_sha256.  One JSON line ALWAYS: rc 2 when a live query has
no address (``--addr`` or ``DWT_MASTER_ADDR``), rc 1 on any failure,
rc 0 on success; ``-h`` prints this text to stderr.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Sequence

from .timeline import (
    assemble_incident,
    export_perfetto,
    incident_json,
    incident_sha256,
)

VALUE_FLAGS = ("--addr", "--journal", "--flight", "--ckpt", "--perfetto",
               "--events-out")


def parse_value_flags(argv: Sequence[str]) -> Dict[str, Optional[str]]:
    """``--flag VALUE`` pairs (unknown args are ignored, as the JAX
    tools' parser does); ``-h``/``--help`` maps to itself."""
    vals: Dict[str, Optional[str]] = {}
    it = iter(argv)
    for a in it:
        if a in ("-h", "--help"):
            vals["--help"] = a
        elif a in VALUE_FLAGS:
            vals[a] = next(it, None)
    return vals


def summarize(content: str, src: dict) -> dict:
    """The one-line summary of a canonical incident JSON."""
    report = json.loads(content)
    counts = report.get("counts", {})
    narr = report.get("narrative", {})
    incidents = narr.get("incidents", [])
    line = dict(src)
    line.update({
        "schema": report.get("schema"),
        "events": counts.get("events", 0),
        "journal_events": counts.get("journal_events", 0),
        "flight_events": counts.get("flight_events", 0),
        "spans": counts.get("spans", 0),
        "traces": counts.get("traces", 0),
        "epochs": len(counts.get("epochs", [])),
        "processes": len(counts.get("processes", [])),
        "incidents": len(incidents),
        "failovers": sum(1 for i in incidents
                         if i.get("kind") == "failover"),
        "lost_s": round(sum(float(i.get("lost_s", 0.0))
                            for i in incidents), 3),
        "goodput_fraction": narr.get("goodput_fraction"),
        "policy_decisions": narr.get("policy_decisions", 0),
        "timeline_sha256": incident_sha256(content),
    })
    return line


def _sinks(content: str, vals: dict) -> None:
    out = vals.get("--events-out")
    if out:
        with open(out, "w", encoding="utf-8") as f:
            f.write(content)
    perf = vals.get("--perfetto")
    if perf:
        export_perfetto(json.loads(content), perf)


def _journal_dirs(vals: dict) -> List[str]:
    return [d.strip() for d in (vals.get("--journal") or "").split(",")
            if d.strip()]


def from_disk(vals: dict) -> dict:
    dirs = _journal_dirs(vals)
    flight = vals.get("--flight") or ""
    for d in dirs:
        if not os.path.isdir(d):
            raise FileNotFoundError(f"--journal: {d!r} is not a directory")
    if flight and not os.path.isdir(flight):
        raise FileNotFoundError(f"--flight: {flight!r} is not a directory")
    content = incident_json(assemble_incident(
        journal_dir=dirs[0] if dirs else "", ckpt_dir=flight,
        journal_dirs=dirs[1:]))
    _sinks(content, vals)
    return summarize(content, {"source": "disk",
                               "journal_dir": ",".join(dirs),
                               "ckpt_dir": flight})


def from_master(addr: str, vals: dict) -> dict:
    from ..agent.master_client import MasterClient

    ckpt = vals.get("--ckpt") or vals.get("--flight") or ""
    mc = MasterClient(addr, node_id=-1)
    try:
        resp = mc.get_timeline(ckpt_dir=ckpt,
                               journal_dirs=_journal_dirs(vals))
        try:
            stats = mc.get_journal_stats()
            gauges = {"shipped_seq": stats.shipped_seq,
                      "standby_lag_frames": stats.standby_lag_frames,
                      "lease_epoch": stats.lease_epoch,
                      "is_leader": stats.is_leader}
        except Exception:  # noqa: BLE001 — gauges are best-effort garnish;
            # the timeline answer is the deliverable
            gauges = {}
    finally:
        mc.close()
    _sinks(resp.content, vals)
    return summarize(resp.content, {"source": "master", "addr": addr,
                                    "ckpt_dir": ckpt, **gauges})


def main(argv: Optional[Sequence[str]] = None) -> int:
    vals = parse_value_flags(argv if argv is not None else sys.argv[1:])
    if "--help" in vals:
        print(__doc__, file=sys.stderr)
        return 0
    try:
        addr = vals.get("--addr") or os.getenv("DWT_MASTER_ADDR", "")
        if vals.get("--journal") or vals.get("--flight"):
            report = from_disk(vals)
        elif addr:
            report = from_master(addr, vals)
        else:
            print(json.dumps({"error": "no master address: pass --addr, "
                                       "set DWT_MASTER_ADDR, or use "
                                       "--journal DIR [--flight CKPT_DIR]"}))
            return 2
    except Exception as e:  # noqa: BLE001 — the JSON contract beats purity
        print(json.dumps({"error": repr(e)[:500]}))
        return 1
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
