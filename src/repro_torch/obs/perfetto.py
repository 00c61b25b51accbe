"""Chrome-trace (Perfetto) export of a :class:`~.trace.TaskTrace`.

Emits the Trace Event Format JSON that https://ui.perfetto.dev (and
chrome://tracing) loads directly: one process per chip, one thread
track per worker lane, every task an "X" complete event.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List

from .trace import TaskTrace

__all__ = ["chrome_trace", "validate_chrome_trace", "write_chrome_trace"]

#: observed traces carry logical ticks; one tick is shown as 1 us so that
#: Perfetto's timeline (which assumes microseconds) renders readably
_TICK_US = 1.0


def chrome_trace(trace: TaskTrace) -> Dict[str, Any]:
    """The trace as a Trace Event Format object (``traceEvents`` +
    metadata), ready for ``json.dump``."""
    events: List[Dict[str, Any]] = []
    for chip in range(max(1, trace.n_chips)):
        events.append({"ph": "M", "name": "process_name", "pid": chip,
                       "args": {"name": f"chip{chip}"}})
    for chip, w in sorted({(e.chip, e.worker) for e in trace.events}):
        events.append({"ph": "M", "name": "thread_name", "pid": chip,
                       "tid": w, "args": {"name": f"worker{w}"}})
    for e in trace.events:
        args: Dict[str, Any] = {"task": e.task, "row": e.row,
                                "kind": e.kind}
        if e.wait_ev >= 0:
            args["wait_ev"] = e.wait_ev
            args["wait_cnt"] = e.wait_cnt
        if e.sig_ev >= 0:
            args["sig_ev"] = e.sig_ev
        if e.source >= 0:
            args["pop_source"] = ("own", "overflow", "steal")[e.source]
        events.append({
            "ph": "X", "name": e.name, "cat": trace.origin,
            "pid": e.chip, "tid": e.worker,
            "ts": e.start * _TICK_US,
            "dur": max((e.end - e.start) * _TICK_US, 1e-3),
            "args": args,
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "origin": trace.origin,
            "scheduler": trace.scheduler,
            "num_workers": trace.num_workers,
            "n_chips": trace.n_chips,
            **trace.meta,
        },
    }


def validate_chrome_trace(obj: Any) -> List[str]:
    """Schema check of a Chrome-trace object (or its JSON string);
    returns a list of problems (empty = valid).  Covers the subset the
    exporter emits: "X" needs ts/dur/name/pid/tid, "M" needs name/args,
    "s"/"f" need matching ids and timestamps."""
    problems: List[str] = []
    if isinstance(obj, str):
        try:
            obj = json.loads(obj)
        except json.JSONDecodeError as exc:
            return [f"not JSON: {exc}"]
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["missing traceEvents"]
    flows: Dict[Any, List[str]] = {}
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict) or "ph" not in ev:
            problems.append(f"event {i}: not a phase dict")
            continue
        ph = ev["ph"]
        if ph == "X":
            for key in ("name", "ts", "dur", "pid", "tid"):
                if key not in ev:
                    problems.append(f"event {i}: X missing {key!r}")
            if ev.get("dur", 0) <= 0:
                problems.append(f"event {i}: non-positive dur")
        elif ph == "M":
            for key in ("name", "args"):
                if key not in ev:
                    problems.append(f"event {i}: M missing {key!r}")
        elif ph in ("s", "f"):
            if "id" not in ev or "ts" not in ev:
                problems.append(f"event {i}: flow missing id/ts")
            else:
                flows.setdefault(ev["id"], []).append(ph)
        else:
            problems.append(f"event {i}: unknown phase {ph!r}")
    for fid, phases in flows.items():
        if sorted(phases) != ["f", "s"]:
            problems.append(f"flow {fid}: unpaired phases {phases}")
    try:
        json.dumps(obj)
    except (TypeError, ValueError) as exc:
        problems.append(f"not JSON-serializable: {exc}")
    return problems


def write_chrome_trace(trace: TaskTrace, path: str) -> Dict[str, Any]:
    """Export ``trace`` to ``path`` as Perfetto-loadable JSON; returns
    the exported object (already validated)."""
    obj = chrome_trace(trace)
    problems = validate_chrome_trace(obj)
    assert not problems, problems
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return obj
