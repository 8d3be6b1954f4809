"""Reduce a ``torch.profiler`` trace of the traced stretch to what the
per-layer metrics read.

The device-event arithmetic is ``chip_smoke.py``'s ``device_events``:
kernel, copy and set events read from the exported Chrome trace, kept
once per correlation id (one per launch), and the device's busy time the
union of their intervals, so events that overlap on several streams
count once.  On top of it:

* a span's device time is the union of the intervals of the device
  events launched while it was open (kernels of one span may run side by
  side on several streams): an event's launch is the host's runtime or
  driver call with the same correlation id, and the span is a
  ``record_function`` range on the harness's thread;
* the idle gaps are the stretches inside the traced window in which no
  device event ran, each named by the innermost span and the outermost
  host op open at its middle;
* the program's own ranges (``program_spans``): every range on the
  harness's thread whose name starts with ``PROGRAM_PREFIX``, found by
  the prefix, so that a range the program adds needs no edit here; each
  with its count, its host time (the union of its ranges) and its device
  time, attributed as a span's;
* the collectives: ``collective_s`` the union of the intervals of the
  device events whose name starts with ``COLLECTIVE_PREFIX`` (NCCL's
  kernels, waiting for their peers included), ``collective_exposed_s``
  the part of it in which no other device event ran.

``merge`` folds the reductions of several ranks into one.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List

__all__ = ["STRETCH", "reduce_trace", "merge"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the record_function range the harness opens around the traced blocks
STRETCH = "chipbench.traced"
# the program's ranges (``repro_torch.core.spans``) and NCCL's kernels
PROGRAM_PREFIX = "repro_torch."
COLLECTIVE_PREFIX = "nccl"


def _device_events(trace: List[dict]) -> List[dict]:
    events = {}
    for e in trace:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        corr = e.get("args", {}).get("correlation")
        key = (corr, e["name"]) if corr is not None else \
            (e["name"], e["ts"], e["dur"])
        events.setdefault(key, e)
    return sorted(events.values(), key=lambda ev: ev["ts"])


def _busy_intervals(events, lo: float, hi: float):
    """Union of the events' intervals, clipped to [lo, hi] (µs)."""
    out: List[List[float]] = []
    for e in events:
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _overlap(xs, ys) -> float:
    """The length of the intersection of two sorted, disjoint interval
    lists."""
    total, j = 0.0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            total += max(0.0, min(b, ys[k][1]) - max(a, ys[k][0]))
            k += 1
    return total


def _launched_under(events, launch_ts, rs):
    """The events launched while one of the ranges ``rs`` (sorted
    ``(start, end)`` pairs) was open."""
    starts = [a for a, _ in rs]
    mine = []
    for e in events:
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= rs[i][1]:
            mine.append(e)
    return mine


def _top_level(ops):
    """The host ops not nested in another (``ops`` sorted by start)."""
    out = []
    for o in ops:
        if out and o["ts"] < out[-1]["ts"] + out[-1]["dur"]:
            continue
        out.append(o)
    return out


def _host_context(spans, tops, top_starts, t: float) -> str:
    """The innermost span and the outermost host op open at time t."""
    span = "outside spans"
    for s in spans:                       # sorted by start: later ones nest
        if s["ts"] > t:
            break
        if s["ts"] + s["dur"] >= t and s["name"] != STRETCH:
            span = s["name"]
    i = bisect.bisect_right(top_starts, t) - 1
    op = "python"
    if i >= 0 and tops[i]["ts"] + tops[i]["dur"] >= t:
        op = tops[i]["name"]
    return f"{span} / {op}"


def reduce_trace(path: str, span_names) -> Dict:
    """Read the exported trace at ``path``: the traced stretch
    (``STRETCH``), the device's busy time inside it, the device time
    under each of ``span_names``, the HtoD copies' time, the top device
    ops and idle gaps, the program's ranges and the collectives
    (seconds)."""
    with open(path) as f:
        trace = json.load(f)["traceEvents"]
    stretch = [e for e in trace if e.get("name") == STRETCH
               and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not stretch:
        raise RuntimeError(f"the trace has no {STRETCH!r} range")
    st = stretch[0]
    lo, hi, tid = st["ts"], st["ts"] + st["dur"], st.get("tid")
    events = [e for e in _device_events(trace) if lo <= e["ts"] <= hi]
    busy = _busy_intervals(events, lo, hi)
    busy_us = sum(b - a for a, b in busy)

    # launches on the harness's thread, by correlation id
    launch_ts = {}
    for e in trace:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") \
                and e.get("ph") == "X":
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
    spans = sorted((e for e in trace if e.get("cat") == "user_annotation"
                    and e.get("ph") == "X" and e.get("tid") == tid
                    and lo <= e["ts"] <= hi),
                   key=lambda e: e["ts"])
    span_us = {name: 0.0 for name in span_names}
    found = {name: 0 for name in span_names}
    ranges = defaultdict(list)
    for s in spans:
        if s["name"] in span_us:
            ranges[s["name"]].append((s["ts"], s["ts"] + s["dur"]))
            found[s["name"]] += 1
    unlaunched = sum(1 for e in events if e.get("args", {}).get(
        "correlation") not in launch_ts)
    for name, rs in ranges.items():
        mine = _launched_under(events, launch_ts, rs)
        span_us[name] = sum(b - a for a, b in
                            _busy_intervals(mine, lo, float("inf")))
    prog = defaultdict(list)
    for s in spans:
        if s["name"].startswith(PROGRAM_PREFIX):
            prog[s["name"]].append((s["ts"], s["ts"] + s["dur"]))
    program_spans = {}
    for name, rs in sorted(prog.items()):
        host = []
        for a, b in rs:                   # sorted by start
            if host and a <= host[-1][1]:
                host[-1][1] = max(host[-1][1], b)
            else:
                host.append([a, b])
        mine = _launched_under(events, launch_ts, rs)
        program_spans[name] = {
            "count": len(rs), "host_s": _length(host) / 1e6,
            "device_s": _length(_busy_intervals(mine, lo,
                                                float("inf"))) / 1e6}
    coll = _busy_intervals([e for e in events if e["name"].startswith(
        COLLECTIVE_PREFIX)], lo, hi)
    other = _busy_intervals([e for e in events if not e["name"].startswith(
        COLLECTIVE_PREFIX)], lo, hi)
    h2d_us = sum(b - a for a, b in _busy_intervals(
        [e for e in events if e.get("cat") == "gpu_memcpy"
         and "HtoD" in e["name"]], lo, float("inf")))

    per_op = defaultdict(float)
    for e in events:
        per_op[e["name"]] += e["dur"]
    tops = _top_level(sorted(
        (e for e in trace if e.get("cat") == "cpu_op" and e.get("ph") == "X"
         and e.get("tid") == tid and lo <= e["ts"] <= hi),
        key=lambda e: e["ts"]))
    top_starts = [o["ts"] for o in tops]
    gaps = defaultdict(float)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps[_host_context(spans, tops, top_starts,
                               (a + b) / 2)] += b - a
    top = lambda d: [[k, v / 1e6] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    streams = defaultdict(lambda: [0, 0.0])
    for e in events:
        sid = e.get("args", {}).get("stream", e.get("tid"))
        streams[sid][0] += 1
        streams[sid][1] += e["dur"] / 1e6
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy_us / 1e6,
            "device_sum_s": sum(e["dur"] for e in events) / 1e6,
            "streams": {str(k): v for k, v in streams.items()},
            "unlaunched": unlaunched,
            "span_device_s": {k: v / 1e6 for k, v in span_us.items()},
            "span_count": found, "h2d_s": h2d_us / 1e6,
            "device_ops": top(per_op), "idle_gaps": top(gaps),
            "n_device_events": len(events),
            "program_spans": program_spans,
            "collective_s": _length(coll) / 1e6,
            "collective_exposed_s": (_length(coll)
                                     - _overlap(coll, other)) / 1e6}


# the seconds of a reduction that ``merge`` takes as the largest over the
# ranks; every other key is rank 0's
_SECONDS = ("busy_s", "device_sum_s", "h2d_s", "collective_s",
            "collective_exposed_s")


def merge(reductions: List[Dict]) -> Dict:
    """One reduction from each rank's, in rank order: every seconds field
    the largest over the ranks (the slowest rank's), by span and by
    program range too; the window, the counts, the streams, the top
    device ops and the idle gaps rank 0's.  One rank's comes back as it
    is."""
    if len(reductions) == 1:
        return reductions[0]
    out = dict(reductions[0])
    for k in _SECONDS:
        out[k] = max(r[k] for r in reductions)
    out["span_device_s"] = {k: max(r["span_device_s"][k] for r in reductions)
                            for k in out["span_device_s"]}
    names = sorted({k for r in reductions for k in r["program_spans"]})
    out["program_spans"] = {}
    for k in names:
        has = [r["program_spans"][k] for r in reductions
               if k in r["program_spans"]]
        base = reductions[0]["program_spans"].get(k, has[0])
        out["program_spans"][k] = {
            "count": base["count"],
            "host_s": max(x["host_s"] for x in has),
            "device_s": max(x["device_s"] for x in has)}
    return out
