"""Reduction of a ``torch.profiler`` Chrome trace (the method of the
program's ``profiling.trace``: host and device activities, exported as a
Chrome trace) to what the per-layer metrics and the breakdown read.

* ``busy_s``: the union of the device's activity intervals (kernels, copies,
  sets), in seconds;
* ``launches``: the host's launch calls (runtime and driver calls whose name
  holds ``Launch``: kernel and graph launches);
* ``span_device_s``: for each of the benchmark's spans (``perfbench.*``) by
  name, the device time of each time it was entered: the union of the
  intervals of the device activities whose launch (matched by the trace's
  correlation id) the host made inside it, in seconds;
* ``device_ops``: the ten device operations that took most time, by name;
* ``idle_gaps``: the device's idle time between its activities, summed by
  what the host was doing at the middle of each gap (the innermost of the
  benchmark's spans and the innermost host operator around that moment),
  the ten largest.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation")
# a breakdown's name is cut to this many characters
NAME_CHARS = 96


def _events(path):
    data = json.loads(open(path).read())
    return data["traceEvents"] if isinstance(data, dict) else data


def _union(intervals):
    """Merged (start, end) intervals of a list, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(intervals, times):
    """For each of the sorted ``times``, the name of the innermost of the
    nested ``intervals`` (start, end, name) that holds it, or None: one
    sweep with a stack of the open intervals."""
    intervals = sorted(intervals, key=lambda x: (x[0], -x[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(intervals) and intervals[i][0] <= t:
            while stack and stack[-1][1] <= intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def _span_device_s(spans, calls, device_by_corr):
    """{span name: [device seconds of each entry]} of the benchmark's spans:
    the union of the device intervals launched, by correlation id, from a
    host call that started inside the entry.  The benchmark's spans of one
    name do not nest, so each call is inside at most one entry of a name."""
    out = {}
    names = sorted({name for _, _, name in spans if name.startswith("perfbench.")})
    for name in names:
        entries = sorted((s, e) for s, e, n in spans if n == name)
        starts = [s for s, _ in entries]
        intervals = [[] for _ in entries]
        for ts, corr in calls:
            k = bisect.bisect_right(starts, ts) - 1
            if k >= 0 and ts <= entries[k][1]:
                intervals[k].extend(device_by_corr.get(corr, ()))
        out[name] = [sum(e - s for s, e in _union(iv)) * 1e-6 for iv in intervals]
    return out


def reduce(path, steps):
    """The trace at ``path`` of a sub-window of ``steps`` ensemble steps, as
    a dict of the quantities in this module's docstring."""
    device, ops, launches = [], defaultdict(float), 0
    spans, host = [], defaultdict(list)
    calls, device_by_corr = [], defaultdict(list)
    for ev in _events(path):
        cat, dur = ev.get("cat"), ev.get("dur")
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATEGORIES and dur is not None:
            ts = float(ev["ts"])
            device.append((ts, ts + float(dur)))
            ops[ev["name"][:NAME_CHARS]] += float(dur) * 1e-6
            if corr is not None:
                device_by_corr[corr].append((ts, ts + float(dur)))
        elif cat in ("cuda_runtime", "cuda_driver"):
            launches += "Launch" in ev.get("name", "")
            if corr is not None:
                calls.append((float(ev["ts"]), corr))
        elif cat in HOST_CATEGORIES and dur is not None:
            ts = float(ev["ts"])
            item = (ts, ts + float(dur), ev["name"][:NAME_CHARS])
            if cat == "user_annotation":
                spans.append(item)
            else:
                host[ev.get("tid")].append(item)
    busy = _union(device)
    # the host's operators on the thread that ran most of them (the caller's)
    main = max(host.values(), key=len) if host else []
    mids = [0.5 * (end + start) for (_, end), (start, _) in zip(busy, busy[1:])]
    gaps = defaultdict(float)
    for (_, end), (start, _), span, op in zip(busy, busy[1:], _innermost(spans, mids),
                                              _innermost(main, mids)):
        label = "/".join(x for x in (span, op) if x)
        gaps[label or "host outside any operator"] += (start - end) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return dict(busy_s=sum(e - s for s, e in busy) * 1e-6, launches=launches,
                steps=steps, device_ops=top(ops), idle_gaps=top(gaps),
                span_device_s=_span_device_s(spans, calls, device_by_corr))
