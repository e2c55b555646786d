"""Spans, op ranges and the reading of a profiler trace.

``span`` marks a phase of the benchmark's own loop (a ``record_function``
range).  ``profile`` runs a piece of the loop under ``torch.profiler``
(CPU and CUDA activities) and reads from its trace:

* the device's busy seconds, the union of every kernel, copy and set
  interval inside the window, and the window's length;
* the kernels launched, and the ten device ops that took most time;
* the ten longest idle gaps' totals by what the host was doing: the
  innermost host op running at each gap's middle, after the phase of the
  loop (``train``, ``val``);
* each op range that a per-layer metric declares (``RANGE =
  "module:function"``): the benchmark wraps that public entry of the port
  in a ``record_function`` range for the traced piece, records each
  call's argument shapes, and sums the device time of every kernel
  launched inside each call's range (matched through the launches'
  correlation ids), so a redesign that splits or renames kernels reads
  the same work.

``device_time`` runs a piece of the loop under the profiler with the
device's activity alone (no host ops recorded, so the host runs at
nearly its own pace) and reads the device's busy seconds.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import os
import re
import tempfile

import torch
from torch.profiler import ProfilerActivity, record_function

from bench_port import manifest

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def span(name: str):
    return record_function(f"bench::{name}")


def describe(a):
    """A call's arguments with every tensor replaced by its shape."""
    if torch.is_tensor(a):
        return list(a.shape)
    if isinstance(a, dict):
        return {k: describe(v) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return [describe(x) for x in a]
    if a is None or isinstance(a, (bool, int, float, str)):
        return a
    return type(a).__name__


@contextlib.contextmanager
def wrapped(ranges: list, calls: dict):
    """Each "module:function" of ``ranges`` wrapped in a range of its own
    for the duration; each call's described arguments appended to
    ``calls[key]``."""
    saved = []
    try:
        for key in ranges:
            mod_name, attr = key.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            calls[key] = []

            def wrapper(*args, _fn=fn, _key=key, **kwargs):
                calls[_key].append({"args": describe(args),
                                    "kwargs": describe(kwargs)})
                with record_function(f"bench_range::{_key}"):
                    return _fn(*args, **kwargs)

            saved.append((mod, attr, fn))
            setattr(mod, attr, wrapper)
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def short_name(name: str) -> str:
    """A kernel's name without its return type, arguments, template and
    namespaces."""
    bare = name.replace("(anonymous namespace)::", "")
    words = re.sub(r"<.*", "", re.sub(r"\(.*", "", bare)).split()
    short = words[-1].split("::")[-1] if words else ""
    return (short or name)[:100]


def device_busy(events: list) -> float:
    """The busy seconds of a trace's device events: the union of every
    kernel, copy and set interval."""
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("ph") == "X" and "ts" in e
                   and e.get("cat") in _DEVICE_CATS])
    return sum(b - a for a, b in busy) * 1e-6


def _chrome_events(prof) -> list:
    fd, path = tempfile.mkstemp(prefix="bench_port_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def device_time(fn, device) -> float:
    """``fn`` under the profiler with the device's activity alone: the
    device's busy seconds."""
    torch.cuda.synchronize(device)
    with torch.profiler.profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    busy_s = device_busy(_chrome_events(prof))
    if not busy_s:
        raise RuntimeError("the profiler recorded no device activity")
    return busy_s


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(intervals: list, points: list) -> list:
    """For each point (sorted), the name of the innermost of the properly
    nested ``intervals`` (start, end, name) that holds it, or None."""
    ivs = sorted(intervals, key=lambda x: (x[0], -x[1]))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(ivs) and ivs[i][0] <= p:
            while stack and stack[-1][1] <= ivs[i][0]:
                stack.pop()
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def read_trace(events: list, ranges: list, top: int = 10) -> dict:
    """The readings of a chrome trace's events (see the module
    docstring); times in seconds.  The benchmark's ranges are read from
    the host's user annotations (the trace repeats them on the device's
    timeline)."""
    x = [e for e in events if e.get("ph") == "X" and "ts" in e
         and (e.get("cat") == "user_annotation"
              or not str(e.get("name", "")).startswith("bench"))]
    window = [e for e in x if e.get("name") == "bench::window"]
    if not window:
        raise ValueError("no bench::window range in the trace")
    w = window[0]
    ws, we, main = float(w["ts"]), float(w["ts"]) + float(w["dur"]), w["tid"]
    device = [e for e in x if e.get("cat") in _DEVICE_CATS
              and ws <= float(e["ts"]) < we]
    busy = _union([(float(e["ts"]), min(float(e["ts"]) + float(e["dur"]),
                                        we)) for e in device])
    busy_us = sum(b - a for a, b in busy)
    by_name = {}
    for e in device:
        key = short_name(e["name"])
        by_name[key] = by_name.get(key, 0.0) + float(e["dur"]) * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    # idle gaps, by phase and the innermost host op at their middle
    gaps, prev = [], ws
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if we > prev:
        gaps.append((prev, we))
    mids = [(a + b) / 2 for a, b in gaps]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in x if e.get("tid") == main
            and e.get("cat") in ("cpu_op",) + _LAUNCH_CATS]
    phases = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
               e["name"].split("::", 1)[1]) for e in x
              if e.get("tid") == main and e.get("name") in
              ("bench::train_call", "bench::val")]
    ops = _innermost(host, mids)
    phase = _innermost(phases, mids)
    idle = {}
    for (a, b), op, ph in zip(gaps, ops, phase):
        key = f"{ph or 'loop'}:{op or 'python'}"
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-6
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]

    # op ranges: the device time of the kernels each call launched
    dev_by_corr = {}
    for e in x:
        if e.get("cat") in _DEVICE_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                dev_by_corr[c] = dev_by_corr.get(c, 0.0) + float(e["dur"])
    launches = {}
    for e in x:
        if e.get("cat") in _LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None and c in dev_by_corr:
                launches.setdefault(e["tid"], []).append((float(e["ts"]), c))
    for v in launches.values():
        v.sort()
    out_ranges = {}
    for key in ranges:
        inst = sorted((e for e in x if e.get("name") ==
                       f"bench_range::{key}"), key=lambda e: e["ts"])
        times = []
        for e in inst:
            lst = launches.get(e["tid"], [])
            a = bisect.bisect_left(lst, (float(e["ts"]), -1))
            b = bisect.bisect_right(lst, (float(e["ts"]) + float(e["dur"]),
                                          float("inf")))
            times.append(sum(dev_by_corr[c] for _, c in lst[a:b]) * 1e-6)
        out_ranges[key] = times
    return {"busy_s": busy_us * 1e-6, "window_s": (we - ws) * 1e-6,
            "kernels": sum(1 for e in device if e.get("cat") == "kernel"),
            "device_ops": device_ops, "idle_gaps": idle_gaps,
            "range_times": out_ranges}


def profile(fn, steps: int, per_layer: list, device) -> dict:
    """``fn`` under the profiler, with the op ranges that the cell's
    per-layer metrics declare; the trace's readings, each range's calls
    with their arguments and device seconds, and ``steps``."""
    ranges = sorted({r for m in per_layer
                     for r in getattr(manifest.metric_reader(m["name"]),
                                      "RANGES", ())})
    calls = {}
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with wrapped(ranges, calls):
        with torch.profiler.profile(activities=activities) as prof:
            with record_function("bench::window"):
                fn()
                torch.cuda.synchronize(device)
    out = read_trace(_chrome_events(prof), ranges)
    out["ranges"] = {}
    for key in ranges:
        times = out["range_times"][key]
        if len(times) != len(calls[key]):
            raise ValueError(f"{len(calls[key])} calls of {key} but "
                             f"{len(times)} ranges in the trace")
        out["ranges"][key] = [dict(c, device_s=t)
                              for c, t in zip(calls[key], times)]
    del out["range_times"]
    out["steps"] = steps
    return out
