"""The traced run's device trace: one ``torch.profiler`` window, read into
the device's busy time, its activities, the kernels' time by name, and the
idle gaps by what the host was doing (the harness's own ranges, or the
runtime call under way).

``torch.profiler`` drops device activities late in a long process, and saw a
CUDA-graph WHILE node's body once a replay when the graph was captured
before the process's first profiler session; so a traced run opens one
empty session before its first capture (``open_session``) and profiles a
short window right after its warm-up.
"""
from __future__ import annotations

import re
import subprocess
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch


def activities(device, host: bool = True):
    """The profiler's activities: the device's, and the host's ops where
    ``host`` (recording them slows the host several-fold, so a window that
    times the device records the device alone)."""
    from torch.profiler import ProfilerActivity
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    return acts


def open_session(device) -> None:
    """One empty profiler session (see the module's docstring)."""
    from torch.profiler import profile
    with profile(activities=activities(device)):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()


def card_clock() -> Optional[str]:
    """The card's name, SM clock, power draw and limit, as nvidia-smi reads
    them (None where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def profile(run: Callable[[], Dict], device, host: bool = False) -> Dict:
    """Run ``run`` (a window that ends in a drain and returns its numbers)
    under the profiler, recording the device's activities and, with
    ``host``, the host's ops too.  Returns its numbers with ``trace``:
    ``busy_s`` (None where the profiler saw no device activity),
    ``wall_s``, ``activities``, ``kernels`` {name: [seconds, calls]} and
    ``idle`` {what the host was doing: seconds idle} (with ``host``)."""
    from torch.profiler import profile as prof_ctx
    with prof_ctx(activities=activities(device, host)) as prof:
        out = run()
    dev_type = torch.autograd.DeviceType.CUDA
    dev, host = [], defaultdict(list)
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if getattr(ev, "is_user_annotation", False) or \
                ev.name.startswith("liobench."):
            if ev.device_type == dev_type:
                continue  # a host range mirrored on the device's timeline
        if ev.device_type == dev_type:
            dev.append((s, e))
            k = kernels[ev.name]
            k[0] += (e - s) * 1e-6
            k[1] += 1
        else:
            host[ev.thread].append((s, -e, ev.name))
    merged = _union(dev)
    busy = sum(e - s for s, e in merged) * 1e-6 if merged else None
    out["trace"] = dict(busy_s=busy, wall_s=out["wall_s"],
                        activities=len(dev), kernels=dict(kernels),
                        idle=_idle_by_host(merged, host))
    return out


def _idle_by_host(merged, host) -> Dict[str, float]:
    """Each gap between device activity, summed by the innermost host event
    under way at its middle on the harness's thread (the one with most
    ``liobench.`` ranges)."""
    idle: Dict[str, float] = defaultdict(float)
    if not merged or not host:
        return dict(idle)
    main = max(host, key=lambda t: sum(n.startswith("liobench.")
                                       for _s, _e, n in host[t]))
    events = sorted(host[main])
    stack: List = []
    j = 0
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        while j < len(events) and events[j][0] <= mid:
            s, neg_e, name = events[j]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((-neg_e, name))
            j += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        idle[stack[-1][1] if stack else "no host event"] += (s1 - e0) * 1e-6
    return dict(idle)


def kernel_time(trace: Dict, pattern: str):
    """(seconds, calls) of the kernels whose names match ``pattern``, and
    the calls by each match's first group (e.g. a template argument)."""
    rx = re.compile(pattern)
    secs, calls, by = 0.0, 0, defaultdict(int)
    for name, (s, n) in trace["kernels"].items():
        m = rx.search(name)
        if m:
            secs += s
            calls += n
            by[m.group(1) if m.groups() else ""] += n
    return secs, calls, dict(by)


def breakdown(trace: Dict) -> Dict:
    """The ten device operations that took most time, and the ten largest
    idle totals by what the host was doing: [[name, seconds], ...]."""
    ops = sorted(trace["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(trace["idle"].items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ops=[[n[:200], v[0]] for n, v in ops],
                idle_gaps=[[n[:200], v] for n, v in gaps])
