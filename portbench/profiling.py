"""Where a window's time goes on the device, from ``torch.profiler``.

The method of ``chip_smoke.py``'s ``profile_pass`` and ``profile_run``:
the run under the profiler with CPU and CUDA activities, the device's
operations (kernels and copies; the annotation ranges that span kernels
already counted are left out), and up to three traces taken where one holds
no device operation (PERF.md: late in a long process the profiler has
returned traces without device events). Added here: busy time as the union
of the operations' intervals, so that overlapping copies count once; the
idle gaps between them, each named by the innermost host event running at
its middle; and device time by kernel family.
"""

from __future__ import annotations

import bisect
import time
from collections import Counter

# the port's hand kernels (ops/csrc/*.cu), by the prefix of their names
HAND_KERNELS = ("fused_gin_conv", "sorted_segment_sum", "sorted_scatter_gather")
K3_NAME = "fused_gin_conv"
ATTEMPTS = 3
NAMED_GAPS = 500  # the longest gaps named by the host; the rest summed as one


def family(name: str) -> str:
    if any(k in name for k in HAND_KERNELS):
        return "hand"
    return "torch"


def _union(intervals: list) -> tuple:
    """Total length of the union of ``(start, end)`` intervals, and the gaps
    between them as ``(start, end)``."""
    total, gaps, cur = 0.0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            total += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


def _host_label(host: list, starts: list, t: float) -> str:
    """The innermost host event spanning time ``t``: host events nest, so it
    is the latest-starting one that has not ended by ``t``. ``host`` is
    sorted by start, ``starts`` its starts."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if host[i][1] >= t:
            return host[i][2]
    return "host Python between traced calls"


def profile(run, sync, on_cpu: bool = False) -> dict:
    """``run()`` under the profiler (``sync()`` before and after it): the
    window's wall seconds, the device's busy seconds, device seconds by
    kernel family and of K3, K3's launches, the top device operations and
    the idle gaps summed by what the host was doing, in seconds.
    ``on_cpu`` (the harness's own tests, which have no card): the top-level
    host operations stand in for the device's, so that the reading runs;
    its numbers are no device's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for attempt in range(1, ATTEMPTS + 1):
        sync()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            sync()
            wall = time.perf_counter() - t0
        events = prof.events()
        if on_cpu:
            on_card = [e for e in events if e.device_type == DeviceType.CPU
                       and not e.is_user_annotation and e.cpu_parent is None]
        else:
            on_card = [e for e in events
                       if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        if on_card:
            break
        print(f"profile: trace {attempt} of {ATTEMPTS} held no device operation", flush=True)
    else:
        raise RuntimeError("the profiler traced no device operation in three attempts")
    busy_us, gaps = _union([(e.time_range.start, e.time_range.end) for e in on_card])
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CPU)
    starts = [h[0] for h in host]
    by_name, by_family = Counter(), Counter()
    k3_launches = 0
    for e in on_card:
        took = (e.time_range.end - e.time_range.start) if on_cpu else e.device_time
        by_name[e.name[:96]] += took / 1e6
        by_family[family(e.name)] += took / 1e6
        k3_launches += K3_NAME in e.name
    idle = Counter()
    gaps.sort(key=lambda g: g[0] - g[1])
    for s, e in gaps[:NAMED_GAPS]:
        idle[_host_label(host, starts, (s + e) / 2)[:96]] += (e - s) / 1e6
    if len(gaps) > NAMED_GAPS:
        idle[f"{len(gaps) - NAMED_GAPS} shorter gaps, not named"] += sum(
            e - s for s, e in gaps[NAMED_GAPS:]) / 1e6
    return {
        "window_s": wall,
        "busy_s": busy_us / 1e6,
        "family_s": dict(by_family),
        "k3_s": sum(v for k, v in by_name.items() if K3_NAME in k),
        "k3_launches": k3_launches,
        "device_ops": [[k, v] for k, v in by_name.most_common(10)],
        "idle_gaps": [[k, v] for k, v in idle.most_common(10)],
    }
