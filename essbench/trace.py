"""Spans and the profiled slice of a traced run.

Spans are ``torch.profiler.record_function`` ranges opened by the
benchmark's own files around each call into a layer of the program
(``essbench.install``, ``essbench.step_round``, ``essbench.submit``,
``essbench.generic_decode``, ``essbench.sync``, ``essbench.bookkeeping``),
so they land in the profiler's trace on the kernels' clock.  Outside a
traced run a span is a no-op.

:class:`Slice` profiles a steady run of rounds and reduces the trace to
what the per-layer metrics read: each device activity's name and interval
(kernels and copies, graph replays' kernels included), the slice's own
interval, the device's busy time as the *union* of the activity intervals
(overlapping streams counted once), and the breakdown: device time by
operation and the idle gaps by the innermost span the host was in.
"""

from __future__ import annotations

import contextlib
import time

SPAN_PREFIX = "essbench."
TOP = 10


class Spans:
    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(SPAN_PREFIX + name)


def union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of ``[lo, hi]`` that no interval covers."""
    out, t = [], lo
    for a, b in sorted(intervals):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


class Slice:
    """Profile the rounds run inside ``with slice_:`` (CPU and CUDA
    activities); :meth:`reduce` reads the trace afterwards."""

    def __init__(self, device, sync):
        self.device = device
        self.sync = sync

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.rf = torch.profiler.record_function(SPAN_PREFIX + "slice")
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        self.wall = time.perf_counter() - self.t0
        self.rf.__exit__(None, None, None)
        self.prof.__exit__(*exc)
        return False

    def reduce(self) -> dict:
        """The reduced trace (read after the window: the profiler's own
        work stays out of it)."""
        data = reduce(self.prof.events(), self.wall)
        del self.prof
        return data


def reduce(events, wall_s: float) -> dict:
    """Device activities, host spans and the slice's interval (us) from a
    profiler's events; busy time, device time by operation and idle gaps
    by host span."""
    from torch.autograd import DeviceType
    kernels, spans = [], []
    lo = hi = None
    for ev in events:
        a, b = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            # a span's range is mirrored on the device's timeline; it is
            # no device work
            if b > a and not ev.name.startswith(SPAN_PREFIX) \
                    and not getattr(ev, "is_user_annotation", False):
                kernels.append((ev.name, a, b))
        elif ev.name == SPAN_PREFIX + "slice":
            lo, hi = a, b
        elif ev.name.startswith(SPAN_PREFIX):
            spans.append((ev.name[len(SPAN_PREFIX):], a, b))
    if lo is None:
        lo = min((a for _, a, _ in kernels), default=0.0)
        hi = lo + wall_s * 1e6
    kernels = [(n, max(a, lo), min(b, hi)) for n, a, b in kernels
               if b > lo and a < hi]
    iv = [(a, b) for _, a, b in kernels]
    busy = union_us(iv)
    by_op: dict[str, float] = {}
    for n, a, b in kernels:
        by_op[n] = by_op.get(n, 0.0) + (b - a)
    by_host: dict[str, float] = {}
    for a, b in gaps(iv, lo, hi):
        # split the gap where a span starts or ends; each piece goes to
        # the innermost span the host was in
        cuts = sorted({a, b} | {t for _, sa, sb in spans for t in (sa, sb)
                               if a < t < b})
        for p, q in zip(cuts, cuts[1:]):
            mid = 0.5 * (p + q)
            inner = [(sb - sa, name) for name, sa, sb in spans
                     if sa <= mid <= sb]
            name = min(inner)[1] if inner else "outside spans"
            by_host[name] = by_host.get(name, 0.0) + (q - p)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {"kernels": kernels, "window_s": (hi - lo) * 1e-6,
            "busy_s": busy * 1e-6,
            "breakdown": {"device_ops": [[n, us * 1e-6] for n, us in top],
                          "idle_gaps": [[n, us * 1e-6] for n, us in idle]}}


GEMM_NAMES = ("gemm", "nvjet", "gemv", "xmma", "cutlass", "splitk")
SPARSE_MLA_NAMES = ("sparse_mla_tc_kernel", "sparse_mla_partial_kernel",
                    "sparse_mla_merge_kernel")
INDEXER_NAMES = ("indexer_tc_kernel", "indexer_scores_kernel")
GATHER_NAMES = ("gather_rows_kernel", "gather_rows_dequant_kernel",
                "mark_rows_kernel", "fetch_marked_rows_kernel",
                "fetch_marked_rows_dequant_kernel")


def kernel_s(data: dict | None, names) -> float:
    """Seconds of device time of the slice's activities whose name holds
    one of ``names`` (case-insensitive)."""
    if data is None:
        return 0.0
    keys = [n.lower() for n in names]
    return 1e-6 * sum(b - a for n, a, b in data["kernels"]
                      if any(k in n.lower() for k in keys))
