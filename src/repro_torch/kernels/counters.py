"""The kernel wrappers' launch counters, read and moved as one.

Each wrapper counts its launches in attributes named ``launches*`` on the
wrapper function: plain integers, or dicts of integers keyed by shape
(``indexer_scores.launches_by_q``, ``partial_attend.launches_by_shape``).
They count on the host where a wrapper launches its kernel, so a CUDA
graph replay, which launches the captured kernels without the wrappers,
moves none of them.  :class:`repro_torch.serving.step.StepPrograms`
records what a capture counted (:func:`diff`), takes it back
(:func:`restore`: a capture launches nothing) and adds it on every replay
(:func:`add`).
"""

from __future__ import annotations

from repro_torch.kernels.gather_cache import ops as gops
from repro_torch.kernels.indexer import ops as iops
from repro_torch.kernels.sparse_mla import ops as sops

WRAPPERS = (gops.gather_rows, gops.gather_rows_dequant,
            gops.gather_rows_raw, gops.scatter_rows,
            gops.gather_pages, gops.gather_pages_dequant, gops.put_pages,
            iops.indexer_scores, sops.partial_attend, sops.merge_splits)


def _attrs(fn):
    return [a for a in vars(fn) if a.startswith("launches")]


def snapshot() -> dict:
    """Every counter's value, dicts copied."""
    return {(fn.__name__, a): (dict(v) if isinstance(v, dict) else v)
            for fn in WRAPPERS for a in _attrs(fn)
            for v in [getattr(fn, a)]}


def diff(after: dict, before: dict) -> dict:
    """What the counters gained from ``before`` to ``after``."""
    out = {}
    for key, v in after.items():
        b = before[key]
        if isinstance(v, dict):
            out[key] = {k: n - b.get(k, 0) for k, n in v.items()
                        if n != b.get(k, 0)}
        else:
            out[key] = v - b
    return out


def restore(snap: dict) -> None:
    """Set every counter back to ``snap`` (dicts in place: callers hold
    references to them)."""
    for fn in WRAPPERS:
        for a in _attrs(fn):
            v = snap[(fn.__name__, a)]
            if isinstance(v, dict):
                d = getattr(fn, a)
                d.clear()
                d.update(v)
            else:
                setattr(fn, a, v)


def add(delta: dict) -> None:
    """Add a :func:`diff` to the counters."""
    for fn in WRAPPERS:
        for a in _attrs(fn):
            v = delta[(fn.__name__, a)]
            if isinstance(v, dict):
                d = getattr(fn, a)
                for k, n in v.items():
                    d[k] = d.get(k, 0) + n
            else:
                setattr(fn, a, getattr(fn, a) + v)
