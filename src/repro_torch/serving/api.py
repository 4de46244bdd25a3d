"""The serving API's stream element (the port's own copy of
``TokenEvent`` from ``repro.serving.api``; the ``EssEngine`` front-end
over it is not ported yet)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One element of a request's incremental result stream.

    Token events carry ``token`` with ``finish_reason=None``; the single
    terminal event carries ``finish_reason`` with ``token=None`` and
    ``index`` = the final stream length.  ``t`` is a
    ``time.perf_counter`` stamp at delivery."""
    rid: int
    token: Optional[int]
    index: int
    finish_reason: Optional[str] = None
    t: float = 0.0

    @property
    def is_terminal(self) -> bool:
        return self.finish_reason is not None
