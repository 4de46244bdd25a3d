"""Machine-readable findings + a baseline file (the port's copy of
``repro.analysis.findings``, the same fingerprint).

A :class:`Finding` is one violation of a checked contract — produced by
the AST lint (:mod:`repro_torch.analysis.lint`) or a runtime audit
(:mod:`repro_torch.analysis.audit`).  Findings serialize to JSON
for tooling and compare against a **baseline** file so pre-existing
(acknowledged) violations are tracked without failing CI, while any NEW
violation does fail.

Baseline entries are line-number-free fingerprints
(``rule|path|scope|snippet``): moving code within a file never churns
the baseline; editing the flagged line (or fixing it) does.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str                  # "ESS001", "ESS002" or an audit rule id
    path: str                  # repo-relative posix path (or target name)
    line: int                  # 1-based; 0 for whole-program audit findings
    scope: str                 # enclosing qualname ("<module>" at top level)
    message: str               # human-readable, one line
    snippet: str = ""          # stripped source line (fingerprint anchor)

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}|{self.path}|{self.scope}|{self.snippet}"

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.rule} [{self.scope}] {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def findings_to_json(findings: Iterable[Finding]) -> str:
    fs = sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    return json.dumps({"findings": [f.to_dict() for f in fs],
                       "count": len(fs)}, indent=2) + "\n"


def load_baseline(path) -> set[str]:
    """Read a baseline file -> set of fingerprints (empty if missing)."""
    try:
        with open(path) as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return set()
    return set(data.get("fingerprints", []))


def write_baseline(path, findings: Iterable[Finding]) -> None:
    fps = sorted({f.fingerprint for f in findings})
    with open(path, "w") as fh:
        json.dump({"comment": "esslint baseline: acknowledged pre-existing "
                              "findings. Regenerate with python -m "
                              "repro_torch.analysis --write-baseline.",
                   "fingerprints": fps}, fh, indent=2)
        fh.write("\n")


def split_against_baseline(findings: Iterable[Finding], baseline: set[str]
                           ) -> tuple[list[Finding], list[Finding],
                                      set[str]]:
    """-> (new, known, stale): findings not in / in the baseline, and
    baseline fingerprints no longer produced (fixed or moved — prune them
    with ``--write-baseline``)."""
    new, known, seen = [], [], set()
    for f in findings:
        (known if f.fingerprint in baseline else new).append(f)
        seen.add(f.fingerprint)
    return new, known, baseline - seen
