"""``python -m repro_torch.analysis`` — lint the port's tree (ESS001,
ESS002) and, with ``--audit``, run the runtime audits (ESS102-ESS107) on
the smoke config; compare the findings against an optional baseline.

Exit status, as the reference's: 0 when no finding outside the baseline,
1 when any new finding (or, with ``--strict-stale``, any stale baseline
entry), 2 on usage errors.  The port's tree is clean with no baseline:
inline ``# esslint: disable=`` comments are its only suppressions.

    PYTHONPATH=src python -m repro_torch.analysis
    PYTHONPATH=src python -m repro_torch.analysis --audit --device cpu
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.analysis.findings import (findings_to_json, load_baseline,
                                           split_against_baseline,
                                           write_baseline)
from repro_torch.analysis.lint import lint_tree


def _default_root() -> pathlib.Path:
    # src/repro_torch/analysis/__main__.py -> repo root
    return pathlib.Path(__file__).resolve().parents[3]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="esslint for the port: AST rules over src/repro_torch "
                    "and runtime audits of the serve contracts")
    p.add_argument("--baseline", default=None,
                   help="baseline file of acknowledged findings (default: "
                        "none)")
    p.add_argument("--write-baseline", action="store_true",
                   help="write the current findings to --baseline")
    p.add_argument("--json", metavar="PATH",
                   help="also write all findings as JSON")
    p.add_argument("--strict-stale", action="store_true",
                   help="also fail on stale baseline entries")
    p.add_argument("--audit", action="store_true",
                   help="also run the runtime audits on the smoke config")
    p.add_argument("--device", default=None,
                   help="the audits' device (default: the CUDA card; "
                        "'cpu' runs the eager path)")
    p.add_argument("--root", default=None,
                   help="repo root (default: inferred from the package)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.write_baseline and not args.baseline:
        print("--write-baseline needs --baseline PATH", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root) if args.root else _default_root()

    findings = lint_tree(root)
    if args.audit:
        from repro_torch.analysis import audit
        found, counts = audit.run_all(device=args.device)
        findings += found
        for name, c in counts.items():
            print(f"audit {name}: {json.dumps(c, sort_keys=True)}")

    if args.json:
        pathlib.Path(args.json).write_text(findings_to_json(findings))

    if args.write_baseline:
        write_baseline(args.baseline, findings)
        print(f"baseline written: {len(findings)} finding(s) -> "
              f"{args.baseline}")
        return 0

    baseline = load_baseline(args.baseline) if args.baseline else set()
    new, known, stale = split_against_baseline(findings, baseline)
    for f in sorted(new, key=lambda f: (f.path, f.line, f.rule)):
        print(f.format())
    if known:
        print(f"[{len(known)} baselined finding(s) suppressed]")
    if stale:
        print(f"[{len(stale)} stale baseline entr(ies) — fixed or moved; "
              f"prune with --write-baseline]")
    if new:
        print(f"esslint: {len(new)} new finding(s)")
        return 1
    if stale and args.strict_stale:
        return 1
    print("esslint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
