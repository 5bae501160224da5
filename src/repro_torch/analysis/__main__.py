"""CLI: ``python -m repro_torch.analysis [--gate] [--baseline FILE] ...``.

Exit status under ``--gate``: 0 when every finding is either absent or
suppressed by the baseline AND the baseline carries no stale entries;
1 otherwise.  Without ``--gate`` it prints findings and always exits 0
(exploration mode).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.engine import (
    BASELINE_NAME, PACKAGE, Project, all_rules, load_baseline, run_rules,
    split_by_baseline,
)
from repro_torch.analysis import wire_schema


def _find_repo_root(start: Path) -> Path:
    """Walk up until a directory containing ``src/repro_torch`` appears."""
    cur = start.resolve()
    for cand in (cur, *cur.parents):
        if (cand / "src" / PACKAGE).is_dir():
            return cand
    raise SystemExit(f"cannot locate a src/{PACKAGE} tree above {start}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's invariant lint: recompute purity, wire "
                    "schema drift, unpickler allowlist, hot-path pickle, "
                    "lock discipline, writes after publish")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: auto-detect from this file)")
    ap.add_argument("--gate", action="store_true",
                    help="exit nonzero on any non-baselined finding")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="suppression file of finding keys (default: "
                    f"<root>/{BASELINE_NAME} when present)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings to the baseline file "
                    "and exit")
    ap.add_argument("--write-wire-lock", action="store_true",
                    help=f"regenerate src/{PACKAGE}/net/wire_schema.lock from "
                    "the live schema and exit")
    ap.add_argument("--rule", action="append", default=None,
                    metavar="NAME", help="run only this rule (repeatable); "
                    "known: " + ", ".join(n for n, _ in all_rules()))
    args = ap.parse_args(argv)

    root = args.root or _find_repo_root(Path(__file__).parent)
    project = Project.from_root(root)

    if args.write_wire_lock:
        sf = project.get(wire_schema.WIRE_MODULE)
        if sf is None:
            print("wire module not found", file=sys.stderr)
            return 2
        schema = wire_schema.extract_schema(sf.tree)
        lock_path = root / "src" / PACKAGE / "net" / "wire_schema.lock"
        lock_path.write_text(wire_schema.render_lock(schema))
        print(f"wrote {lock_path} (version {schema['version']})")
        return 0

    known = {n for n, _ in all_rules()}
    if args.rule:
        unknown = set(args.rule) - known
        if unknown:
            print("unknown rule(s): " + ", ".join(sorted(unknown)),
                  file=sys.stderr)
            return 2

    findings = run_rules(project, only=args.rule)

    baseline_path = args.baseline
    if baseline_path is None:
        default = root / BASELINE_NAME
        if default.exists():
            baseline_path = default

    if args.write_baseline:
        target = args.baseline or (root / BASELINE_NAME)
        target.write_text(
            "# repro_torch.analysis baseline — one finding key per line.\n"
            "# Keys are line-number free: rule|module|message.\n"
            + "".join(f.key + "\n" for f in findings))
        print(f"wrote {len(findings)} key(s) to {target}")
        return 0

    baseline = load_baseline(baseline_path) if baseline_path else set()
    new, suppressed, stale = split_by_baseline(findings, baseline)

    for f in new:
        print(f.render(project))
    if suppressed:
        print(f"[baseline] {len(suppressed)} finding(s) suppressed",
              file=sys.stderr)
    for key in sorted(stale):
        print(f"[baseline] stale entry (no longer fires): {key}",
              file=sys.stderr)

    if not args.gate:
        return 0
    if new:
        print(f"\nFAIL: {len(new)} finding(s); fix them or record "
              "accepted debt with --write-baseline", file=sys.stderr)
        return 1
    if stale:
        print(f"\nFAIL: {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'}; regenerate with "
              "--write-baseline", file=sys.stderr)
        return 1
    print("analysis gate: clean", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
