"""CLI for the static analysis suite.

Check mode (the CI lint job)::

    python -m distkeras_torch.analysis [--strict] [paths...]
    python -m distkeras_torch.analysis --write-baseline

Report mode (findings as data; same exit-code contract as
``telemetry.report`` — bad input exits 2 with a one-line error, no
traceback; ``--rule`` inspects one pass's findings in isolation;
``--json`` also lists the rules that ran)::

    python -m distkeras_torch.analysis report [--json] [--rule R] [paths...]

Protocol mode (the wire-contract extraction rendered as the generated
op reference; ``--check`` fails on drift — the CI guard keeping the
port's ``distkeras_torch/analysis/PROTOCOL.md`` authoritative)::

    python -m distkeras_torch.analysis protocol [--out PATH] [--check [PATH]]

Defaults: scan the installed ``distkeras_torch`` package; the baseline
is ``baseline.txt`` and the op reference ``PROTOCOL.md``, both inside
this package (``distkeras_torch/analysis/``). Neither is looked up next
to the package or in the current directory: in a checkout both of those
are the repo root, which holds the reference package's
``analysis-baseline.txt``.

Exit codes, check mode: 0 = clean or everything baselined; 1 =
unbaselined findings under ``--strict`` (without it they are printed
as warnings) — or, also under ``--strict``, baseline entries whose
justification is empty or still ``TODO`` (the ledger must not rot);
2 = unusable input. Report mode never fails on findings — it only
reports them. Protocol mode exits 1 on ``--check`` drift, else 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import distkeras_torch
from distkeras_torch.analysis import (
    AnalysisError,
    Baseline,
    analyze,
    default_passes,
    split_by_baseline,
)

BASELINE_NAME = "baseline.txt"
HERE = os.path.dirname(os.path.abspath(__file__))
PROTOCOL_DOC = os.path.join(HERE, "PROTOCOL.md")


def default_root() -> str:
    """The installed package directory — scanning it yields the same
    ``distkeras_torch/...`` relative paths as scanning a checkout."""
    return os.path.dirname(os.path.abspath(distkeras_torch.__file__))


def default_baseline_path() -> str:
    """The port's baseline, inside this package."""
    return os.path.join(HERE, BASELINE_NAME)


def _resolve(args) -> tuple:
    roots = args.paths or [default_root()]
    bl_path = args.baseline or default_baseline_path()
    baseline = None
    if bl_path and not args.no_baseline:
        baseline = (Baseline.load(bl_path) if os.path.isfile(bl_path)
                    else Baseline(path=bl_path))
    return roots, bl_path, baseline


def _render_table(findings, out) -> None:
    for f in findings:
        out.write(f.render() + "\n")


def check_main(args) -> int:
    roots, bl_path, baseline = _resolve(args)
    findings = analyze(roots)
    if args.write_baseline:
        path = bl_path
        base = baseline or Baseline(path=path)
        n = base.write(path, findings)
        print(f"wrote {n} baseline entries to {path}")
        return 0
    new, accepted = split_by_baseline(findings, baseline)
    if new:
        _render_table(new, sys.stdout)
    stale = baseline.stale(findings) if baseline else []
    for fp in stale:
        print("stale baseline entry (fixed? remove it): "
              + "\t".join(fp))
    print(
        f"analysis: {len(findings)} finding(s) — {len(new)} new, "
        f"{len(accepted)} baselined"
        + (f", {len(stale)} stale baseline entr(y/ies)" if stale else "")
    )
    if new and args.strict:
        print("strict mode: unbaselined findings fail the build "
              "(suppress with '# analysis: <slug>' where justified, "
              "or baseline with --write-baseline + a justification)")
        return 1
    if args.strict and baseline is not None:
        unjust = baseline.unjustified()
        if unjust:
            for fp in unjust:
                print("unjustified baseline entry (replace the TODO "
                      "with a real justification): " + "\t".join(fp))
            print(f"strict mode: {len(unjust)} baseline entr(y/ies) "
                  f"without justification fail the build")
            return 1
    return 0


def report_main(args) -> int:
    roots, _bl_path, baseline = _resolve(args)
    findings = analyze(roots)
    if args.rule:
        findings = [f for f in findings if f.rule == args.rule]
    new, accepted = split_by_baseline(findings, baseline)
    if args.json:
        payload = {
            "roots": [os.path.abspath(r) for r in roots],
            "rules": [p.rule for p in default_passes()],
            "findings": [
                {"rule": f.rule, "path": f.path, "line": f.line,
                 "key": f.key, "message": f.message,
                 "baselined": baseline.accepts(f) if baseline else False}
                for f in findings
            ],
            "new": len(new),
            "baselined": len(accepted),
        }
        json.dump(payload, sys.stdout, indent=2)
        sys.stdout.write("\n")
        return 0
    if not findings:
        print("no findings")
        return 0
    width = max(len(f.rule) for f in findings)
    for f in findings:
        mark = "baselined" if baseline and baseline.accepts(f) else "NEW"
        print(f"{f.rule:<{width}}  {mark:<9}  {f.path}:{f.line}  "
              f"{f.message}")
    print(f"{len(findings)} finding(s): {len(new)} new, "
          f"{len(accepted)} baselined")
    return 0


def protocol_main(args) -> int:
    from distkeras_torch.analysis.core import iter_source_files
    from distkeras_torch.analysis.wire import (
        extract_protocol,
        render_protocol_md,
    )

    roots = args.paths or [default_root()]
    proto = extract_protocol(iter_source_files(roots))
    if proto.server is None and proto.client is None:
        raise AnalysisError(
            "no LMServer/ServingClient found under "
            + ", ".join(roots)
        )
    text = render_protocol_md(proto)
    if args.check:
        try:
            with open(args.check, encoding="utf-8") as fh:
                on_disk = fh.read()
        except OSError as e:
            raise AnalysisError(
                f"cannot read {args.check}: {e.strerror or e}"
            ) from None
        if on_disk != text:
            print(f"protocol drift: {args.check} does not match the "
                  f"extraction — regenerate with\n  python -m "
                  f"distkeras_torch.analysis protocol --out {args.check}")
            return 1
        print(f"{args.check} is up to date")
        return 0
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text)
        print(f"wrote {args.out}")
    else:
        sys.stdout.write(text)
    return 0


def _parser(mode: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m distkeras_torch.analysis"
             + (f" {mode}" if mode != "check" else ""),
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("paths", nargs="*",
                    help="files or package dirs to scan (default: the "
                         "installed distkeras_torch package)")
    if mode != "protocol":
        ap.add_argument("--baseline", default=None,
                        help=f"baseline file (default: "
                             f"distkeras_torch/analysis/{BASELINE_NAME})")
        ap.add_argument("--no-baseline", action="store_true",
                        help="ignore any baseline file")
    if mode == "report":
        ap.add_argument("--json", action="store_true",
                        help="emit findings as JSON instead of a table")
        ap.add_argument("--rule", default=None,
                        help="only findings of this rule (inspect one "
                             "pass in isolation, e.g. wire-contract)")
    elif mode == "protocol":
        ap.add_argument("--out", default=None,
                        help="write the generated op reference here "
                             "(default: stdout)")
        ap.add_argument("--check", default=None, metavar="PATH",
                        nargs="?", const=PROTOCOL_DOC,
                        help="compare against PATH (default: the port's "
                             "distkeras_torch/analysis/PROTOCOL.md) and "
                             "exit 1 on drift")
    else:
        ap.add_argument("--strict", action="store_true",
                        help="exit 1 on unbaselined findings or "
                             "unjustified baseline entries (CI mode)")
        ap.add_argument("--write-baseline", action="store_true",
                        help="regenerate the baseline from current "
                             "findings (keeps existing justifications)")
    return ap


_MODES = {"report": report_main, "protocol": protocol_main,
          "check": check_main}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    mode = "check"
    if argv and argv[0] in _MODES:
        mode = argv[0]
        argv = argv[1:]
    args = _parser(mode).parse_args(argv)
    try:
        return _MODES[mode](args)
    except AnalysisError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
