"""Checker framework for the repo-native static analysis suite.

The serving/telemetry stack's correctness rests on conventions that
ordinary linters cannot see: which attributes a class's lock guards,
which jitted call sites donate their buffers, how RNG keys may be
consumed, what must stay hashable on a compile-cache key path, and
which layers are declared stdlib-only. ARCHITECTURE.md states those
invariants as prose; this package states them as executable passes over
the stdlib ``ast`` module — no third-party parser, so the analyzer can
run anywhere the package imports.

The pieces:

- :class:`Finding` — one violation: rule id, file, line, a stable
  ``key`` (the fingerprint baselines match on — class+attr, function
  name, import name — chosen to survive line-number churn), and a
  human message.
- :class:`SourceFile` — one parsed module: source text, AST, and the
  per-line suppression map (``# analysis: <slug>`` comments on the
  finding line or the line above silence that rule there).
- :class:`Pass` — the checker protocol: ``rule`` id, ``suppression``
  slug, ``run(src) -> findings``.
- :class:`Baseline` — the checked-in ledger of accepted findings
  (``analysis-baseline.txt``): tab-separated ``rule / path / key /
  justification`` lines. A finding matching a baseline entry is
  *accepted*, not new; ``--write-baseline`` regenerates the file,
  preserving justifications for keys that persist.
- :func:`analyze` — walk files, run passes, drop suppressed findings.

Paths in findings are recorded relative to each scan root's parent
directory (scanning ``<repo>/distkeras_torch`` or an installed
``site-packages/distkeras_torch`` both yield ``distkeras_torch/...``), so
one baseline file applies to a checkout and to the installed package.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple


class AnalysisError(Exception):
    """Unusable input (missing path, unparseable file): the CLI prints
    the message and exits 2 — same contract as ``telemetry.report``."""


@dataclass(frozen=True)
class Finding:
    """One rule violation at one site.

    ``key`` is the baseline fingerprint: stable across reformatting and
    line churn (e.g. ``ClassName.attr`` for lock findings), so accepted
    findings stay accepted until the code they describe changes shape.
    """

    rule: str
    path: str
    line: int
    key: str
    message: str

    def fingerprint(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.key)

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# ``# analysis: slug`` or ``# analysis: slug-a, slug-b (reason...)``
_SUPPRESS_RE = re.compile(r"#\s*analysis:\s*([a-z0-9_,\s-]+)")


class SourceFile:
    """One parsed python file plus its suppression-comment map."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        try:
            self.tree = ast.parse(text, filename=path)
        except SyntaxError as e:
            raise AnalysisError(
                f"cannot parse {rel}:{e.lineno}: {e.msg}"
            ) from None
        # line -> suppression slugs declared on that line
        self.suppressions: Dict[int, Set[str]] = {}
        for lineno, line in enumerate(text.splitlines(), 1):
            m = _SUPPRESS_RE.search(line)
            if m:
                slugs = {s.strip() for s in m.group(1).split(",")}
                self.suppressions[lineno] = {s for s in slugs if s}

    def suppressed(self, line: int, slug: str) -> bool:
        """True when ``slug`` is declared on the finding's line or the
        line immediately above (comment-above style for long lines)."""
        for ln in (line, line - 1):
            if slug in self.suppressions.get(ln, ()):
                return True
        return False


class Pass:
    """Checker protocol. Subclasses set ``rule`` (the finding id) and
    ``suppression`` (the comment slug that silences it) and implement
    :meth:`run`."""

    rule = "abstract"
    suppression = "abstract-ok"

    def run(self, src: SourceFile) -> Iterable[Finding]:
        raise NotImplementedError


class ProjectPass(Pass):
    """A pass whose contract spans files: wire protocol arms live in
    ``server.py`` *and* ``router.py``, a metric family is declared in
    one module and observed in another. Instead of per-file ``run``,
    a project pass sees the whole scanned file set at once and emits
    findings against any of them (suppression comments still apply at
    each finding's own line)."""

    def run(self, src: SourceFile) -> Iterable[Finding]:
        return ()  # project passes only run in run_project

    def run_project(self, srcs: Sequence[SourceFile]) -> Iterable[Finding]:
        raise NotImplementedError


@dataclass
class Baseline:
    """The checked-in ledger of accepted findings with justifications."""

    path: Optional[str] = None
    # fingerprint -> justification
    entries: Dict[Tuple[str, str, str], str] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        entries: Dict[Tuple[str, str, str], str] = {}
        try:
            with open(path) as fh:
                for lineno, line in enumerate(fh, 1):
                    line = line.rstrip("\n")
                    if not line.strip() or line.lstrip().startswith("#"):
                        continue
                    parts = line.split("\t", 3)
                    if len(parts) < 3:
                        raise AnalysisError(
                            f"{path}:{lineno}: baseline lines are "
                            f"rule<TAB>path<TAB>key<TAB>justification; "
                            f"got {line!r}"
                        )
                    rule, rel, key = parts[0], parts[1], parts[2]
                    just = parts[3] if len(parts) > 3 else ""
                    entries[(rule, rel, key)] = just
        except OSError as e:
            raise AnalysisError(
                f"cannot read baseline {path}: {e.strerror or e}"
            ) from None
        return cls(path=path, entries=entries)

    def accepts(self, finding: Finding) -> bool:
        return finding.fingerprint() in self.entries

    def stale(self, findings: Sequence[Finding]) -> List[Tuple[str, str, str]]:
        """Baseline entries no fresh finding matches — candidates for
        removal (the code they excused has been fixed or moved)."""
        live = {f.fingerprint() for f in findings}
        return sorted(fp for fp in self.entries if fp not in live)

    def unjustified(self) -> List[Tuple[str, str, str]]:
        """Entries whose justification is empty or still the
        ``TODO: justify`` marker ``--write-baseline`` stamps on new
        keys. ``--strict`` fails on these: an accepted finding nobody
        has explained is a rotting ledger entry, not an acceptance."""
        return sorted(
            fp for fp, just in self.entries.items()
            if not just.strip() or just.strip().upper().startswith("TODO")
        )

    def write(self, path: str, findings: Sequence[Finding]) -> int:
        """Regenerate the baseline from ``findings``: persisting keys
        keep their justification, new keys get a TODO marker a
        maintainer must replace. Returns the entry count written."""
        fps = sorted({f.fingerprint() for f in findings})
        with open(path, "w") as fh:
            fh.write(
                "# distkeras-tpu static-analysis baseline — accepted "
                "findings.\n"
                "# One per line: rule<TAB>path<TAB>key<TAB>justification"
                "\n# Regenerate with: python -m distkeras_torch.analysis "
                "--write-baseline\n"
            )
            for fp in fps:
                just = self.entries.get(fp, "TODO: justify")
                fh.write("\t".join(fp) + "\t" + just + "\n")
        return len(fps)


def iter_source_files(roots: Sequence[str]) -> List[SourceFile]:
    """Collect ``SourceFile``s under each root (a .py file or a package
    directory). Relative paths are taken against each root's parent so
    scans of a checkout and of an installed package agree."""
    out: List[SourceFile] = []
    for root in roots:
        root = os.path.abspath(root)
        if os.path.isfile(root):
            base = os.path.dirname(root)
            paths = [root]
        elif os.path.isdir(root):
            base = os.path.dirname(root.rstrip(os.sep))
            paths = []
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d != "__pycache__" and not d.startswith(".")
                )
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        paths.append(os.path.join(dirpath, fn))
        else:
            raise AnalysisError(f"no such file or directory: {root}")
        for p in paths:
            rel = os.path.relpath(p, base).replace(os.sep, "/")
            try:
                with open(p, encoding="utf-8") as fh:
                    text = fh.read()
            except (OSError, UnicodeDecodeError) as e:
                raise AnalysisError(f"cannot read {p}: {e}") from None
            out.append(SourceFile(p, rel, text))
    return out


def analyze(roots: Sequence[str],
            passes: Optional[Sequence[Pass]] = None) -> List[Finding]:
    """Run every pass over every file under ``roots``; suppressed
    findings are dropped here so callers only ever see live ones."""
    if passes is None:
        from distkeras_torch.analysis import default_passes

        passes = default_passes()
    findings: List[Finding] = []
    srcs = iter_source_files(roots)
    by_rel = {src.rel: src for src in srcs}
    for src in srcs:
        for p in passes:
            for f in p.run(src):
                if not src.suppressed(f.line, p.suppression):
                    findings.append(f)
    for p in passes:
        if isinstance(p, ProjectPass):
            for f in p.run_project(srcs):
                src = by_rel.get(f.path)
                if src is None or not src.suppressed(f.line, p.suppression):
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.key))
    return findings


def split_by_baseline(findings: Sequence[Finding],
                      baseline: Optional[Baseline],
                      ) -> Tuple[List[Finding], List[Finding]]:
    """(new, accepted) under the baseline (everything is new without
    one)."""
    if baseline is None:
        return list(findings), []
    new = [f for f in findings if not baseline.accepts(f)]
    accepted = [f for f in findings if baseline.accepts(f)]
    return new, accepted
