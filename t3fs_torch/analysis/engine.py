"""t3fslint engine: file collection, pragma/allowlist suppression, CLI glue.

Pure stdlib on purpose — the linter must run in CI environments (and
pre-commit hooks) without importing torch or any t3fs_torch runtime module.
"""

from __future__ import annotations

import ast
import io
import tokenize
from dataclasses import dataclass, field
from pathlib import Path

from t3fs_torch.analysis.rules import (
    ALL_RULES,
    DEFAULT_RULES,
    TEST_RULES,
    lint_module,
)

PRAGMA_PREFIX = "t3fslint:"
ALLOWLIST_NAME = "allowlist.txt"

# trees linted with the full rule set vs. the test subset
FULL_TREES = ("t3fs_torch",)
SUBSET_TREES = ("tests", "benchmarks")


@dataclass(frozen=True)
class Finding:
    path: str          # repo-relative, forward slashes
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"


@dataclass
class LintResult:
    findings: list[Finding] = field(default_factory=list)
    suppressed: int = 0
    files: int = 0
    errors: list[str] = field(default_factory=list)   # unparsable files

    @property
    def ok(self) -> bool:
        return not self.findings and not self.errors


def _pragma_map(source: str) -> dict[int, set[str]]:
    """line -> rule ids allowed on that line.

    ``# t3fslint: allow(rule-a, rule-b)`` suppresses matching findings on
    its own line and, when the comment stands alone, on the line below
    (so long pragmas can sit above the statement they annotate).
    """
    allows: dict[int, set[str]] = {}
    code_lines: set[int] = set()
    try:
        toks = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return allows
    for tok in toks:
        if tok.type == tokenize.COMMENT:
            text = tok.string.lstrip("#").strip()
            if not text.startswith(PRAGMA_PREFIX):
                continue
            body = text[len(PRAGMA_PREFIX):].strip()
            # trailing text after the paren is a justification, ignored:
            #   # t3fslint: allow(rule) — why this is deliberate
            end = body.find(")")
            if not body.startswith("allow(") or end < 0:
                continue
            rules = {r.strip() for r in body[len("allow("):end].split(",")}
            rules.discard("")
            allows.setdefault(tok.start[0], set()).update(rules)
        elif tok.type not in (tokenize.NL, tokenize.NEWLINE,
                              tokenize.INDENT, tokenize.DEDENT,
                              tokenize.ENCODING, tokenize.ENDMARKER):
            code_lines.add(tok.start[0])
    # standalone pragma comments also cover the next line
    for line in list(allows):
        if line not in code_lines:
            allows.setdefault(line + 1, set()).update(allows[line])
    return allows


@dataclass(frozen=True)
class AllowlistEntry:
    path: str                 # repo-relative path the entry applies to
    rule: str
    substring: str = ""       # optional message substring match

    def matches(self, f: Finding) -> bool:
        return (f.path == self.path and f.rule == self.rule
                and (not self.substring or self.substring in f.message))


def load_allowlist(path: Path) -> list[AllowlistEntry]:
    """Parse ``<relpath>:<rule>[:<substring>]`` lines; '#' comments and
    blanks skipped.  Ships empty — see the package docstring."""
    entries: list[AllowlistEntry] = []
    if not path.exists():
        return entries
    for raw in path.read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split(":", 2)
        if len(parts) < 2:
            continue
        entries.append(AllowlistEntry(
            path=parts[0].strip(),
            rule=parts[1].strip(),
            substring=parts[2].strip() if len(parts) == 3 else ""))
    return entries


def lint_source(source: str, rel_path: str,
                rules: frozenset[str]) -> tuple[list[Finding], int]:
    """Lint one module's source. Returns (unsuppressed, n_suppressed)."""
    tree = ast.parse(source)
    allows = _pragma_map(source)
    out: list[Finding] = []
    suppressed = 0
    for raw in lint_module(tree, rules):
        if any(raw.rule in allows.get(line, ())
               for line in (raw.line, *raw.also_lines)):
            suppressed += 1
            continue
        out.append(Finding(rel_path, raw.line, raw.rule, raw.message))
    return out, suppressed


def _rules_for(rel_path: str) -> frozenset[str]:
    top = rel_path.split("/", 1)[0]
    if top in SUBSET_TREES:
        return TEST_RULES
    return DEFAULT_RULES


def _collect(root: Path, paths: list[Path] | None) -> list[Path]:
    if paths:
        files: list[Path] = []
        for p in paths:
            if p.is_dir():
                files.extend(sorted(p.rglob("*.py")))
            elif p.suffix == ".py":
                files.append(p)
        return files
    files = []
    for tree in FULL_TREES + SUBSET_TREES:
        base = root / tree
        if base.is_dir():
            files.extend(sorted(base.rglob("*.py")))
    return files


def lint_paths(root: Path, paths: list[Path] | None = None,
               allowlist: list[AllowlistEntry] | None = None) -> LintResult:
    """Lint files under ``root`` (the repo root). ``paths`` restricts the
    scan; rule sets are chosen per-file from its tree (t3fs_torch/ = full,
    tests/ + benchmarks/ = subset)."""
    if allowlist is None:
        allowlist = load_allowlist(
            root / "t3fs_torch" / "analysis" / ALLOWLIST_NAME)
    result = LintResult()
    for f in _collect(root, paths):
        try:
            rel = f.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        try:
            source = f.read_text()
        except OSError as e:
            result.errors.append(f"{rel}: unreadable ({e})")
            continue
        try:
            findings, suppressed = lint_source(source, rel, _rules_for(rel))
        except SyntaxError as e:
            result.errors.append(f"{rel}:{e.lineno} unparsable: {e.msg}")
            continue
        result.files += 1
        result.suppressed += suppressed
        for finding in findings:
            if any(entry.matches(finding) for entry in allowlist):
                result.suppressed += 1
            else:
                result.findings.append(finding)
    result.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return result


def lint_tree(root: Path) -> LintResult:
    """Lint the whole repo tree rooted at ``root``."""
    return lint_paths(root, None)


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="t3fslint",
        description="protocol-aware static analysis for the t3fs "
                    "asyncio data plane")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files or directories to lint "
                         "(default: t3fs_torch/, tests/, benchmarks/)")
    ap.add_argument("--root", type=Path, default=Path.cwd(),
                    help="repo root for relative paths + allowlist "
                         "(default: cwd)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(rule)
        return 0

    result = lint_paths(args.root, args.paths or None)
    for finding in result.findings:
        print(finding.render())
    for err in result.errors:
        print(f"ERROR {err}")
    tail = (f"t3fslint: {result.files} files, "
            f"{len(result.findings)} finding(s), "
            f"{result.suppressed} suppressed")
    print(tail)
    return 0 if result.ok else 1
