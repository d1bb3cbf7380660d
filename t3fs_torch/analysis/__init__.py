"""t3fslint: protocol-aware static analysis for the asyncio data plane.

The native components get reference-parity TSan/ASan coverage (`make
sanitize`, docs/sanitize_report.md), but TSan sees nothing in the ~40k
lines of asyncio Python where this repo's actual concurrency hazards
live: awaits inside critical sections, fire-and-forget tasks the GC can
reap mid-flight, `except` clauses that eat cancellation, thread locks
held across awaits, and IOResult statuses dropped on the floor.  This
package is the static twin of the runtime detectors in
`t3fs_torch/testing/race.py` — purpose-built rules grounded in bugs this
codebase has had (tail-commits-first redelivery, fence races) or is
structurally prone to, not a generic flake8 clone.

Usage::

    python -m t3fs_torch.analysis            # lint the tree, exit 1 on findings
    python -m t3fs_torch.analysis --list-rules
    python -m t3fs_torch.analysis t3fs_torch/net   # lint a subtree

Suppression: inline ``# t3fslint: allow(rule-id)`` pragmas on (or on the
line above) the offending line, plus the checked-in allowlist
``t3fs_torch/analysis/allowlist.txt`` (which ships empty — new findings are
fixed or explicitly pragma'd with a justification, never silently
allowlisted).  Rule catalog: docs/static_analysis.md.

The port of t3fs/analysis/, a copy with its imports re-pointed that lints
t3fs_torch/ with the full rule set.  Every rule and pragma keeps its name,
so the two linters read the same `t3fslint: allow(...)` pragmas and give
the same findings on the same source.
"""

from t3fs_torch.analysis.engine import Finding, LintResult, lint_paths, lint_tree
from t3fs_torch.analysis.rules import ALL_RULES, DEFAULT_RULES, TEST_RULES

__all__ = [
    "ALL_RULES", "DEFAULT_RULES", "TEST_RULES",
    "Finding", "LintResult", "lint_paths", "lint_tree",
]
