"""netlint core: diagnostics, rule registry, renderers.

Counterpart of ``singa_tpu/lint/core.py``, the port's own copy. The
reference validated nothing statically: a bad ``srclayers`` edge or an
indivisible partition dim only surfaced as a worker crash deep inside
NeuralNet::ConstructNeuralNet / PartitionNeuralNet (reference:
src/worker/neuralnet.cc:72-323). netlint moves that whole failure class to
*before* execution: passes walk parsed configs (and, for the source
rules, the port's own Python) and emit ``Diagnostic`` records instead of
raising on the first problem, so one run reports every issue in a job file.

Severities:
  ERROR   — the job cannot run correctly; CLI exits non-zero.
  WARNING — runs, but with a documented degradation (e.g. the indivisible
            kLayerPartition dim that silently pads/replicates). Exit 0
            unless ``--strict``.
  INFO    — advisory (e.g. the kGaussain [sic] spelling note).

Every rule registers itself in ``RULES`` with its code, default severity,
and a one-line doc — ``python -m singa_tpu_torch.tools.lint --list-rules``
renders the table, making the rule set executable documentation of the
system's invariants.
"""

from __future__ import annotations

import dataclasses
import json

ERROR = "ERROR"
WARNING = "WARNING"
INFO = "INFO"

_SEVERITY_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}


@dataclasses.dataclass(frozen=True)
class Fix:
    """A machine-applicable single-token rewrite: replace ``old`` at
    (1-based) ``line``/``col`` of ``path`` with ``new``. Only attached
    when the fix is unambiguous (exactly one did-you-mean candidate)
    and the token's exact span is known — ``tools/lint.py --fix``
    re-verifies the text at the span before touching the file."""

    path: str
    line: int
    col: int
    old: str
    new: str


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: machine code + severity + location + message."""

    code: str
    severity: str
    loc: str  # "path", "path:layer=name", or "path:LINE:COL"
    msg: str
    fix_hint: str = ""
    #: optional machine-applicable rewrite (--fix); None = advisory only
    fix: Fix | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Rule:
    """Registry entry: metadata for one diagnostic code."""

    code: str
    severity: str
    doc: str


#: code -> Rule; populated by ``rule()`` at import time of the pass modules
RULES: dict[str, Rule] = {}


def rule(code: str, severity: str, doc: str) -> Rule:
    """Register (or fetch) a rule. Codes are stable API: tests and CI
    suppressions key on them, so never renumber."""
    assert severity in _SEVERITY_ORDER, severity
    r = Rule(code, severity, doc)
    existing = RULES.get(code)
    if existing is not None:
        assert existing == r, f"conflicting registration for {code}"
        return existing
    RULES[code] = r
    return r


class Collector:
    """Accumulates diagnostics for one lint run.

    ``ignore`` drops codes entirely (the CLI's --ignore). ``emit`` uses the
    rule's registered default severity unless overridden.
    """

    def __init__(self, ignore: set[str] | None = None):
        self.diagnostics: list[Diagnostic] = []
        self.ignore = ignore or set()

    def emit(
        self,
        r: Rule,
        loc: str,
        msg: str,
        *,
        fix_hint: str = "",
        severity: str | None = None,
        fix: Fix | None = None,
    ) -> None:
        if r.code in self.ignore:
            return
        self.diagnostics.append(
            Diagnostic(
                r.code, severity or r.severity, loc, msg, fix_hint, fix
            )
        )

    # ---------------- summary ----------------

    def count(self, severity: str) -> int:
        return sum(1 for d in self.diagnostics if d.severity == severity)

    def has_errors(self, *, strict: bool = False) -> bool:
        if strict:
            return any(
                d.severity in (ERROR, WARNING) for d in self.diagnostics
            )
        return any(d.severity == ERROR for d in self.diagnostics)

    def sorted(self) -> list[Diagnostic]:
        return sorted(
            self.diagnostics,
            key=lambda d: (_SEVERITY_ORDER[d.severity], d.loc, d.code),
        )


# --------------------------------------------------------------------------
# renderers
# --------------------------------------------------------------------------


def render_text(diags: list[Diagnostic]) -> str:
    """One line per finding, grep-friendly:
    ``SEVERITY CODE loc: msg [hint: ...]``"""
    lines = []
    for d in diags:
        line = f"{d.severity:<7} {d.code} {d.loc}: {d.msg}"
        if d.fix_hint:
            line += f" [hint: {d.fix_hint}]"
        lines.append(line)
    return "\n".join(lines)


def render_json(diags: list[Diagnostic]) -> str:
    """Machine-readable dump for CI annotation tooling."""
    return json.dumps(
        {
            "diagnostics": [d.to_dict() for d in diags],
            "counts": {
                s: sum(1 for d in diags if d.severity == s)
                for s in (ERROR, WARNING, INFO)
            },
        },
        indent=2,
    )


def render_rule_table() -> str:
    """--list-rules output: the invariant catalogue."""
    lines = ["CODE     SEVERITY  DESCRIPTION"]
    for code in sorted(RULES):
        r = RULES[code]
        lines.append(f"{code:<8} {r.severity:<9} {r.doc}")
    return "\n".join(lines)
