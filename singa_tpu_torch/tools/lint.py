"""netlint CLI: static validation for job configs and the port's source
lint.

Counterpart of ``singa_tpu/tools/lint.py``, with its flags, exit codes
and JSON keys. Usage:
  python -m singa_tpu_torch.tools.lint examples/                 # every conf
  python -m singa_tpu_torch.tools.lint job.conf --cluster c.conf # + sharding
  python -m singa_tpu_torch.tools.lint --self                    # AST pass
                                                                 # over
                                                                 # singa_tpu_torch/
  python -m singa_tpu_torch.tools.lint --list-rules              # rule table
  python -m singa_tpu_torch.tools.lint job.conf --cluster c.conf --explain-cost
                                                                 # cost report
  python -m singa_tpu_torch.tools.lint job.conf --fix [--dry-run]
                                                                 # did-you-mean
                                                                 # rewrites

Paths may be .conf files, .py files, or directories (recursively linting
both kinds). Model vs cluster confs are told apart by their fields
(``nworkers``/``workspace`` mark a cluster conf). Sharding divisibility
rules (SHD*) need mesh axis widths, so they run only when ``--cluster``
supplies a cluster conf. Nothing here touches a device: the shape pass
runs the forward on ``torch.device("meta")``.

Exit status: 0 = no ERROR diagnostics (WARNING/INFO allowed), 1 = at
least one ERROR (or any WARNING under ``--strict``), 2 = usage error.
Suppress codes globally with ``--ignore CODE[,CODE]``; suppress AST
findings per line with ``# netlint: disable=CODE``.
"""

from __future__ import annotations

import argparse
import difflib
import os
import sys
import tempfile

from ..config import textproto
from ..lint import (
    Collector,
    elastic_rules,
    engine_rules,
    lint_cluster_text,
    lint_model_text,
    lint_python_file,
    render_json,
    render_rule_table,
    render_text,
    ring_rules,
    sharding_rules_static,
)
from ..lint.ast_rules import walk_source_files
from ..lint.cost_model import (
    DEFAULT_COMM_FRACTION,
    cost_rules,
    render_cost_report,
)
from ..lint.net_rules import CFG000
from ..lint.shape_rules import shape_pass


def _is_cluster_raw(raw: dict) -> bool:
    return "nworkers" in raw or "workspace" in raw


def _lint_conf(
    path: str, col: Collector, widths: dict[str, int] | None,
    cluster_cfg=None, comm_fraction: float = DEFAULT_COMM_FRACTION,
    reports: list | None = None,
) -> None:
    try:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
    except OSError as e:
        col.emit(CFG000, path, f"cannot read: {e}")
        return
    try:
        raw = textproto.parse(text)
    except textproto.TextProtoError as e:
        col.emit(CFG000, path, str(e))
        return
    if _is_cluster_raw(raw):
        lint_cluster_text(text, path, col, raw=raw)
        return
    errors_before = col.count("ERROR")
    model_cfg = lint_model_text(text, path, col, raw=raw)
    if model_cfg is None:
        return
    # engine-compatibility checks need the cluster conf itself (engine
    # selection reads nservers/synchronous, not the axis widths);
    # ring_rules additionally reads the data-axis width for the
    # chunk-divisibility arm (KRN002)
    engine_rules(model_cfg, cluster_cfg, path, col)
    ring_rules(model_cfg, cluster_cfg, widths, path, col)
    # elastic-restore admission (ELA001) needs the target mesh's axis
    # widths, so it rides --cluster like the SHD*/KRN002 width arms
    elastic_rules(model_cfg, widths, path, col)
    if col.count("ERROR") > errors_before:
        # the graph is already known-broken; building it would only
        # re-report the same breakage through SHP001. The config-level
        # sharding checks are independent of graph validity, though —
        # report everything in one run
        if widths:
            sharding_rules_static(model_cfg, widths, path, col)
        return
    built = shape_pass(model_cfg, path, col, widths)
    if widths:
        # batch divisibility (SHD003) is config-level and always applies;
        # the SHD001 neuron-dim heuristic is only the fallback for nets
        # that could not build (data sources absent) — built nets got the
        # precise per-param check in shape_pass
        sharding_rules_static(
            model_cfg, widths, path, col, neuron_dims=not built
        )
    # cost-aware shardlint (MEM001/COST001/SRV002/FLT002): the static
    # HBM/collective/bubble model; returns the --explain-cost report
    # when the train net built
    report = cost_rules(
        model_cfg, cluster_cfg, widths, path, col,
        comm_fraction=comm_fraction,
    )
    if reports is not None and report is not None:
        reports.append(report)


def apply_fixes(
    diags: list, *, dry_run: bool = False, out=None
) -> int:
    """Apply the machine-applicable ``Diagnostic.fix`` rewrites
    (CFG001/CFG002 single-candidate did-you-means) in place; -> number
    of fixes applied (or that WOULD apply under ``dry_run``, which
    prints a unified diff instead of writing).

    Each fix is re-verified against the file text at its recorded
    (line, col) span before anything is touched — a quoted enum value's
    span points at the opening quote, so a leading quote is tolerated —
    and files are rewritten atomically (tmp + rename). Fixes land
    bottom-up so earlier spans stay valid."""
    if out is None:
        # resolve at call time: binding sys.stdout as the default would
        # pin the stream the interpreter had at import
        out = sys.stdout
    by_path: dict[str, list] = {}
    for d in diags:
        if d.fix is not None and d.code in ("CFG001", "CFG002"):
            by_path.setdefault(d.fix.path, []).append(d.fix)
    applied = 0
    for path, fixes in sorted(by_path.items()):
        try:
            with open(path, "r", encoding="utf-8") as f:
                old_text = f.read()
        except OSError as e:
            print(f"--fix: cannot read {path}: {e}", file=sys.stderr)
            continue
        lines = old_text.splitlines(keepends=True)
        changed = 0
        for fix in sorted(
            fixes, key=lambda x: (x.line, x.col), reverse=True
        ):
            if not 1 <= fix.line <= len(lines):
                continue
            line = lines[fix.line - 1]
            i = fix.col - 1
            if line[i : i + len(fix.old)] != fix.old:
                if line[i : i + 1] in "\"'" and line[
                    i + 1 : i + 1 + len(fix.old)
                ] == fix.old:
                    i += 1  # quoted value: span points at the quote
                else:
                    continue  # text drifted since the parse: skip
            lines[fix.line - 1] = (
                line[:i] + fix.new + line[i + len(fix.old):]
            )
            changed += 1
        if not changed:
            continue
        new_text = "".join(lines)
        if dry_run:
            out.write(
                "".join(
                    difflib.unified_diff(
                        old_text.splitlines(keepends=True),
                        new_text.splitlines(keepends=True),
                        fromfile=path,
                        tofile=f"{path} (fixed)",
                    )
                )
            )
        else:
            d = os.path.dirname(os.path.abspath(path)) or "."
            fd, tmp = tempfile.mkstemp(
                prefix=os.path.basename(path) + ".", dir=d
            )
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    f.write(new_text)
                os.replace(tmp, path)
            except OSError:
                try:
                    os.unlink(tmp)
                finally:
                    raise
        applied += changed
    return applied


def _collect(paths: list[str]) -> tuple[list[str], list[str], list[str]]:
    """-> (conf files, python files, missing)."""
    confs: list[str] = []
    pys: list[str] = []
    missing: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for full in walk_source_files(p, (".conf", ".py")):
                (confs if full.endswith(".conf") else pys).append(full)
        elif os.path.isfile(p):
            (confs if not p.endswith(".py") else pys).append(p)
        else:
            missing.append(p)
    return confs, pys, missing


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="singa_tpu_torch.tools.lint",
        description="static config/graph/sharding validator + port lint",
    )
    ap.add_argument("paths", nargs="*", help=".conf/.py files or dirs")
    ap.add_argument(
        "--cluster",
        default=None,
        help="cluster conf supplying mesh axis widths for SHD* rules",
    )
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument(
        "--self",
        action="store_true",
        dest="self_lint",
        help="AST-lint the installed singa_tpu_torch package source",
    )
    ap.add_argument(
        "--strict",
        action="store_true",
        help="treat WARNING diagnostics as failures",
    )
    ap.add_argument(
        "--ignore",
        default="",
        help="comma-separated diagnostic codes to drop",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule table"
    )
    ap.add_argument(
        "--explain-cost",
        action="store_true",
        help="print the per-conf cost-model report table (HBM components, "
        "collective bytes, pipeline bubble)",
    )
    ap.add_argument(
        "--cost-comm-fraction",
        type=float,
        default=DEFAULT_COMM_FRACTION,
        metavar="F",
        help="COST001 fires when modeled collective bytes exceed F x "
        f"modeled compute bytes (default {DEFAULT_COMM_FRACTION}; "
        "0 disables)",
    )
    ap.add_argument(
        "--fix",
        action="store_true",
        help="apply unambiguous CFG001/CFG002 did-you-mean rewrites in "
        "place (atomic write); with --dry-run, print the diff instead",
    )
    ap.add_argument(
        "--dry-run",
        action="store_true",
        help="with --fix: show the unified diff without writing",
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        print(render_rule_table())
        return 0
    if not args.paths and not args.self_lint:
        ap.print_usage(sys.stderr)
        print(
            "error: give at least one path, or --self / --list-rules",
            file=sys.stderr,
        )
        return 2

    col = Collector(
        ignore={c.strip() for c in args.ignore.split(",") if c.strip()}
    )

    widths = None
    cluster_cfg = None
    if args.cluster:
        try:
            with open(args.cluster, "r", encoding="utf-8") as f:
                ctext = f.read()
        except OSError as e:
            print(f"error: --cluster {args.cluster}: {e}", file=sys.stderr)
            return 2
        cluster_cfg, widths = lint_cluster_text(ctext, args.cluster, col)

    confs, pys, bad = _collect(args.paths)
    if bad:
        for p in bad:
            print(f"error: no such path {p!r}", file=sys.stderr)
        return 2
    # --cluster already linted its file; don't report it twice when the
    # same conf also arrives via the positional paths
    cluster_real = (
        os.path.realpath(args.cluster) if args.cluster else None
    )
    reports: list = []
    for path in confs:
        if cluster_real and os.path.realpath(path) == cluster_real:
            continue
        _lint_conf(
            path, col, widths, cluster_cfg=cluster_cfg,
            comm_fraction=args.cost_comm_fraction, reports=reports,
        )
    if args.self_lint:
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        pys.extend(walk_source_files(pkg_root, (".py",)))
    # `lint singa_tpu_torch/ --self` must not report every finding twice
    seen_py: set[str] = set()
    for path in pys:
        real = os.path.realpath(path)
        if real not in seen_py:
            seen_py.add(real)
            lint_python_file(path, col)

    diags = col.sorted()
    if args.format == "json":
        print(render_json(diags))
    elif diags:
        print(render_text(diags))
    if args.explain_cost:
        for report in reports:
            print(render_cost_report(report))
    if args.fix:
        applied = apply_fixes(diags, dry_run=args.dry_run)
        verb = "would apply" if args.dry_run else "applied"
        print(f"netlint --fix: {verb} {applied} fix(es)")
    nerr = col.count("ERROR")
    nwarn = col.count("WARNING")
    if args.format == "text":
        scanned = len(confs) + len(seen_py)
        print(
            f"netlint: {scanned} target(s), {nerr} error(s), "
            f"{nwarn} warning(s)"
        )
    return 1 if col.has_errors(strict=args.strict) else 0


if __name__ == "__main__":
    sys.exit(main())
