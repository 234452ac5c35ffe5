"""Plot training-log curves to a PNG (the PyTorch counterpart of
``singa_tpu/tools/draw.py``: the same parser and plot; the port's
``main`` writes the same log lines).

The reference plots metric columns from log files with matplotlib
(script/draw.py). This parses the trainer's own log lines —

    step 90: train loss : 0.825172, precision : 0.907813 [...]
    step 100: test loss : 0.668926, precision : 0.907813

— into per-phase series and renders one subplot per metric (never a
dual-axis chart: loss and precision live on different scales, so each
gets its own axis). Phases take fixed categorical colors: train, test,
validation — assignment never reshuffles when a phase is absent.

Usage:
  python -m singa_tpu_torch.tools.draw --log train.log --output curves.png [--logx]
"""

from __future__ import annotations

import argparse
import re
import sys
from collections import defaultdict

# fixed categorical slots (validated default palette, light mode)
_PHASE_COLORS = {
    "train": "#2a78d6",
    "test": "#eb6834",
    "validation": "#1baf7a",
}
_SURFACE = "#fcfcfb"
_TEXT = "#0b0b0b"
_TEXT_2 = "#52514e"
_GRID = "#e4e3df"

_LINE = re.compile(
    r"step (\d+): (train|test|validation)\b[^A-Za-z]*(.*)"
)
_METRIC = re.compile(r"([A-Za-z_][\w ]*?)\s*:\s*([-+eE.\d]+)")


def parse_log(text: str) -> dict[str, dict[str, list[tuple[int, float]]]]:
    """-> {metric: {phase: [(step, value), ...]}}"""
    out: dict[str, dict[str, list[tuple[int, float]]]] = defaultdict(
        lambda: defaultdict(list)
    )
    for line in text.splitlines():
        m = _LINE.search(line)
        if not m:
            continue
        step, phase, rest = int(m.group(1)), m.group(2), m.group(3)
        rest = rest.split("[")[0]  # strip the timer suffix
        for name, val in _METRIC.findall(rest):
            try:
                out[name.strip()][phase].append((step, float(val)))
            except ValueError:
                continue
    return {k: dict(v) for k, v in out.items()}


class PlotUnavailable(RuntimeError):
    """matplotlib (or the PIL it writes PNGs through) is not installed."""


def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported at the first
    plot (the parser needs neither). -> raises PlotUnavailable, naming
    the missing package, where one is missing."""
    try:
        import matplotlib
    except ImportError as e:
        raise PlotUnavailable(
            f"draw needs matplotlib to write a PNG: {e}") from e
    try:
        import PIL  # noqa: F401  (matplotlib's image writer)
    except ImportError as e:
        raise PlotUnavailable(
            f"draw needs PIL (pillow), which matplotlib writes PNGs "
            f"through: {e}") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw(curves, output: str, logx: bool = False) -> None:
    plt = _pyplot()
    metrics = sorted(curves)
    fig, axes = plt.subplots(
        len(metrics), 1, figsize=(8, 3.2 * len(metrics)),
        squeeze=False, facecolor=_SURFACE,
    )
    for ax, metric in zip(axes[:, 0], metrics):
        ax.set_facecolor(_SURFACE)
        for phase in ("train", "test", "validation"):  # fixed slot order
            series = curves[metric].get(phase)
            if not series:
                continue
            xs, ys = zip(*series)
            ax.plot(
                xs, ys, color=_PHASE_COLORS[phase], linewidth=2,
                label=phase, solid_capstyle="round",
            )
        if logx:
            ax.set_xscale("log")
        ax.set_ylabel(metric, color=_TEXT)
        ax.grid(True, color=_GRID, linewidth=0.8)
        ax.tick_params(colors=_TEXT_2)
        for spine in ax.spines.values():
            spine.set_visible(False)
        if sum(bool(curves[metric].get(p)) for p in _PHASE_COLORS) > 1:
            ax.legend(frameon=False, labelcolor=_TEXT)
    axes[-1, 0].set_xlabel("step", color=_TEXT)
    fig.tight_layout()
    fig.savefig(output, dpi=120)
    plt.close(fig)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="singa_tpu_torch.tools.draw")
    ap.add_argument("--log", required=True, help="trainer log file")
    ap.add_argument("--output", required=True, help="output PNG")
    ap.add_argument("--logx", action="store_true", help="log-scale steps")
    args = ap.parse_args(argv)
    with open(args.log) as f:
        curves = parse_log(f.read())
    if not curves:
        print("no metric lines found in log", file=sys.stderr)
        return 1
    try:
        draw(curves, args.output, args.logx)
    except PlotUnavailable as e:
        print(str(e), file=sys.stderr)
        return 2
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
