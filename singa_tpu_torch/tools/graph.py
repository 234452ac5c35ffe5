"""Render a net-structure JSON dump as graphviz dot (the PyTorch
counterpart of ``singa_tpu/tools/graph.py``, the same code).

The reference renders NeuralNet::ToString's node-link JSON with pydot
(script/graph.py reading the vis_folder dumps, src/utils/graph.cc:8-59).
This emits the .dot source directly — no graphviz python binding needed;
`dot -Tpdf` or any viewer takes it from there.

Usage:
  python -m singa_tpu_torch.tools.graph --input ws/visualization/kTrain.json \
      [--output net.dot]
"""

from __future__ import annotations

import argparse
import json
import sys


_SHAPES = {
    "kShardData": "cylinder",
    "kLMDBData": "cylinder",
    "kMnistImage": "parallelogram",
    "kRGBImage": "parallelogram",
    "kLabel": "parallelogram",
    "kSoftmaxLoss": "doubleoctagon",
    "kEuclideanLoss": "doubleoctagon",
}


def net_json_to_dot(doc: dict) -> str:
    """Node-link JSON ({nodes: [{id, ...}], links: [{source, target}]})
    -> dot source. Node attributes beyond ``id`` become label lines."""
    lines = [
        "digraph net {",
        "  rankdir=BT;",  # data at the bottom, loss on top, like a net
        '  node [shape=box, fontname="monospace"];',
    ]
    for node in doc.get("nodes", []):
        nid = node["id"]
        extra = [
            f"{k}: {v}"
            for k, v in node.items()
            if k not in ("id",) and v not in (None, "", [])
        ]
        label = "\\n".join([str(nid)] + extra)
        shape = _SHAPES.get(node.get("type"))
        attr = f' [label="{label}"' + (f", shape={shape}" if shape else "") + "]"
        lines.append(f'  "{nid}"{attr};')
    for link in doc.get("links", []):
        lines.append(f'  "{link["source"]}" -> "{link["target"]}";')
    lines.append("}")
    return "\n".join(lines) + "\n"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="singa_tpu_torch.tools.graph")
    ap.add_argument("--input", required=True, help="net JSON dump")
    ap.add_argument("--output", default=None, help="dot file (default stdout)")
    args = ap.parse_args(argv)
    with open(args.input) as f:
        dot = net_json_to_dot(json.load(f))
    if args.output:
        with open(args.output, "w") as f:
            f.write(dot)
        print(f"wrote {args.output}")
    else:
        sys.stdout.write(dot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
