"""The kLayerPartition training paths timed against other checkouts, in
turns, on one GPU.

Run from the repository root with other checkouts (older trees unpacked
with ``git archive``), each in a directory of its own::

  python -m singa_tpu_torch.tools.axes_turns --other parent_check/a \\
      --other parent_check/b

Worker processes run one after another, the others in the order given,
then this checkout twice, then the others in reverse (a, b, this, this,
b, a), each from its checkout's root so that it imports that checkout's
``singa_tpu_torch`` and ``chip_smoke``. Each worker trains chip_smoke's
axes ``tp`` path (tinylm.conf with kLayerPartition on data 2 x model 2)
and its ``3axis`` path (tinylm_pp.conf on data 2 x pipe 2 x model 2),
bf16, the flash kernels forced, all ranks on this card: WARM_STEPS
steps, then TIMED_STEPS steps, each timed on the host clock to a device
sync, with the flash launches of the timed steps.

Each worker prints one JSON line; the parent process prints them with
the card's name and power limit and writes them to
``chiprun_out/axes_turns.json``. The worker is this file run by path
(``--worker``), so the other checkouts need none of this module.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

PATHS = ("tp", "3axis")
WARM_STEPS = 3
TIMED_STEPS = 20


def worker() -> dict:
    """This checkout's record (run from its root)."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from singa_tpu_torch import _build
    from singa_tpu_torch.trainer import Trainer

    dev = torch.device("cuda")
    _build.build_all()
    out = {"checkout": os.getcwd()}
    os.environ["SINGA_TPU_DENSE_ATTN_MB"] = "0"
    with tempfile.TemporaryDirectory() as tmp:
        shard = cs.write_axes_shards(tmp)["lm"]
        for name in PATHS:
            path = cs.AXES_PATHS[name]
            cfg = cs.axes_config(path.conf, path.edit, shard, "bfloat16")
            tr = Trainer(cfg, cs.axes_cluster(path.cluster, tmp), seed=0,
                         log=lambda s: None, device=dev)
            cs.axes_steps(tr, WARM_STEPS)
            cs.zero_launches()
            losses, ms = cs.axes_steps(tr, TIMED_STEPS, WARM_STEPS)
            out[name] = {
                "mesh": tr.mesh_shape,
                "step_ms_median": sorted(ms)[len(ms) // 2],
                "step_ms_min": min(ms), "step_ms": ms,
                "flash_launches_per_step": {
                    k: v / TIMED_STEPS
                    for k, v in cs.axes_launches().items()},
                "last_loss": losses[-1]}
            del tr
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another checkout's root (repeatable)")
    ap.add_argument("--worker", action="store_true",
                    help="measure the checkout in the working directory")
    args = ap.parse_args(argv)
    if args.worker:
        print("AXES_TURNS " + json.dumps(worker()), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("axes_turns: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    here = os.getcwd()
    others = [(os.path.normpath(o), os.path.abspath(o)) for o in args.other]
    order = others + [("this", here)] * 2 + others[::-1]
    runs = []
    for tag, root in order:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker"],
            cwd=root, capture_output=True, text=True, check=True)
        line = next(l for l in res.stdout.splitlines()
                    if l.startswith("AXES_TURNS "))
        rec = {"run": tag, "card": smi,
               **json.loads(line[len("AXES_TURNS "):])}
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in PATHS}), flush=True)
        for name in PATHS:
            print(name, json.dumps({k: v for k, v in rec[name].items()
                                    if k != "step_ms"}), flush=True)
        runs.append(rec)
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "axes_turns.json"),
              "w") as f:
        json.dump(runs, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
