"""The flash kernels (the backward, and the forward beside it) timed
against another checkout, in turns, on one GPU.

Run from the repository root with a second checkout (an older commit
unpacked with ``git archive``) in a directory of its own::

  python -m singa_tpu_torch.tools.flash_bwd_turns --other parent_check

Four worker processes run one after another, in the order other, this,
this, other, each from its checkout's root so that it imports that
checkout's ``singa_tpu_torch`` and ``chip_smoke``. Each builds its
kernels and times, at chip_smoke's training shape (B*H 2, S 8192, D 128,
causal) with chip_smoke's ``time_ms`` (CUDA events, the L2 flushed before
each call):

- float32: the backward as the checkout runs it (the fused
  ``flash_bwd`` where the checkout has it, else ``flash_bwd_dq`` then
  ``flash_bwd_dkv``, each alone and the two as one call), the forward,
  and SDPA's float32 forward and backward (TF32 off) as yardsticks;
- bf16: ``flash_bwd_dq``, ``flash_bwd_dkv``, the two as one call, the
  forward, and SDPA's forward and backward.

Beside each type's forward time stand its bound (chip_smoke's
``flash_bound``: 0.513 ms in float32, operations at 67 TFLOP/s) and the
share of that bound it reached (bound / time). Each worker then runs
chip_smoke's float32 flash training run (``train_run``: 8 steps of
examples/lm/tinylm_longctx_d128.conf at S 8192 from seed-0 params, each
step timed to a device sync) and records its step ms and losses.

Where the checkout's chip_smoke reads the fused kernel's statistics
(``flash_bwd_polling``), the worker adds its polling share. Each worker
prints one JSON line; the parent process prints them, each with the
card's name and power limit. The worker is this file run by path
(``--worker``), so the other checkout needs none of this module.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

#: chip_smoke's training shape: B*H, S, D, causal
SHAPE = (2, 8192, 128, True)
ITERS = 10


def worker(iters: int) -> dict:
    """This checkout's record (run from its root)."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from singa_tpu_torch import _build
    from singa_tpu_torch.ops import attention as ta

    dev = torch.device("cuda")
    _build.build_all()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    fused = hasattr(ta, "launch_flash_bwd")
    out = {"checkout": os.getcwd(), "fused_float32_backward": fused}
    for dtype in (torch.float32, torch.bfloat16):
        c = cs.flash_case(*SHAPE, dtype, dev, gen)
        args = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                c["causal"])
        calls = {"flash_fwd": lambda: ta.flash_fwd(*args[:3], args[6])}
        if dtype == torch.float32 and fused:
            calls["backward"] = lambda: ta.flash_bwd(*args)
        else:
            calls["flash_bwd_dq"] = lambda: ta.flash_bwd_dq(*args)
            calls["flash_bwd_dkv"] = lambda: ta.flash_bwd_dkv(*args)
            calls["backward"] = lambda: (ta.flash_bwd_dq(*args),
                                         ta.flash_bwd_dkv(*args))
        bh, s, d, _ = SHAPE
        q, k, v = (c[n].reshape(1, bh, s, d).detach().requires_grad_(True)
                   for n in ("q", "k", "v"))
        o = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)
        do = c["do"].reshape(1, bh, s, d)
        calls["sdpa_forward"] = (
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True))
        calls["sdpa_backward"] = lambda: torch.autograd.grad(
            o, (q, k, v), do, retain_graph=True)
        rec = {name: cs.time_ms(fn, flush, iters=iters)
               for name, fn in calls.items()}
        bound_ms, _ = cs.flash_bound("flash_fwd", c)
        rec["flash_fwd_bound_ms"] = bound_ms
        rec["flash_fwd_share_of_bound"] = bound_ms / rec["flash_fwd"]
        if dtype == torch.float32 and hasattr(cs, "flash_bwd_polling"):
            rec.update(cs.flash_bwd_polling(c, rec["backward"]))
        out[str(dtype)[6:]] = rec
        del c, q, k, v, o
    with tempfile.TemporaryDirectory() as tmp:
        run = cs.train_run(dev, cs.write_shard(tmp), steps=8,
                           dtype="float32", dense=False, tag="flash_f32")
    out["train_float32_flash"] = {
        key: run[key] for key in ("step_ms_median", "step_ms_min",
                                  "losses", "launches")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--worker", action="store_true",
                    help="measure the checkout in the working directory")
    args = ap.parse_args(argv)
    if args.worker:
        print("FLASH_BWD_TURNS " + json.dumps(worker(args.iters)),
              flush=True)
        return 0
    if not torch.cuda.is_available():
        print("flash_bwd_turns: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    here = os.getcwd()
    other = os.path.abspath(args.other)
    for tag, root in (("other", other), ("this", here), ("this", here),
                      ("other", other)):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--iters", str(args.iters)],
            cwd=root, capture_output=True, text=True)
        if res.returncode:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"worker in {root} exited {res.returncode}")
        line = next(l for l in res.stdout.splitlines()
                    if l.startswith("FLASH_BWD_TURNS "))
        rec = {"run": tag, "card": smi,
               **json.loads(line[len("FLASH_BWD_TURNS "):])}
        print(json.dumps(rec), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
