"""Host dispatch timed against another checkout, in turns, on one GPU.

Run from the repository root with a second checkout (an older commit
unpacked with ``git archive``) in a directory of its own::

  python -m singa_tpu_torch.tools.dispatch_turns --other parent_check

Four worker processes run one after another, in the order other, this,
this, other, each from its checkout's root so that it imports that
checkout's ``singa_tpu_torch`` and ``chip_smoke``. Each worker:

- trains the four image confs of ``chip_smoke.NETS`` at their written
  widths and batches (float32) on full-size synthetic shards (60000
  MNIST-shaped records, 50000 CIFAR-shaped), and
  ``examples/lm/tinylm_longctx_d128.conf`` as written (bf16, S 8192):
  10 warm-up steps, then 30 steps timed on the host clock with one
  device sync at the end (a checkout with ``Trainer.train_chunk`` runs
  them as one chunk; one without, step by step), and 3 more steps under
  ``torch.profiler`` for the device time, whose share of the timed
  wall is the device's busy share (1 - idle share);
- serves chip_smoke's 16-request workload (``chip_smoke.serve``) after
  an untimed run, and times it: tokens/s;
- splits one decode engine call (:func:`engine_split`): host ms per call,
  the CPU time inside ATen operators, the rest (Python), and the
  device's kernel time, over 50 calls with 8 live slots.

Each worker prints one JSON line; the parent process prints them with
the card's name and power limit and writes them to
``chiprun_out/dispatch_turns.json``. The worker is this file run by path
(``--worker``), so the other checkout needs none of this module.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

#: (records, test records) of the full-size synthetic shards
MNIST_RECORDS = (60000, 10000)
CIFAR_RECORDS = (50000, 10000)
WARM_STEPS = 10
TIMED_STEPS = 30
PROFILED_STEPS = 3


def steps(tr, step0: int, n: int) -> None:
    """``n`` train steps from ``step0``: one chunk where the Trainer has
    them, else step by step."""
    if hasattr(tr, "train_chunk"):
        tr.train_chunk(step0, n)
    else:
        for step in range(step0, step0 + n):
            tr.train_one_batch(step)


def profiled_device_ms(run, n: int) -> tuple[float, list]:
    """Device ms per step of ``run()`` (``n`` steps) under
    torch.profiler, and its 5 largest device rows per step."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(rows, key=lambda kv: -kv[1])[:5]
    return sum(ms for _, ms in rows), [(k[:80], ms) for k, ms in top]


def time_training(tr, batch: int) -> dict:
    """Warm-up, timed and profiled steps of one Trainer -> its record."""
    steps(tr, 0, WARM_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(tr, WARM_STEPS, TIMED_STEPS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    loss = tr.perf.avg()["loss"]["loss"]
    tr.perf.reset()
    dev_ms, top = profiled_device_ms(
        lambda: steps(tr, WARM_STEPS + TIMED_STEPS, PROFILED_STEPS),
        PROFILED_STEPS)
    tr.perf.reset()
    return {"step_ms": ms, "per_s": batch / ms * 1e3,
            "device_ms_per_step": dev_ms, "idle_share": 1.0 - dev_ms / ms,
            "loss": loss, "top5": top,
            "dispatch": getattr(tr, "dispatch_mode", "eager")}


def engine_split(engine, calls: int = 50, prompt_len: int = 256) -> dict:
    """One decode call of ``engine`` split by where its time goes, with
    every slot live (prompts of ``prompt_len`` from seed 3): host ms per
    call (the loop's host clock, no sync inside), the wall ms per call
    to a sync at the end, the CPU ms inside ATen operators (profiled:
    the profiler slows them, so this is an upper estimate), the rest
    of the host time (Python; for a graph, the replay's launch), and the
    device's kernel ms. The engine's lanes advance by 3 + 3 x ``calls``
    tokens."""
    rs = np.random.RandomState(3)
    c = engine.serving.max_prefill_chunk
    for slot in range(engine.serving.slots):
        prompt = rs.randint(0, engine.cfg.vocab, size=(prompt_len,))
        engine.admit(slot, prompt_len + 3 * calls + 8)
        for c0 in range(0, prompt_len, c):
            last = engine.prefill_chunk(slot, prompt[c0:c0 + c], c0)
        engine.activate(slot, last, prompt_len, seed=slot)
    for _ in range(3):
        engine.decode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        engine.decode()
    host = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / calls
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            engine.decode()
        torch.cuda.synchronize()
    aten = kernel = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernel += e.self_device_time_total
        elif e.key.startswith("aten::"):
            aten += e.self_cpu_time_total
    aten, kernel = aten / 1e3 / calls, kernel / 1e3 / calls
    return {"host_ms_per_call": host, "wall_ms_per_call": wall,
            "aten_cpu_ms": aten, "python_ms": max(host - aten, 0.0),
            "kernel_ms": kernel}


def write_shards(tmp: str) -> dict:
    """The full-size MNIST- and CIFAR-shaped shards, their test splits,
    the CIFAR mean file and the LM's token shard."""
    from singa_tpu_torch.data.loader import (
        compute_mean,
        structured_rgb,
        synthetic_arrays,
        synthetic_token_arrays,
        write_records,
    )

    out = {k: os.path.join(tmp, k) for k in
           ("mnist", "mnist_test", "cifar", "cifar_test", "tokens")}
    write_records(out["mnist"], *synthetic_arrays(MNIST_RECORDS[0], seed=0))
    write_records(out["mnist_test"], *synthetic_arrays(
        MNIST_RECORDS[1], seed=0, noise_seed=1))
    write_records(out["cifar"], *structured_rgb(CIFAR_RECORDS[0], seed=0))
    write_records(out["cifar_test"], *structured_rgb(
        CIFAR_RECORDS[1], seed=0, noise_seed=1))
    out["mean"] = os.path.join(tmp, "mean.npy")
    compute_mean(out["cifar"], out["mean"])
    write_records(out["tokens"], *synthetic_token_arrays(
        32, seq_len=8192, vocab=256, seed=0))
    return out


def worker() -> dict:
    """This checkout's record (run from its root)."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from singa_tpu_torch import _build
    from singa_tpu_torch.config import load_model_config
    from singa_tpu_torch.models.transformer import TransformerConfig, init_lm
    from singa_tpu_torch.serve import Engine, EngineConfig
    from singa_tpu_torch.trainer import Trainer

    dev = torch.device("cuda")
    _build.build_all()
    out = {"checkout": os.getcwd()}
    with tempfile.TemporaryDirectory() as tmp:
        shards = write_shards(tmp)
        for name in cs.NETS:
            tr = Trainer(cs.net_config(name, shards), seed=0,
                         log=lambda s: None, device=dev)
            out[name] = time_training(tr, cs.NETS[name][2])
            del tr
        cfg = load_model_config(cs.TRAIN_CONF)
        for layer in cfg.neuralnet.layer:
            if layer.type == "kSequenceData":
                layer.data_param.path = shards["tokens"]
        tr = Trainer(cfg, seed=0, log=lambda s: None, device=dev)
        out["train_longctx"] = time_training(tr, tr.tokens_per_step)
        del tr
    lm = TransformerConfig(vocab=256, d_model=256, n_heads=2, n_layers=2,
                           d_ff=1024, max_len=2048)
    params = init_lm(torch.Generator().manual_seed(0), lm, dev)
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, lm.vocab, size=(int(rs.randint(32, 1025)),))
               .astype(np.int32) for _ in range(16)]
    cs.serve(dev, params, lm, prompts, impl="fused")
    sched, seconds, _, _ = cs.serve(dev, params, lm, prompts, impl="fused")
    out["serve_tokens_per_s"] = (
        (sched.tokens_emitted + len(sched.finished)) / seconds)
    out["engine_split"] = engine_split(Engine(params, lm, EngineConfig(
        slots=8, kv_block_len=16, max_prefill_chunk=64), device=dev))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--worker", action="store_true",
                    help="measure the checkout in the working directory")
    args = ap.parse_args(argv)
    if args.worker:
        print("DISPATCH_TURNS " + json.dumps(worker()), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("dispatch_turns: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    here = os.getcwd()
    other = os.path.abspath(args.other)
    runs = []
    for tag, root in (("other", other), ("this", here), ("this", here),
                      ("other", other)):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker"],
            cwd=root, capture_output=True, text=True, check=True)
        line = next(l for l in res.stdout.splitlines()
                    if l.startswith("DISPATCH_TURNS "))
        rec = {"run": tag, "card": smi,
               **json.loads(line[len("DISPATCH_TURNS "):])}
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "dispatch_turns.json"),
              "w") as f:
        json.dump(runs, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
