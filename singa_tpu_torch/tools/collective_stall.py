"""Measure the gradient-collective stall: exact vs quantized vs overlapped.

The PyTorch counterpart of ``singa_tpu/tools/collective_stall.py``: the
same modes, flags, defaults, thresholds and JSON keys.

The grad_comm claim (parallel/collectives.py) is that casting each
bucket's gradients to a scaled int8/bf16 wire format before the
data-axis reduction, and chaining per-bucket reductions in reverse-topo
(gradient-readiness) order, shrinks the step-end gradient collective
WITHOUT slowing the step. This tool measures it by timing the same small
MLP job on an ``ndata``-wide data mesh (every rank on one device: the
GPU, or the CPU with ``--device cpu``) six ways:

  exact       no grad_comm block (the float32 reduction)
  quantized   mode quantized, per-param scales (no bucket chain)
  overlap     mode exact, ``--buckets`` reverse-topo groups chained
  q8_overlap  quantized + bucketized (the full machinery)
  q8_ring     q8_overlap + ``kernels { grad_allreduce: quantized_ring }``
              (the int8-on-the-wire ring, ops/quantized_collective.py,
              whose every hop launches the ``quant_acc`` kernel on the
              card)
  q8_hier     q8_overlap + ``kernels { grad_allreduce: q8_hier }`` with
              ``ring { intra_degree: 2 }`` (the two-level ring)

and printing one JSON line::

  {"exact_step_ms": .., "quantized_step_ms": .., "overlap_step_ms": ..,
   "q8_overlap_step_ms": .., "q8_ring_step_ms": .., "quantized_ratio":
   .., "overlap_ratio": .., "q8_overlap_ratio": .., "q8_ring_ratio":
   .., "comm_ms": {mode: ..}, "wire_bytes": {..}, "wire_bytes_ratio":
   .., "threshold": .., "pass": ..}

Exit status 0 iff all three gates hold, as in the JAX tool. Gate 1: the
q8_overlap step within ``threshold`` x exact, OR its isolated per-step
machinery cost (the ``measure_comm_ms`` slope fit) under
``machinery_share`` of the exact step. Gate 2 (q8_ring): the ring's step
within ``threshold`` x exact, OR the per-rank bytes crossing the data
axis drop by >= ``wire_threshold`` against the float32 collective,
counted two ways that must agree: ``Trainer.wire_bytes_model()`` (the
analytic model) and the bytes the ring's exchanges sent in one step,
counted at ``ops.quantized_collective.ppermute.sent_bytes`` for rank 0.
The JSON keeps the JAX tool's names for the second count
(``ring_jaxpr``, ``wire_model_matches_jaxpr``): there it is read from
the step's jaxpr, here from the program's own exchange counter. Gate 3
(q8_hier): the hierarchical step within ``threshold`` x exact, OR the
per-level model equals the per-level count on both levels AND the
inter-slice bytes times ``intra_degree`` stay at or under the flat
ring's. ``pass_mode`` / ``ring_pass_mode`` / ``hier_pass_mode`` say
which criterion carried.

``measure_comm_ms`` is importable (sweep reuses it): it slope-fits the
gradient-reduction machinery in isolation, N chained reduction rounds
(each rank's partials summed, then the grad_comm seam; on the ring the
ring itself), so the reported ms is the marginal per-reduction cost.
``record_comm_probe`` is the Trainer's one-shot telemetry calibration:
the same chained rounds timed once under the ``comm`` phase, so the
flight recorder holds a measured span for ``trace --summarize``'s comm
share.

Usage::

  python -m singa_tpu_torch.tools.collective_stall [--steps N]
      [--warmup N] [--trials N] [--batch N] [--hidden N] [--head N]
      [--ndata N] [--buckets N] [--dtype int8|bf16] [--zero_update]
      [--threshold R] [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time

import torch


def sync(dev) -> None:
    """Wait for ``dev``'s queued work (nothing to wait for on the CPU)."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _comm_inputs(trainer):
    """(grads, residuals) the chained rounds run on: ones in the live
    params' stored shapes (an all-zero gradient would pin the int8 scale
    to its floor), and copies of the trainer's residual buffers."""
    from ..parallel.collectives import is_residual_key

    grads = {k: torch.ones_like(v) for k, v in trainer.params.items()}
    res = {k: v.clone() for k, v in trainer.buffers.items()
           if is_residual_key(k)}
    return grads, res


def _comm_round(trainer):
    """-> round(grads, res) -> (grads, res): one reduction of the step's
    machinery and nothing else. The ring's round is the ring itself
    (``_ring_reduce_probe``: every hop's ``quant_acc``); otherwise each
    rank's partial (``grads`` / n on its device) is summed on rank 0's
    device, across processes through the step's one gather, and goes
    through the grad_comm seam (``reduce_gradients``) when there is
    one."""
    from ..parallel.collectives import reduce_gradients

    mesh = trainer.mesh
    n = mesh.width
    comm = trainer._comm
    if trainer._ring_chunk_dims is not None:
        def ring_round(grads, res):
            # the ring gives ``grads`` back (a zero-sharded param as each
            # rank's chunk): the next round takes the whole grads again
            _, new = trainer._ring_reduce_probe(grads, res)
            return grads, {**res, **new}

        return ring_round
    names = list(trainer.params)
    buckets = trainer._buckets(names) if comm is not None else None

    def round_(grads, res):
        parts = [{nm: g.to(mesh.device(r)) / n for nm, g in grads.items()}
                 for r in mesh.local_ranks]
        if mesh.nprocs > 1:
            parts = mesh.gather(parts, trainer.device)
        summed = {nm: functools.reduce(
            torch.add, (p[nm].to(trainer.device) for p in parts))
            for nm in names}
        if comm is None:
            return summed, res
        out, new = reduce_gradients(summed, res, comm, buckets)
        return out, {**res, **new}

    return round_


def _comm_chain(trainer, n: int):
    """-> run() that chains ``n`` reduction rounds from fresh inputs and
    waits for the device."""
    grads, res = _comm_inputs(trainer)
    round_ = _comm_round(trainer)

    @torch.no_grad()
    def run() -> None:
        g, r = grads, res
        for _ in range(n):
            g, r = round_(g, r)
        sync(trainer.device)

    return run


def measure_comm_ms(trainer, i1: int = 4, i2: int = 20,
                    trials: int = 3) -> float:
    """Slope-fit the gradient-reduction machinery in isolation: time two
    chained-round window sizes and return the marginal per-reduction
    cost in ms (the two-window method: the fixed cost of a window
    cancels). Floored at 0: a tiny reduction's window delta can sink
    under host jitter."""
    fns = {n: _comm_chain(trainer, n) for n in (i1, i2)}

    def run(n) -> float:
        t0 = time.perf_counter()
        fns[n]()
        return time.perf_counter() - t0

    for n in fns:  # warm
        run(n)
    best = {n: float("inf") for n in fns}
    for _ in range(trials):
        for n in fns:
            best[n] = min(best[n], run(n))
    return max(0.0, (best[i2] - best[i1]) / (i2 - i1) * 1e3)


def record_comm_probe(trainer, rounds: int = 16) -> float:
    """The Trainer's one-shot telemetry calibration: run ``rounds``
    chained reductions once under the ``comm`` phase (a warm run outside
    the timed region first), so the flight recorder gets a measured span
    whose dur/steps is the per-reduction cost, and emit a ``comm_probe``
    event carrying the host-side number. Returns the per-reduction ms.

    The probe's rounds launch and send like a step's (on the ring, every
    hop's ``quant_acc`` and exchange), and the process counters count
    them as they count any launch. What the probe itself added, warm run
    included, is kept in ``trainer.comm_probe_counts``
    (``quant_acc_launches``, ``ring_sent_bytes``, ``exchange_s``) and
    logged on the event as ``launches`` and ``sent_bytes``, so a reader
    of the counters can tell the steps' share from the probe's."""
    from ..ops import quantized_collective as qc
    from ..parallel.mesh import EXCHANGE

    launches = qc.quant_acc.launches
    sent = sum(qc.ppermute.sent_bytes.values())
    exchange_s = EXCHANGE.seconds
    run = _comm_chain(trainer, rounds)
    try:
        run()  # warm, outside the span
        t0 = time.perf_counter()
        with trainer.timers.phase("comm", steps=rounds):
            run()
        ms = (time.perf_counter() - t0) / rounds * 1e3
    finally:
        trainer.comm_probe_counts = {
            "quant_acc_launches": qc.quant_acc.launches - launches,
            "ring_sent_bytes": sum(qc.ppermute.sent_bytes.values()) - sent,
            "exchange_s": EXCHANGE.seconds - exchange_s,
        }
    if trainer.telemetry is not None:
        spec = trainer._comm
        trainer.telemetry.event(
            "comm_probe",
            step=trainer.start_step,
            mode=trainer.comm_mode,
            dtype=trainer.comm_dtype,
            buckets=spec.buckets if spec is not None else 0,
            rounds=rounds,
            comm_ms=round(ms, 4),
            launches=trainer.comm_probe_counts["quant_acc_launches"],
            sent_bytes=trainer.comm_probe_counts["ring_sent_bytes"],
        )
    return ms


def _mode_conf(mode: str, dtype: str, buckets: int) -> str:
    """grad_comm conf text for one measured mode ("" for exact)."""
    if mode == "exact":
        return ""
    q8b = (
        f"grad_comm {{ mode: quantized dtype: {dtype} "
        f"buckets: {buckets} }}"
    )
    blocks = {
        "quantized": f'grad_comm {{ mode: quantized dtype: {dtype} }}',
        "overlap": f"grad_comm {{ mode: exact buckets: {buckets} }}",
        "q8_overlap": q8b,
        "q8_ring": q8b + "\nkernels { grad_allreduce: quantized_ring }",
        "q8_hier": (
            q8b
            + "\nkernels { grad_allreduce: q8_hier }"
            + "\nring { intra_degree: 2 }"
        ),
    }
    return blocks[mode]


def measure_wire_bytes(trainer, step: int = 0) -> dict:
    """Per-rank bytes crossing the data axis per step, reference vs the
    ring, for one ring trainer's real param set: the trainer's model
    (``Trainer.wire_bytes_model()``) and, beside it, what the ring's
    exchanges sent in one train step at ``step``, counted for rank 0 at
    ``ppermute.sent_bytes`` (``ring_jaxpr``; under q8_hier
    ``ring_jaxpr_intra`` and ``ring_jaxpr_inter``, and ``ring_jaxpr``
    their sum), the keys of the JAX tool's jaxpr count."""
    from ..ops import quantized_collective as qc

    assert trainer._comm is not None and trainer._comm.ring
    out = trainer.wire_bytes_model()
    qc.ppermute.sent_bytes.clear()
    trainer.train_one_batch(step)
    sync(trainer.device)
    sent = dict(qc.ppermute.sent_bytes)
    r0 = trainer.mesh.local_ranks[0]
    if trainer._comm.hier and trainer._ring_hier is not None:
        out["ring_jaxpr_intra"] = int(sent.get(("intra", r0), 0))
        out["ring_jaxpr_inter"] = int(sent.get(("inter", r0), 0))
        out["ring_jaxpr"] = out["ring_jaxpr_intra"] + out["ring_jaxpr_inter"]
    else:
        out["ring_jaxpr"] = int(sum(v for (_, r), v in sent.items()
                                    if r == r0))
    return out


def _make_runner(shard: str, batch: int, hidden: int, warmup: int,
                 mode: str, dtype: str, buckets: int, ndata: int,
                 zero: bool, head: int = 10, device=None):
    """-> (trainer, window(steps) -> seconds, next step) for one
    grad_comm mode. Every mode runs the identical per-step loop on the
    same ndata-wide data mesh (device_cache off, like update_stall); only
    the gradient-collective machinery differs."""
    from ..config import parse_model_config
    from ..device import resolve_device
    from ..parallel import build_mesh
    from ..trainer import Trainer
    from .input_stall import _CONF

    text = _CONF.format(shard=shard, batch=batch, hidden=hidden,
                        head=head)
    block = _mode_conf(mode, dtype, buckets)
    if block:
        text += "\n" + block + "\n"
    cfg = parse_model_config(text)
    cfg.zero_update = zero
    dev = resolve_device(device)
    mesh = build_mesh(ndata, 1, [dev] * ndata)
    trainer = Trainer(
        cfg, seed=0, log=lambda s: None, mesh=mesh,
        prefetch=False, device_cache=False,
    )
    quant = ("quantized", "q8_overlap", "q8_ring", "q8_hier")
    want = "quantized" if mode in quant else "exact"
    assert trainer.comm_mode == want, (mode, trainer.comm_mode)
    assert (mode in ("q8_ring", "q8_hier")) == (
        trainer._comm is not None and trainer._comm.ring
    ), mode
    assert (mode == "q8_hier") == (
        trainer._comm is not None and trainer._comm.hier
    ), mode

    state = {"step": 0}

    def run(steps: int) -> None:
        step0 = state["step"]
        for s in range(step0, step0 + steps):
            trainer.train_one_batch(s)
        state["step"] = step0 + steps

    run(warmup)
    sync(dev)

    def window(steps: int) -> float:
        t0 = time.perf_counter()
        run(steps)
        sync(dev)
        return time.perf_counter() - t0

    return trainer, window, state


MODES = (
    "exact", "quantized", "overlap", "q8_overlap", "q8_ring", "q8_hier",
)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="collective_stall", description=__doc__
    )
    ap.add_argument("--steps", type=int, default=12, help="timed steps")
    ap.add_argument("--warmup", type=int, default=4, help="untimed steps")
    ap.add_argument(
        "--trials", type=int, default=3,
        help="windows per mode; the best (least-contended) one counts",
    )
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument(
        "--head", type=int, default=10,
        help="classifier width; 12 keeps every param chunkable when "
        "--ndata 4 hosts the real 2x2 hierarchical geometry",
    )
    ap.add_argument("--records", type=int, default=8192,
                    help="synthetic dataset size")
    ap.add_argument("--ndata", type=int, default=2,
                    help="data-axis width (ranks sharing the device)")
    ap.add_argument("--buckets", type=int, default=4,
                    help="bucket count for the overlapped modes")
    ap.add_argument("--dtype", choices=("int8", "bf16"), default="int8")
    ap.add_argument(
        "--zero_update", action="store_true",
        help="compose every mode with the ZeRO update sharding (the "
        "quantized reduce-scatter path)",
    )
    ap.add_argument(
        "--threshold", type=float, default=1.0,
        help="max allowed q8_overlap/exact step-time ratio",
    )
    ap.add_argument(
        "--machinery_share", type=float, default=0.05,
        help="fallback: pass when the isolated machinery cost "
        "(comm_ms slope fit) is under this share of the exact step",
    )
    ap.add_argument(
        "--wire_threshold", type=float, default=3.5,
        help="q8_ring deterministic arm: min reference/ring "
        "wire-bytes ratio",
    )
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' must be asked "
                    "for)")
    args = ap.parse_args(argv)

    from ..data.loader import synthetic_arrays, write_records

    root = tempfile.mkdtemp(prefix="singa_tpu_torch_collective_stall_")
    shard = os.path.join(root, "shard")
    write_records(shard, *synthetic_arrays(args.records, seed=0))
    runners = {
        mode: _make_runner(
            shard, args.batch, args.hidden, args.warmup, mode,
            args.dtype, args.buckets, args.ndata, args.zero_update,
            head=args.head, device=args.device,
        )
        for mode in MODES
    }
    # interleaved best-of-trials: one window per mode per round so
    # host-load bursts land on every mode
    best = {mode: float("inf") for mode in runners}
    for _ in range(args.trials):
        for mode, (_, window, _) in runners.items():
            best[mode] = min(best[mode], window(args.steps) / args.steps)
    ms = {mode: best[mode] * 1e3 for mode in MODES}
    comm_ms = {
        mode: round(measure_comm_ms(t), 3)
        for mode, (t, _, _) in runners.items()
    }
    ratio = ms["q8_overlap"] / ms["exact"]
    share = comm_ms["q8_overlap"] / ms["exact"]
    ratio_ok = ratio <= args.threshold
    share_ok = share <= args.machinery_share
    ok = ratio_ok or share_ok
    # gate 2: the int8 ring; the gated ratio divides by the COUNTED bytes
    # and the model must agree with them exactly
    t_ring, _, s_ring = runners["q8_ring"]
    wire = measure_wire_bytes(t_ring, s_ring["step"])
    wire_ratio = (
        wire["reference"] / wire["ring_jaxpr"]
        if wire["ring_jaxpr"]
        else None
    )
    wire_model_ok = wire["quantized_ring"] == wire["ring_jaxpr"]
    ring_ratio = ms["q8_ring"] / ms["exact"]
    ring_ratio_ok = ring_ratio <= args.threshold
    wire_ok = wire_model_ok and (wire_ratio or 0) >= args.wire_threshold
    ring_ok = ring_ratio_ok or wire_ok
    # gate 3: the two-level ring, per level
    t_hier, _, s_hier = runners["q8_hier"]
    hwire = measure_wire_bytes(t_hier, s_hier["step"])
    hier_deg = int(hwire.get("intra_degree", 1))
    hier_model_ok = (
        hwire.get("intra") == hwire.get("ring_jaxpr_intra")
        and hwire.get("inter") == hwire.get("ring_jaxpr_inter")
    )
    hier_wire_ok = hier_model_ok and (
        hwire.get("inter", 0) * hier_deg <= hwire.get("flat_ring", 0)
    )
    hier_ratio = ms["q8_hier"] / ms["exact"]
    hier_ratio_ok = hier_ratio <= args.threshold
    hier_ok = hier_ratio_ok or hier_wire_ok
    out = {
        "exact_step_ms": round(ms["exact"], 3),
        "quantized_step_ms": round(ms["quantized"], 3),
        "overlap_step_ms": round(ms["overlap"], 3),
        "q8_overlap_step_ms": round(ms["q8_overlap"], 3),
        "q8_ring_step_ms": round(ms["q8_ring"], 3),
        "q8_hier_step_ms": round(ms["q8_hier"], 3),
        "quantized_ratio": round(ms["quantized"] / ms["exact"], 3),
        "overlap_ratio": round(ms["overlap"] / ms["exact"], 3),
        "q8_overlap_ratio": round(ratio, 3),
        "q8_ring_ratio": round(ring_ratio, 3),
        "q8_hier_ratio": round(hier_ratio, 3),
        "comm_ms": comm_ms,
        "wire_bytes": wire,
        "hier_wire_bytes": hwire,
        "hier_model_matches_jaxpr": hier_model_ok,
        "hier_intra_degree": hier_deg,
        "wire_bytes_ratio": round(wire_ratio, 3) if wire_ratio else None,
        "wire_model_matches_jaxpr": wire_model_ok,
        "wire_threshold": args.wire_threshold,
        "dtype": args.dtype,
        "buckets": args.buckets,
        "ndata": args.ndata,
        "zero_update": bool(args.zero_update),
        "threshold": args.threshold,
        "machinery_share": round(share, 4),
        "machinery_share_threshold": args.machinery_share,
        "pass_mode": (
            ("step_ratio" if ratio_ok else "machinery_share")
            if ok
            else None
        ),
        "ring_pass_mode": (
            ("step_ratio" if ring_ratio_ok else "wire_bytes")
            if ring_ok
            else None
        ),
        "hier_pass_mode": (
            ("step_ratio" if hier_ratio_ok else "wire_bytes")
            if hier_ok
            else None
        ),
        "pass": ok and ring_ok and hier_ok,
    }
    print(json.dumps(out))
    return 0 if (ok and ring_ok and hier_ok) else 1


if __name__ == "__main__":
    sys.exit(main())
