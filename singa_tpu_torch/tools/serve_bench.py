"""Serving-tier load harness for the PyTorch port: continuous batching
vs one-at-a-time, speculative vs one-token ticks.

The counterpart of ``singa_tpu/tools/serve_bench.py``'s core arm. It
drives a deterministic request workload (prompts from ``--seed``)
through the port's serving tier (serve/engine.py + serve/scheduler.py)
and prints one JSON line last::

  {"tokens_per_s": .., "p50_ms": .., "p99_ms": .., "speedup": ..,
   "token_mismatches": .., "device": .., "pass": .., ...}

Default arm: the measured engine at ``--concurrency`` slots against the
same stack at ``slots=1`` (one stream at a time). ``speedup`` is the
measured tokens/s over that baseline; ``--threshold`` gates it.

``--speculate_k K`` (> 0): the measured engine runs n-gram-drafted
verify ticks emitting up to K+1 tokens per slot per tick, against
one-token ticks at the same concurrency; ``speedup`` is then
speculative over one-token tokens/s, gated by ``--spec_threshold``. Use
``--workload repeat`` (prompts tiling a short motif, the drafter's home
turf).

``--workload shared_prefix`` benchmarks the PREFIX CACHE: every prompt
is one common prefix (``prompt_len - min(4, prompt_len // 4)`` tokens, a
system prompt) and a unique tail. Warm admission (cache on, seeded by
two throwaway requests of the first prompt: the second is a
whole-prompt hit, so the COW path is warm too) runs against cold
admission (cache off, every prompt prefilled whole) on the same engine
shape. Or-gate (``--prefix_threshold``, default 1.5): warm tokens/s at
least that multiple of cold, OR prefill chunks executed down at least
2x (a counter, so it holds whatever the host's timing). Streams must
equal the cold run's either way. ``--prefix_cache`` turns the cache on
in the other arms too.

Baselines always attend through ``reference`` (gather +
``cache_attend``), so the stream check (``token_mismatches`` must be 0)
doubles as a fused-vs-reference check when ``--kernels fused``.

``--fleet`` benchmarks a disaggregated fleet (serve/fleet/): one host
per ``--fleet_hosts`` role, one engine each, behind the front-door
router, over ``--transport local|mailbox|socket`` (``--wire_faults``
arms the socket's fault drills), against one unified engine at the same
slots, which is also the token oracle. Or-gate: fleet tokens/s at least
``--fleet_threshold`` x the unified engine's, OR the decode hosts ran 0
prefill chunks with >= 1 migration; streams must match either way.
``--sigterm_at_tick K --sigterm_host H`` drains host H to its peers at
fleet round K (exit 75, streams still identical). ``--rollout
promote|parity_fail`` hot-swaps a new weight version into the running
fleet at ``--rollout_at_tick`` (serve/rollout.py) and gates on the
verdict, zero hung streams and bitwise pre-flip streams.
``--arrival poisson`` adds a seeded open-loop section at ``--rate``
requests/s; ``--sigterm_at_tick`` without ``--fleet`` drains the single
engine (exit 75); ``--workspace`` records the flight recorder's events
there. ``--fleet --workload shared_prefix`` is the fleet prefix
cache's drill: two unified hosts, the measured requests on the one that
never saw the prompts, warm only through cache_fetch -> cache_ship,
against cold admission (or-gate ``--prefix_threshold`` tokens/s or 2x
fewer prefill chunks; streams equal to cold and >= 1 block shipped).

Runs on the GPU by default; ``--device cpu`` runs the plain PyTorch
versions on the CPU (times are then the CPU's, and ``device`` says so).

Usage::

  python -m singa_tpu_torch.tools.serve_bench [--concurrency 8]
      [--requests 16] [--d_model 256] [--n_layers 2] [--n_heads 4]
      [--vocab 256] [--max_len 128] [--prompt_len 8] [--max_new 48]
      [--block_len 16] [--kv_blocks 0] [--prefill_chunk 16]
      [--speculate_k K] [--workload random|repeat|shared_prefix]
      [--prefix_cache] [--prefix_threshold 1.5]
      [--kernels fused|reference] [--device cuda|cpu] [--no_gate]
      [--fleet [--fleet_hosts prefill,decode] [--fleet_threshold 1.5]
       [--transport local|mailbox|socket] [--wire_faults PLAN]
       [--sigterm_host H --sigterm_at_tick K]]
      [--rollout off|promote|parity_fail] [--rollout_at_tick 8]
      [--arrival batch|poisson] [--rate 8] [--workspace DIR]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.transformer import TransformerConfig, init_lm
from ..ops import paged_attention as pa
from ..resilience.preemption import EXIT_RESUMABLE, PreemptionHandler
from ..serve import Engine, EngineConfig, Request, Scheduler
from .trace import _percentile


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="serve_bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--concurrency", type=int, default=8,
                    help="serving slots (decode batch width)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--threshold", type=float, default=2.0,
                    help="min tokens/sec speedup over slots=1")
    ap.add_argument("--d_model", type=int, default=256)
    ap.add_argument("--n_layers", type=int, default=2)
    ap.add_argument("--n_heads", type=int, default=4)
    ap.add_argument("--d_ff", type=int, default=1024)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--max_len", type=int, default=128)
    ap.add_argument("--prompt_len", type=int, default=8)
    ap.add_argument("--max_new", type=int, default=48)
    ap.add_argument("--block_len", type=int, default=16)
    ap.add_argument("--kv_blocks", type=int, default=0)
    ap.add_argument("--prefill_chunk", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--speculate_k", type=int, default=0,
                    help="> 0: benchmark speculative decode at this draft "
                    "width against the one-token tick")
    ap.add_argument("--spec_threshold", type=float, default=1.3,
                    help="min speculative tokens/sec over the one-token "
                    "tick")
    ap.add_argument("--workload", default="random",
                    choices=("random", "repeat", "shared_prefix"),
                    help="prompt shape: 'repeat' tiles a short motif, the "
                    "n-gram drafter's home turf; 'shared_prefix' is one "
                    "common prefix and a unique tail, the prefix cache's "
                    "gate")
    ap.add_argument("--prefix_cache", action="store_true",
                    help="prefix cache on in the measured engine (implied "
                    "by --workload shared_prefix)")
    ap.add_argument("--prefix_threshold", type=float, default=1.5,
                    help="min warm tokens/sec over cold on shared_prefix "
                    "(or-gated with a >= 2x drop in prefill chunks)")
    ap.add_argument("--kernels", default="fused",
                    choices=("fused", "reference"),
                    help="attention on the measured engine: 'fused' = the "
                    "CUDA paged-attention kernel (its plain version on the "
                    "CPU), 'reference' = gather + cache_attend")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' must be asked "
                    "for)")
    ap.add_argument("--fleet", action="store_true",
                    help="benchmark a disaggregated fleet: --fleet_hosts "
                    "role-split hosts behind the router vs one unified "
                    "engine at the same slots. Or-gate: fleet tokens/s >= "
                    "--fleet_threshold x unified, OR decode hosts ran 0 "
                    "prefill chunks with >= 1 migration; streams must "
                    "match either way")
    ap.add_argument("--fleet_hosts", default="prefill,decode",
                    help="comma-separated roles, one host per entry (names "
                    "are role+index, e.g. prefill0,decode0)")
    ap.add_argument("--fleet_threshold", type=float, default=1.5,
                    help="min fleet tokens/s over the unified engine "
                    "(or-gated with the role-split proof)")
    ap.add_argument("--transport", default="local",
                    choices=("local", "mailbox", "socket"),
                    help="with --fleet: in-process deques, filesystem "
                    "mailboxes, or TCP over loopback (comm/wire.py); "
                    "mailbox and socket also report the migration round "
                    "trip and the router's status staleness")
    ap.add_argument("--wire_faults", default=None,
                    help="with --transport socket: a wire-fault plan, e.g. "
                    "'wire_drop@12,wire_torn@18' (ordinals count message "
                    "sends); streams must still match")
    ap.add_argument("--sigterm_host", default=None,
                    help="with --fleet and --sigterm_at_tick: the host (by "
                    "name, or by role = its first host) that drains to its "
                    "peers; exit 75, streams still identical")
    ap.add_argument("--rollout", default="off",
                    choices=("off", "promote", "parity_fail"),
                    help="live weight-rollout drill on a --fleet_hosts "
                    "fleet: 'promote' expects verdict promoted, "
                    "'parity_fail' perturbs one expected probe token and "
                    "expects the fleet-wide rollback")
    ap.add_argument("--rollout_at_tick", type=int, default=8,
                    help="with --rollout: fleet rounds served on the "
                    "current version before the controller starts")
    ap.add_argument("--arrival", default="batch",
                    choices=("batch", "poisson"),
                    help="'poisson' adds a seeded open-loop arrival "
                    "section (tokens/s + submit->finish p50/p99)")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="poisson arrival rate, requests/s")
    ap.add_argument("--workspace", default=None,
                    help="record the flight recorder's events under this "
                    "workspace")
    ap.add_argument("--sigterm_at_tick", type=int, default=0,
                    help="drain drill: trigger the preemption plane at "
                    "this tick and exit 75 (0 = off)")
    ap.add_argument("--no_gate", action="store_true",
                    help="report only; never fail on the threshold")
    return ap


def _token_mismatches(ref_sched, sched) -> int:
    """Streams that differ between a reference run and the measured run,
    matched by rid (a rid missing from either side counts)."""
    got = {r.rid: r.tokens for r in sched.finished}
    return sum(
        1 for r in ref_sched.finished if got.get(r.rid) != r.tokens
    )


def _workload(args) -> list[np.ndarray]:
    """Deterministic prompts of ``--prompt_len`` tokens; ``repeat``
    tiles a per-request 4-token motif; ``shared_prefix`` draws one common
    prefix first (only for that workload, so the others' prompts stay
    as they were) and a unique tail per request."""
    rs = np.random.RandomState(args.seed)
    prompts = []
    if args.workload == "shared_prefix":
        tail = max(1, min(4, args.prompt_len // 4))
        prefix = rs.randint(0, args.vocab, size=(args.prompt_len - tail,))
    for _ in range(args.requests):
        if args.workload == "repeat":
            motif = rs.randint(0, args.vocab, size=(4,))
            pr = np.tile(motif, args.prompt_len // 4 + 1)[:args.prompt_len]
        elif args.workload == "shared_prefix":
            pr = np.concatenate(
                [prefix, rs.randint(0, args.vocab, size=(tail,))])
        else:
            pr = rs.randint(0, args.vocab, size=(args.prompt_len,))
        prompts.append(pr.astype(np.int32))
    return prompts


def _engine_config(args, slots, spec_k=0, kernels="reference",
                   prefix_cache=False) -> EngineConfig:
    return EngineConfig(
        slots=slots,
        kv_block_len=args.block_len,
        kv_blocks=args.kv_blocks,
        max_prefill_chunk=args.prefill_chunk,
        spec_k=spec_k,
        prefix_cache=prefix_cache,
        attend_impl=kernels,
    )


def _warmed_scheduler(params, cfg, prompts, args, slots, device, spec_k=0,
                      kernels="reference", prefix_cache=False,
                      recorder=None, preemption=None):
    """An engine + scheduler warmed with a throwaway request (kernel
    build, graph capture, allocator start-up stay out of the timed run),
    counters zeroed, the recorder attached only after. With
    ``prefix_cache`` a second throwaway of the same prompt is a
    whole-prompt hit (the COW path runs before the timed run too), and
    the first prompt's blocks stay cached: the measured requests admit
    into a warm pool."""
    engine = Engine(
        params, cfg,
        _engine_config(args, slots, spec_k, kernels, prefix_cache),
        device=device,
    )
    sched = Scheduler(engine, preemption=preemption)
    for rid in ((-1, -2) if prefix_cache else (-1,)):
        sched.submit(Request(rid=rid, prompt=np.asarray(prompts[0]),
                             max_new_tokens=2))
        sched.serve()
    sched.recorder = recorder
    sched.reset_counters()
    engine.allocator.peak_used = engine.allocator.used_blocks
    return sched


def run_continuous(params, cfg, prompts, args, slots, device, spec_k=0,
                   kernels="reference", prefix_cache=False, recorder=None,
                   preemption=None, sigterm_at_tick=0):
    """The serving stack at ``slots`` concurrency (slots=1 is the
    one-at-a-time baseline), warmed by ``_warmed_scheduler``. With
    ``sigterm_at_tick`` the preemption plane fires at that tick (the
    flag path of a real SIGTERM) and the serve loop drains. -> (scheduler,
    elapsed_s, drain accounting | None)."""
    sched = _warmed_scheduler(
        params, cfg, prompts, args, slots, device, spec_k, kernels,
        prefix_cache, recorder=recorder, preemption=preemption)
    for i, pr in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=pr, max_new_tokens=args.max_new,
                             seed=args.seed + i))
    t0 = time.perf_counter()
    if sigterm_at_tick:
        sched.serve(max_ticks=sigterm_at_tick)
        preemption.trigger(f"sigterm_at_tick {sigterm_at_tick}")
    acct = sched.serve()
    return sched, time.perf_counter() - t0, acct


def run_poisson(params, cfg, prompts, args, device):
    """Open-loop load: requests arrive on a seeded Poisson schedule
    (exponential inter-arrivals at ``--rate`` requests/s) while the serve
    loop ticks: latency under load, queueing included. -> (scheduler,
    elapsed_s, submit->finish latencies ms)."""
    sched = _warmed_scheduler(
        params, cfg, prompts, args, args.concurrency, device,
        args.speculate_k, args.kernels)
    rs = np.random.RandomState(args.seed + 1)
    arrivals = np.cumsum(rs.exponential(1.0 / max(args.rate, 1e-9),
                                        size=len(prompts)))
    pending = list(zip(arrivals, range(len(prompts))))
    t0 = time.perf_counter()
    while pending or sched.busy:
        now = time.perf_counter() - t0
        while pending and pending[0][0] <= now:
            _, i = pending.pop(0)
            sched.submit(Request(rid=i, prompt=prompts[i],
                                 max_new_tokens=args.max_new,
                                 seed=args.seed + i))
        if not sched.busy:
            # idle until the next arrival: the server never pulls load
            # forward
            time.sleep(min(max(pending[0][0] - now, 0.0), 0.01))
            continue
        sched.tick()
    elapsed = time.perf_counter() - t0
    lat_ms = sorted((r.finish_mono - r.enqueue_mono) * 1e3
                    for r in sched.finished)
    return sched, elapsed, lat_ms


def _tokens_per_s(sched, seconds) -> float:
    # + the first token of each request, sampled at activation
    tokens = sched.tokens_emitted + len(sched.finished)
    return round(tokens / seconds, 1) if seconds > 0 else 0.0


# ---------------------------------------------------------------------------
# the fleet: role-split hosts behind the router (serve/fleet/)
# ---------------------------------------------------------------------------


class _TimedSend:
    """Transport proxy that times ``migrate`` sends (submit -> the
    transport's own done signal: the receiver's ACK on the socket
    wiring, i.e. the migration round trip). Everything else forwards
    untouched."""

    def __init__(self, inner):
        self._inner = inner
        self.migrate_ms: list[float] = []

    def send(self, dst, kind, payload, *, src):
        t0 = time.perf_counter()
        self._inner.send(dst, kind, payload, src=src)
        if kind == "migrate":
            self.migrate_ms.append((time.perf_counter() - t0) * 1e3)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _build_transport_arm(args):
    """The --transport wiring: None for 'local' (build_fleet's
    default), a Mailbox under --workspace (else a temporary root), or a
    loopback SocketTransport with --wire_faults armed."""
    if args.transport == "local":
        return None
    if args.transport == "mailbox":
        import os
        import tempfile

        from ..serve.fleet import Mailbox

        root = (os.path.join(args.workspace, "mailbox") if args.workspace
                else tempfile.mkdtemp(prefix="serve_bench_mbx_"))
        return Mailbox(root)
    from ..comm import SocketTransport, WireFaults
    from ..resilience.faults import FaultPlan

    faults = None
    if args.wire_faults:
        faults = WireFaults(FaultPlan.parse(args.wire_faults))
    # a generous retry budget, a tight per-attempt deadline: injected
    # drops and torn frames end in redelivery, not a tombstone
    return SocketTransport(
        connect_timeout_s=2.0, send_timeout_s=1.0, max_retries=6,
        backoff_s=0.02, backoff_cap_s=0.25, faults=faults,
    )


def build_fleet(params, cfg, args, device, *, transport=None):
    """Hosts (one engine each) + router per ``--fleet_hosts``, in one
    process over ``transport`` (default in-process deques), with the
    real migration wire bytes. -> (hosts, router, transport)."""
    from ..serve.fleet import FleetHost, LocalTransport, Router

    roles = [r.strip() for r in args.fleet_hosts.split(",") if r.strip()]
    if not roles:
        raise ValueError("--fleet_hosts named no hosts")
    names, seen = [], {}
    for role in roles:
        seen[role] = seen.get(role, 0)
        names.append(f"{role}{seen[role]}")
        seen[role] += 1
    topo = list(zip(names, roles))
    ec = _engine_config(args, args.concurrency, args.speculate_k,
                        args.kernels, args.prefix_cache)
    transport = transport or LocalTransport()
    hosts = [
        FleetHost(name, role, Engine(params, cfg, ec, device=device),
                  transport, peers={n: r for n, r in topo if n != name})
        for name, role in topo
    ]
    router = Router(transport,
                    block_len=args.block_len if args.prefix_cache else 0)
    return hosts, router, transport


def _paged_launches() -> int:
    return pa.paged_attention.launches + pa.paged_attention_overlay.launches


def _tick(host, launches=None) -> int:
    """One round of ``host``; ``launches`` (a dict) gathers its
    paged-attention launches (the counters' growth across its own
    round). -> tokens emitted."""
    if launches is None:
        return host.tick()
    before = _paged_launches()
    emitted = host.tick()
    launches[host.name] = (launches.get(host.name, 0)
                           + _paged_launches() - before)
    return emitted


def pump_fleet(hosts, *, stop_after=None, launches=None):
    """Tick every host until the fleet runs dry (three idle rounds: a
    migration, fetch or ship sits in the transport for one round) or
    ``stop_after`` rounds; ``launches`` as in ``_tick``. -> rounds
    run."""
    idle = rounds = 0
    for _ in range(10 ** 5):
        if stop_after is not None and rounds >= stop_after:
            return rounds
        for h in hosts:
            _tick(h, launches)
        rounds += 1
        idle = idle + 1 if not any(h.busy for h in hosts) else 0
        if idle >= 3:
            return rounds
    raise RuntimeError("fleet stalled")


def warm_fleet(hosts, router, prompt, waves=1):
    """Build and capture every host's programs through the real fleet
    path, off the clock: one throwaway request per decode-capable host
    a wave (the tie-rotating export spreads them), then zero the
    counters."""
    per_wave = max(1, sum(1 for h in hosts
                          if h.role in ("decode", "unified")))
    rid = -1
    for _ in range(waves):
        for _ in range(per_wave):
            router.submit(Request(rid=rid, prompt=np.asarray(prompt),
                                  max_new_tokens=2))
            rid -= 1
        pump_fleet(hosts)
    reset_fleet(hosts, router)


def reset_fleet(hosts, router) -> None:
    """Zero the hosts' and the router's counters and finished lists
    (live and queued requests are untouched)."""
    for h in hosts:
        h.sched.reset_counters()
        h.migrate_in = h.migrate_out = 0
        h.blocks_in = h.blocks_out = 0
        h.engine.allocator.peak_used = h.engine.allocator.used_blocks
    router.routed = router.affinity_hits = 0


def fleet_streams(hosts, rid_min=0) -> dict:
    return {r.rid: list(r.tokens) for h in hosts for r in h.sched.finished
            if r.rid >= rid_min}


def run_fleet(params, cfg, prompts, args, device, *, recorders=None,
              router_recorder=None, fleet=None, launches=None):
    """Drive the workload through the fleet (batch submit or the
    --arrival poisson open loop). ``--sigterm_at_tick`` drains the
    ``--sigterm_host`` host to its peers at that round; the fleet
    finishes without it. ``fleet`` (hosts, router) runs on a fleet
    already built and warmed (its counters zeroed first) instead of a
    new one per ``--transport``; ``launches`` (a dict) gathers each
    host's paged-attention launches. -> (hosts, router, elapsed_s,
    streams, queue-inclusive latencies ms, drain accounting | None, wire
    report | None: migration round trips, status staleness, the socket's
    counters and the wire faults that never fired)."""
    if fleet is not None:
        wire_arm = timed = None
        hosts, router = fleet
        reset_fleet(hosts, router)
    else:
        wire_arm = _build_transport_arm(args)
        timed = _TimedSend(wire_arm) if wire_arm is not None else None
        if timed is not None and recorders:
            wire_arm.recorder = recorders[0]
        hosts, router, _ = build_fleet(params, cfg, args, device,
                                       transport=timed)
        warm_fleet(hosts, router, prompts[0],
                   waves=2 if args.prefix_cache else 1)
    target = None
    if args.sigterm_at_tick:
        by_name = {h.name: h for h in hosts}
        target = by_name.get(args.sigterm_host) or next(
            (h for h in hosts if h.role == (args.sigterm_host or "decode")),
            None)
        if target is None:
            raise ValueError(f"--sigterm_host {args.sigterm_host!r} names "
                             "no fleet host")
    if recorders:
        for h, rec in zip(hosts, recorders):
            h.sched.recorder = rec
            h._event("fleet_role", host=h.name, role=h.role)
    router.recorder = router_recorder
    if args.arrival == "poisson":
        rs = np.random.RandomState(args.seed + 1)
        arrivals = np.cumsum(rs.exponential(1.0 / max(args.rate, 1e-9),
                                            size=len(prompts)))
        pending = list(zip(arrivals, range(len(prompts))))
    else:
        pending = [(0.0, i) for i in range(len(prompts))]
    acct = None
    dead: set = set()
    rids = set(range(len(prompts)))
    tick = idle_rounds = 0
    # router status staleness: how old each host's latest-wins snapshot
    # is when the placement loop reads it
    stale_ms: list[float] = []
    stale_last: dict[str, tuple[dict, float]] = {}
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        while pending and pending[0][0] <= now:
            _, i = pending.pop(0)
            router.submit(Request(rid=i, prompt=prompts[i],
                                  max_new_tokens=args.max_new,
                                  seed=args.seed + i))
        if target is not None and tick >= args.sigterm_at_tick \
                and target.name not in dead:
            # the preemption plane's flag path, then the host drains to
            # its peers and stops ticking
            acct = target.drain(f"sigterm_at_tick {args.sigterm_at_tick}")
            dead.add(target.name)
        alive = [h for h in hosts if h.name not in dead]
        for h in alive:
            _tick(h, launches)
        busy = any(h.busy for h in alive)
        finished = {r.rid for h in hosts for r in h.sched.finished
                    if r.rid >= 0}
        if finished >= rids and not pending:
            break
        idle_rounds = 0 if busy else idle_rounds + 1
        if idle_rounds >= 4 and not pending:
            raise RuntimeError("fleet stalled with requests unfinished: "
                               f"{sorted(rids - finished)}")
        if timed is not None and tick % 5 == 0:
            snap_t = time.perf_counter()
            for hname, st in timed.statuses().items():
                prev = stale_last.get(hname)
                if prev is None or prev[0] != st:
                    stale_last[hname] = (st, snap_t)
                else:
                    stale_ms.append((snap_t - prev[1]) * 1e3)
        if not busy and pending:
            time.sleep(min(max(pending[0][0] - now, 0.0), 0.01))
        tick += 1
    elapsed = time.perf_counter() - t0
    lat_ms = sorted((r.finish_mono - r.enqueue_mono) * 1e3
                    for h in hosts for r in h.sched.finished if r.rid >= 0)
    wire = None
    if timed is not None:
        stats = getattr(wire_arm, "wire_stats", None)
        faults = getattr(wire_arm, "faults", None)
        wire = {"migrate_rtt_ms": sorted(timed.migrate_ms),
                "status_staleness_ms": sorted(stale_ms),
                "stats": stats() if stats is not None else None,
                "unfired": [] if faults is None
                else [str(f) for f in faults.plan.unfired()]}
        close = getattr(wire_arm, "close", None)
        if close is not None:
            close()
    return hosts, router, elapsed, fleet_streams(hosts), lat_ms, acct, wire


def _recorders(args, n, run_id):
    """``n`` flight recorders under --workspace/events (None without a
    workspace)."""
    if not args.workspace:
        return None
    import os

    from ..obs.recorder import FlightRecorder

    events = os.path.join(args.workspace, "events")
    return [FlightRecorder(events, rank=i, run_id=run_id)
            for i in range(n)]


def _fleet_main(args, params, cfg, prompts, device) -> int:
    """The --fleet drill: role-split hosts behind the router vs one
    unified engine at the same per-host slots (also the token oracle:
    routing and migration may never move a token); with
    --sigterm_at_tick the drain-to-peer drill (exit 75)."""
    if args.workload == "shared_prefix" and not args.sigterm_at_tick:
        return _fleet_prefix_main(args, params, cfg, prompts, device)
    n_hosts = len([r for r in args.fleet_hosts.split(",") if r.strip()])
    recs = _recorders(args, n_hosts + 1, "serve_bench_fleet")
    base_sched, base_s, _ = run_continuous(
        params, cfg, prompts, args, slots=args.concurrency, device=device,
        spec_k=args.speculate_k, prefix_cache=args.prefix_cache,
        kernels=args.kernels)
    base = {r.rid: list(r.tokens) for r in base_sched.finished}
    hosts, router, elapsed, streams, lat_ms, acct, wire = run_fleet(
        params, cfg, prompts, args, device,
        recorders=recs[:n_hosts] if recs else None,
        router_recorder=recs[n_hosts] if recs else None)
    drill = bool(args.sigterm_at_tick)
    tokens = sum(len(t) for t in streams.values())
    mismatches = sum(1 for i in base if streams.get(i) != base[i])
    decode_prefill_chunks = sum(h.sched.prefill_chunks for h in hosts
                                if h.role == "decode")
    migrations = sum(h.migrate_in for h in hosts)
    out = {
        "fleet": True,
        "device": _device_name(device),
        "fleet_hosts": args.fleet_hosts,
        "concurrency": args.concurrency,
        "requests": len(prompts),
        "finished": len(streams),
        "tokens": tokens,
        "serve_s": round(elapsed, 4),
        "tokens_per_s": round(tokens / elapsed, 1) if elapsed > 0 else 0.0,
        "single_tokens_per_s": _tokens_per_s(base_sched, base_s),
        # queue-inclusive (front-door submit -> finish) latency
        "p50_ms": round(_percentile(lat_ms, 0.50), 2),
        "p99_ms": round(_percentile(lat_ms, 0.99), 2),
        "hosts": {
            h.name: {
                "role": h.role,
                "migrate_in": h.migrate_in,
                "migrate_out": h.migrate_out,
                "blocks_in": h.blocks_in,
                "blocks_out": h.blocks_out,
                "prefill_chunks": h.sched.prefill_chunks,
                **h.sched.occupancy(),
            }
            for h in hosts
        },
        "migrations": migrations,
        "routed": router.routed,
        "affinity_hits": router.affinity_hits,
        "token_mismatches": mismatches,
        "decode_prefill_chunks": decode_prefill_chunks,
        "fleet_threshold": args.fleet_threshold,
        "transport": args.transport,
    }
    if wire is not None:
        rtt, stale = wire["migrate_rtt_ms"], wire["status_staleness_ms"]
        out["wire"] = {
            "migrate_rtt_ms": {"p50": round(_percentile(rtt, 0.50), 3),
                               "p99": round(_percentile(rtt, 0.99), 3),
                               "n": len(rtt)},
            "status_staleness_ms": {
                "p50": round(_percentile(stale, 0.50), 3),
                "p99": round(_percentile(stale, 0.99), 3),
                "n": len(stale)},
        }
        if wire["stats"] is not None:
            out["wire"].update({k: v for k, v in wire["stats"].items()
                                if k != "send_ms"})
    out["fleet_speedup"] = (
        round(out["tokens_per_s"] / out["single_tokens_per_s"], 3)
        if out["single_tokens_per_s"] else None)
    has_decode = any(h.role == "decode" for h in hosts)
    # or-gate: the end-to-end speedup where N hosts are N cards; the
    # role split proved (decode hosts ran no prefill while sequences
    # streamed through them) where the hosts share one card
    out["pass_mode"] = (
        "end_to_end" if (out["fleet_speedup"] or 0) >= args.fleet_threshold
        else "role_split"
        if has_decode and decode_prefill_chunks == 0 and migrations > 0
        else None)
    out["pass"] = mismatches == 0 and out["pass_mode"] is not None
    if drill:
        out["drained"] = acct is not None
        if acct is not None:
            out["drain"] = acct
    if recs:
        for i, rec in enumerate(recs[:n_hosts]):
            rec.event("run_stop", step=hosts[i].sched.ticks,
                      exit_code=EXIT_RESUMABLE if drill and acct else 0)
        for rec in recs:
            rec.close()
    print(json.dumps(out))
    if drill:
        return EXIT_RESUMABLE if acct is not None and out["pass"] else 1
    if args.no_gate:
        return 0
    return 0 if out["pass"] else 1


def _fleet_prefix_main(args, params, cfg, prompts, device) -> int:
    """The --fleet shared_prefix drill: the FLEET prefix cache. Two
    unified hosts on the in-process transport. The COLD phase serves
    every request on one fresh host with the cache OFF; the WARM phase
    first serves the whole workload on the OTHER host (parking its
    blocks on that host's LRU), then serves the measured requests on a
    host that has never seen the prompts — its only path to warm KV is
    a cross-host cache_fetch -> cache_ship over the wire. Or-gate (the
    CPU-CI pattern): warm end-to-end tokens/sec >=
    --prefix_threshold x cold, OR executed prefill chunks drop >= 2x
    (deterministic). Streams must match cold bitwise and >= 1 block
    must actually ship either way."""
    import copy

    def submit_wave(host, rid0):
        for i, pr in enumerate(prompts):
            host.submit(Request(
                rid=rid0 + i, prompt=np.asarray(pr, np.int32),
                max_new_tokens=args.max_new, seed=args.seed + i,
            ))

    def reset(hosts):
        for h in hosts:
            h.sched.finished.clear()
            h.sched.reset_counters()
            h.cache_fetches = h.cache_fetch_timeouts = 0
            h.cache_ships_in = h.cache_ships_out = 0
            h.ship_blocks_in = h.ship_blocks_out = 0
            h.ship_bytes_in = h.ship_bytes_out = 0

    # COLD: cache off, the whole workload on ONE host (its peer idles
    # — the same per-host compute the warm phase's serving host gets)
    cargs = copy.copy(args)
    cargs.fleet_hosts = "unified,unified"
    cargs.prefix_cache = False
    cold_hosts, _, _ = build_fleet(params, cfg, cargs, device)
    # build and capture off the clock, then zero the counters
    cold_hosts[1].submit(Request(
        rid=-1, prompt=np.asarray(prompts[0]), max_new_tokens=2,
    ))
    pump_fleet(cold_hosts)
    reset(cold_hosts)
    _sync(device)
    t0 = time.perf_counter()
    submit_wave(cold_hosts[1], 0)
    pump_fleet(cold_hosts)
    _sync(device)
    cold_s = time.perf_counter() - t0
    cold = {
        r.rid: list(r.tokens)
        for h in cold_hosts for r in h.sched.finished if r.rid >= 0
    }
    cold_chunks = sum(h.sched.prefill_chunks for h in cold_hosts)
    cold_tokens = sum(len(t) for t in cold.values())

    # WARM: cache on. The warm wave runs the SAME workload on host0,
    # parking every prompt's blocks (the shared prefix AND the unique
    # tails) on ITS LRU; host1 compile-warms on a DISJOINT prompt
    # (sharing the prefix here would register it locally and bypass
    # the wire entirely), so its measured admissions can only go warm
    # through cache_fetch -> cache_ship.
    wargs = copy.copy(args)
    wargs.fleet_hosts = "unified,unified"
    wargs.prefix_cache = True
    warm_hosts, _, _ = build_fleet(params, cfg, wargs, device)
    h0, h1 = warm_hosts
    rs = np.random.RandomState(args.seed + 997)
    h1.submit(Request(
        rid=-1,
        prompt=rs.randint(
            0, args.vocab, size=(args.prompt_len,)
        ).astype(np.int32),
        max_new_tokens=2,
    ))
    h0.submit(Request(
        rid=-2, prompt=np.asarray(prompts[0]), max_new_tokens=2,
    ))
    pump_fleet(warm_hosts)
    submit_wave(h0, 10 ** 6)  # the warm wave (uncounted)
    pump_fleet(warm_hosts)
    reset(warm_hosts)
    recorders = _recorders(args, len(warm_hosts), "serve_bench_fleetprefix")
    if recorders:
        for h, rec in zip(warm_hosts, recorders):
            h.sched.recorder = rec
            h._event("fleet_role", host=h.name, role=h.role)
    _sync(device)
    t0 = time.perf_counter()
    submit_wave(h1, 0)
    pump_fleet(warm_hosts)
    _sync(device)
    warm_s = time.perf_counter() - t0
    warm = {
        r.rid: list(r.tokens)
        for h in warm_hosts for r in h.sched.finished if r.rid >= 0
    }
    warm_chunks = sum(h.sched.prefill_chunks for h in warm_hosts)
    warm_tokens = sum(len(t) for t in warm.values())

    mismatches = sum(1 for i in cold if warm.get(i) != cold[i])
    blocks_shipped = sum(h.ship_blocks_in for h in warm_hosts)
    ship_bytes = sum(h.ship_bytes_in for h in warm_hosts)
    admitted = len(warm) or 1
    hits = sum(h.sched.prefix_hits for h in warm_hosts)
    out = {
        "fleet": True,
        "device": _device_name(device),
        "workload": "shared_prefix",
        "fleet_hosts": "unified,unified",
        "requests": len(prompts),
        "finished": len(warm),
        "tokens": warm_tokens,
        "cold_tokens": cold_tokens,
        "serve_s": round(warm_s, 4),
        "cold_s": round(cold_s, 4),
        "tokens_per_s": round(warm_tokens / warm_s, 1)
        if warm_s > 0 else 0.0,
        "cold_tokens_per_s": round(cold_tokens / cold_s, 1)
        if cold_s > 0 else 0.0,
        "hit_rate": round(hits / admitted, 4),
        "cache_fetches": sum(h.cache_fetches for h in warm_hosts),
        "cache_fetch_timeouts": sum(
            h.cache_fetch_timeouts for h in warm_hosts
        ),
        "blocks_shipped": blocks_shipped,
        "ship_bytes": ship_bytes,
        "prefill_chunks": warm_chunks,
        "cold_prefill_chunks": cold_chunks,
        "prefill_chunk_ratio": round(cold_chunks / warm_chunks, 3)
        if warm_chunks else None,
        "token_mismatches": mismatches,
        "prefix_threshold": args.prefix_threshold,
        "transport": "local",
    }
    out["fleet_speedup"] = (
        round(out["tokens_per_s"] / out["cold_tokens_per_s"], 3)
        if out["cold_tokens_per_s"] else None
    )
    # or-gate: end-to-end carries on accelerator hosts; on CPU CI the
    # deterministic arm carries (warm admissions EXECUTED >= 2x fewer
    # prefill chunks than cold). Streams must match and >= 1 block
    # must have moved over the wire either way.
    out["pass_mode"] = (
        "end_to_end"
        if (out["fleet_speedup"] or 0) >= args.prefix_threshold
        else "chunk_drop"
        if (out["prefill_chunk_ratio"] or 0) >= 2.0
        else None
    )
    out["pass"] = (
        mismatches == 0 and blocks_shipped >= 1
        and out["pass_mode"] is not None
    )
    if recorders:
        for i, rec in enumerate(recorders):
            rec.event(
                "run_stop", step=warm_hosts[i].sched.ticks, exit_code=0,
            )
            rec.close()
    print(json.dumps(out))
    if args.no_gate:
        return 0
    return 0 if out["pass"] else 1


def _rollout_main(args, params, cfg, prompts, device) -> int:
    """The --rollout drill: live weight hot-swap under load. One fleet
    serves the workload; at --rollout_at_tick the controller stages a
    new version, canaries one decode-capable host, parity-probes it and
    promotes (or, parity_fail, rolls the fleet back). The oracle is the
    same fleet with no rollout: every stream retired before the
    controller starts must match it bitwise, every stream must finish,
    and every host must land on the expected version."""
    from ..serve.rollout import RolloutController

    def serve(hosts, router, stop_after=None):
        for i, pr in enumerate(prompts):
            router.submit(Request(rid=i, prompt=np.asarray(pr, np.int32),
                                  max_new_tokens=args.max_new,
                                  seed=args.seed + i))
        return pump_fleet(hosts, stop_after=stop_after)

    o_hosts, o_router, _ = build_fleet(params, cfg, args, device)
    warm_fleet(o_hosts, o_router, prompts[0])
    serve(o_hosts, o_router)
    oracle = fleet_streams(o_hosts)

    hosts, router, transport = build_fleet(params, cfg, args, device)
    warm_fleet(hosts, router, prompts[0])
    recs = _recorders(args, len(hosts) + 1, "serve_bench_rollout")
    if recs:
        for h, rec in zip(hosts, recs):
            h.sched.recorder = rec
            h._event("fleet_role", host=h.name, role=h.role)
    next_params = init_lm(torch.Generator().manual_seed(args.seed + 1),
                          cfg, device)
    serve(hosts, router, stop_after=args.rollout_at_tick)
    # everything finished before the controller starts is pre-flip
    pre_flip = set(fleet_streams(hosts))
    ctl = RolloutController(
        transport, {h.name: h.role for h in hosts},
        params=next_params, version=1, cfg=cfg,
        serving=hosts[0].engine.serving, probes=2, probe_tokens=4,
        stage_timeout_s=60.0, recorder=recs[-1] if recs else None,
        force_parity_fail=args.rollout == "parity_fail",
        tick=lambda: [h.tick() for h in hosts], device=device,
        log=lambda s: print(s, file=sys.stderr),
    )
    res = ctl.run()
    pump_fleet(hosts)
    streams = fleet_streams(hosts)
    want_verdict = "promoted" if args.rollout == "promote" else "rollback"
    want_version = 1 if args.rollout == "promote" else 0
    pre_mismatches = sum(1 for i in pre_flip
                         if streams.get(i) != oracle.get(i))
    hung = sorted(set(range(len(prompts))) - set(streams))
    versions = {h.name: h.engine.params_version for h in hosts}
    out = {
        "rollout": args.rollout,
        "device": _device_name(device),
        "fleet_hosts": args.fleet_hosts,
        "requests": len(prompts),
        "finished": len(streams),
        "hung": len(hung),
        "verdict": res["verdict"],
        "want_verdict": want_verdict,
        "rollbacks": res["rollbacks"],
        "torn_ships": res["torn_ships"],
        "canary": res["canary"],
        "versions": versions,
        "pre_flip_streams": len(pre_flip),
        "pre_flip_mismatches": pre_mismatches,
        "rollout_at_tick": args.rollout_at_tick,
    }
    out["pass"] = (res["verdict"] == want_verdict and not hung
                   and pre_mismatches == 0
                   and all(v == want_version for v in versions.values()))
    if recs:
        for rec in recs:
            rec.close()
    print(json.dumps(out))
    if args.no_gate:
        return 0
    return 0 if out["pass"] else 1


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, max_len=args.max_len,
    )
    params = init_lm(torch.Generator().manual_seed(args.seed), cfg, device)
    prompts = _workload(args)
    if args.rollout != "off":
        return _rollout_main(args, params, cfg, prompts, device)
    if args.fleet:
        return _fleet_main(args, params, cfg, prompts, device)
    drill = bool(args.sigterm_at_tick)
    if drill:
        return _drain_main(args, params, cfg, prompts, device)
    shared = args.workload == "shared_prefix"
    spec = args.speculate_k > 0 and not shared

    # the baseline: one stream at a time; one-token ticks at the same
    # concurrency under speculation; cold admission (cache off) on the
    # same engine shape for shared_prefix. Always the reference attend
    base, base_s, _ = run_continuous(
        params, cfg, prompts, args,
        slots=args.concurrency if spec or shared else 1, device=device,
        spec_k=args.speculate_k if shared else 0,
    )
    recs = _recorders(args, 1, "serve_bench")
    sched, serve_s, _ = run_continuous(
        params, cfg, prompts, args, slots=args.concurrency, device=device,
        spec_k=args.speculate_k, kernels=args.kernels,
        prefix_cache=shared or args.prefix_cache,
        recorder=recs[0] if recs else None,
    )
    lat = sorted(r.latency_s * 1e3 for r in sched.finished)
    out = {
        "device": _device_name(device),
        "concurrency": args.concurrency,
        "kernels": args.kernels,
        "requests": args.requests,
        "finished": len(sched.finished),
        "tokens": sched.tokens_emitted + len(sched.finished),
        "serve_s": round(serve_s, 4),
        "tokens_per_s": _tokens_per_s(sched, serve_s),
        "p50_ms": round(_percentile(lat, 0.50), 2),
        "p99_ms": round(_percentile(lat, 0.99), 2),
        **sched.occupancy(),
        "base_tokens_per_s": _tokens_per_s(base, base_s),
        # identity is the hard bar: throughput from wrong tokens is none
        "token_mismatches": _token_mismatches(base, sched),
    }
    out["speedup"] = (
        round(out["tokens_per_s"] / out["base_tokens_per_s"], 3)
        if out["base_tokens_per_s"] else None
    )
    threshold = (args.spec_threshold if spec else args.prefix_threshold
                 if shared else args.threshold)
    if spec:
        out["spec_k"] = args.speculate_k
    elif shared:
        out["prefill_chunks_cold"] = base.prefill_chunks
        out["prefill_chunks_warm"] = sched.prefill_chunks
        out["prefill_chunk_ratio"] = (
            round(base.prefill_chunks / sched.prefill_chunks, 3)
            if sched.prefill_chunks else None
        )
    else:
        # steady-state capacity: full-occupancy decode ticks only
        steady = (sched.full_tick_tokens / sched.full_tick_s
                  if sched.full_tick_s > 0 else 0.0)
        out["steady_tokens_per_s"] = round(steady, 1)
    out["threshold"] = threshold
    if args.arrival == "poisson":
        # the open-loop section reports beside the gated batch numbers
        psched, pelapsed, plat = run_poisson(params, cfg, prompts, args,
                                             device)
        out["poisson"] = {
            "rate": args.rate,
            "finished": len(psched.finished),
            "tokens_per_s": _tokens_per_s(psched, pelapsed),
            "p50_ms": round(_percentile(plat, 0.50), 2),
            "p99_ms": round(_percentile(plat, 0.99), 2),
            "backpressure_ticks": psched.backpressure_ticks,
        }
    if recs:
        recs[0].close()
    if shared:
        # or-gate: end-to-end warm over cold where prefill dominates; the
        # executed-chunk drop is the deterministic arm
        out["pass_mode"] = (
            "end_to_end" if (out["speedup"] or 0) >= threshold
            else "prefill_chunks"
            if (out["prefill_chunk_ratio"] or 0) >= 2.0 else None
        )
        out["pass"] = (
            out["token_mismatches"] == 0
            and out.get("prefix_hit_rate", 0) > 0
            and out["pass_mode"] is not None
        )
    else:
        out["pass"] = (
            out["token_mismatches"] == 0
            and (out["speedup"] or 0) >= threshold
        )
    print(json.dumps(out))
    if args.no_gate:
        return 0 if out["token_mismatches"] == 0 else 1
    return 0 if out["pass"] else 1


def _drain_main(args, params, cfg, prompts, device) -> int:
    """--sigterm_at_tick on the single engine: the preemption plane
    fires at that tick, the serve loop drains, and the bench exits 75
    with the drain accounting."""
    recs = _recorders(args, 1, "serve_bench")
    handler = PreemptionHandler()
    handler.install()
    try:
        sched, serve_s, acct = run_continuous(
            params, cfg, prompts, args, slots=args.concurrency,
            device=device, spec_k=args.speculate_k, kernels=args.kernels,
            prefix_cache=args.prefix_cache,
            recorder=recs[0] if recs else None, preemption=handler,
            sigterm_at_tick=args.sigterm_at_tick)
    finally:
        handler.uninstall()
    out = {
        "device": _device_name(device),
        "requests": args.requests,
        "finished": len(sched.finished),
        "serve_s": round(serve_s, 4),
        "drained": acct is not None,
    }
    if acct is not None:
        out["drain"] = acct
    if recs:
        recs[0].event("run_stop", step=sched.ticks,
                      exit_code=EXIT_RESUMABLE if acct else 0)
        recs[0].close()
    print(json.dumps(out))
    return EXIT_RESUMABLE if acct is not None else 1


if __name__ == "__main__":
    sys.exit(main())
