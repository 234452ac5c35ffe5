"""Merge per-rank flight-recorder logs into one Chrome trace + summary.

The PyTorch counterpart of ``singa_tpu/tools/trace.py``: the same code,
records, flags and JSON keys, so one tool reads the logs of either
package. The flight recorder (singa_tpu_torch/obs/) leaves one JSONL
event log per process in ``<workspace>/events/``. This tool is the post-mortem view of a
multi-host incident:

  merge (default)   fold every ``rank_k.jsonl`` into ONE Perfetto-
      loadable ``trace.json``: span records become 'X' duration events
      (pid = rank, tid = track: phases / feeder / stager / ckpt_writer),
      lifecycle events become instant events on each rank's 'events'
      thread. Ranks share no monotonic epoch, so the merge aligns on
      wall clock (each record carries both).

  --summarize       one JSON report instead: step-time p50/p99 (from
      train spans, normalized per step), input/ckpt/comm stall shares,
      guard/fault/restart counts, checkpoint commit outcomes, and
      per-rank skew (max wall-clock spread of the same display step /
      drain barrier across ranks). The ``comm`` share comes from the
      grad_comm calibration probe (a one-shot chained-reduce span the
      trainer records at run start when quantized/overlapped gradient
      collectives are active): per-reduction ms over the train span's
      per-step p50 — the modeled fraction of the step the gradient-
      collective machinery accounts for, not an on-step-path
      measurement (the collective runs inside the step).

Usage::

  python -m singa_tpu_torch.tools.trace <workspace-or-events-dir> [-o trace.json]
  python -m singa_tpu_torch.tools.trace <workspace-or-events-dir> --summarize
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def _events_dir(path: str) -> str:
    """Accept the workspace, its events subdir, or any dir holding
    rank_*.jsonl files."""
    for cand in (os.path.join(path, "events"), path):
        if glob.glob(os.path.join(cand, "rank_*.jsonl")):
            return cand
    raise FileNotFoundError(
        f"no rank_*.jsonl event logs under {path!r} (or {path!r}/events)"
    )


def load_events(path: str) -> tuple[list[dict], int]:
    """-> (records sorted by wall time, unparseable-line count). A torn
    tail line (the process died mid-append) is skipped, not fatal —
    that is exactly the situation a post-mortem runs in."""
    records: list[dict] = []
    skipped = 0
    for fn in sorted(glob.glob(os.path.join(_events_dir(path), "rank_*.jsonl"))):
        with open(fn, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    skipped += 1
                    continue
                if isinstance(rec, dict) and "ts" in rec:
                    records.append(rec)
                else:
                    skipped += 1
    records.sort(key=lambda r: r["ts"])
    return records, skipped


# ---------------------------------------------------------------------------
# merge -> Chrome trace
# ---------------------------------------------------------------------------

#: stable tid assignment per track so the Perfetto lanes sort usefully
_TRACK_TIDS = {
    "phases": 1,
    "feeder": 2,
    "stager": 3,
    "ckpt_writer": 4,
    "serving": 5,
    "requests": 6,
    "events": 9,
}


def to_chrome_trace(records: list[dict]) -> dict:
    """-> the Chrome-trace JSON object ({"traceEvents": [...]})."""
    if not records:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(r["ts"] for r in records)
    events: list[dict] = []
    seen_threads: set[tuple[int, int]] = set()
    ranks: set[int] = set()

    def tid_for(track: str) -> int:
        return _TRACK_TIDS.get(track, 8)

    for r in records:
        rank = int(r.get("rank", 0))
        ranks.add(rank)
        ts_us = (r["ts"] - t0) * 1e6
        if r.get("kind") == "span":
            track = r.get("track", "phases")
            tid = tid_for(track)
            args = {"step": r.get("step")}
            if "steps" in r:
                args["steps"] = r["steps"]
            events.append({
                "name": r.get("name", "span"),
                "cat": track,
                "ph": "X",
                "ts": ts_us,
                "dur": max(0.0, float(r.get("dur", 0.0))) * 1e6,
                "pid": rank,
                "tid": tid,
                "args": args,
            })
        else:
            track, tid = "events", _TRACK_TIDS["events"]
            args = {"step": r.get("step")}
            args.update(r.get("data", {}))
            events.append({
                "name": r.get("kind", "event"),
                "cat": "lifecycle",
                "ph": "i",
                "s": "t",  # thread-scoped instant marker
                "ts": ts_us,
                "pid": rank,
                "tid": tid,
                "args": args,
            })
        seen_threads.add((rank, tid))

    meta: list[dict] = []
    for rank in sorted(ranks):
        meta.append({
            "name": "process_name", "ph": "M", "pid": rank, "tid": 0,
            "args": {"name": f"rank {rank}"},
        })
    names = {tid: track for track, tid in _TRACK_TIDS.items()}
    for rank, tid in sorted(seen_threads):
        meta.append({
            "name": "thread_name", "ph": "M", "pid": rank, "tid": tid,
            "args": {"name": names.get(tid, "other")},
        })
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {"wall_epoch_s": t0},
    }


# ---------------------------------------------------------------------------
# summarize
# ---------------------------------------------------------------------------


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def summarize(records: list[dict]) -> dict:
    """The incident report: rates, stall shares, lifecycle counts,
    per-rank skew."""
    spans = [r for r in records if r.get("kind") == "span"]
    life = [r for r in records if r.get("kind") != "span"]

    # step-time percentiles: each train span covers `steps` steps; its
    # per-step time repeats with that weight so chunked windows don't
    # undercount relative to per-step dispatch
    per_step_ms: list[float] = []
    comm_ms: list[float] = []
    # serving tier: per-request latency spans + decode-tick spans
    # (serve/scheduler.py records both), summarized like step times
    request_ms: list[float] = []
    tick_s = 0.0
    tick_tokens = 0
    ticks = 0
    phase_totals: dict[str, float] = {}
    for s in spans:
        if s.get("track") == "requests":
            request_ms.append(float(s.get("dur", 0.0)) * 1e3)
        elif s.get("track") == "serving":
            tick_s += float(s.get("dur", 0.0))
            tick_tokens += int(s.get("steps", 0))
            ticks += 1
        if s.get("track") != "phases":
            phase_totals[s.get("track", "?")] = (
                phase_totals.get(s.get("track", "?"), 0.0) + s.get("dur", 0.0)
            )
            continue
        name = s.get("name", "?")
        dur = float(s.get("dur", 0.0))
        phase_totals[name] = phase_totals.get(name, 0.0) + dur
        if name == "train":
            n = max(1, int(s.get("steps", 1)))
            per_step_ms.extend([dur / n * 1e3] * min(n, 4096))
        elif name == "comm":
            # calibration probe: dur covers `steps` chained reductions
            n = max(1, int(s.get("steps", 1)))
            comm_ms.append(dur / n * 1e3)
    per_step_ms.sort()
    comm_ms.sort()
    request_ms.sort()

    train_t = phase_totals.get("train", 0.0)
    data_t = phase_totals.get("data", 0.0)
    ckpt_t = phase_totals.get("ckpt", 0.0)
    step_path = train_t + data_t + ckpt_t

    counts: dict[str, int] = {}
    for r in life:
        counts[r.get("kind", "?")] = counts.get(r.get("kind", "?"), 0) + 1

    by_rank: dict[int, int] = {}
    for r in records:
        by_rank[int(r.get("rank", 0))] = (
            by_rank.get(int(r.get("rank", 0)), 0) + 1
        )

    # per-rank skew: the same display step / drain barrier seen on
    # multiple ranks should land at (nearly) the same wall instant —
    # the max spread is the cross-rank lag a post-mortem cares about
    skew = 0.0
    for kind in ("step", "drain_barrier"):
        marks: dict[int, dict[int, float]] = {}
        for r in life:
            if r.get("kind") != kind or r.get("step") is None:
                continue
            marks.setdefault(int(r["step"]), {})[int(r.get("rank", 0))] = (
                r["ts"]
            )
        for ts_by_rank in marks.values():
            if len(ts_by_rank) > 1:
                skew = max(
                    skew, max(ts_by_rank.values()) - min(ts_by_rank.values())
                )

    # speculative decode: per-tick spec_draft/spec_accept events carry
    # drafted/accepted token counts (serve/scheduler.py)
    spec_drafted = sum(
        int(r["data"].get("drafted", 0))
        for r in life
        if r.get("kind") == "spec_draft" and isinstance(r.get("data"), dict)
    )
    spec_accepted = sum(
        int(r["data"].get("accepted", 0))
        for r in life
        if r.get("kind") == "spec_accept" and isinstance(r.get("data"), dict)
    )

    # kernel selection: the run-start kernel_select event says which
    # attend implementation the serving engine ran (reference | fused)
    # — incident reports must say which path a run took
    attend_impl = next(
        (
            r["data"].get("impl")
            for r in reversed(life)
            if r.get("kind") == "kernel_select"
            and isinstance(r.get("data"), dict)
            and r["data"].get("site") == "serve.paged_attention"
        ),
        None,
    )

    # training tier twin: the trainer's train.grad_allreduce
    # kernel_select event says which wire implementation the data-axis
    # gradient collective ran (reference | quantized_ring) and the
    # modeled per-device bytes it moves per step — reported next to
    # comm_ms_per_step so a post-mortem sees both the machinery's time
    # cost and its wire cost (None = no grad_comm machinery / old log)
    grad_select = next(
        (
            r["data"]
            for r in reversed(life)
            if r.get("kind") == "kernel_select"
            and isinstance(r.get("data"), dict)
            and r["data"].get("site") == "train.grad_allreduce"
        ),
        None,
    )

    # prefix cache: per-admission prefix_hit events carry shared-block
    # and saved-prefill-chunk counts (serve/scheduler.py _admit_some)
    prefix_hit_events = [
        r["data"]
        for r in life
        if r.get("kind") == "prefix_hit" and isinstance(r.get("data"), dict)
    ]
    blocks_shared = sum(
        int(d.get("blocks_shared", 0)) for d in prefix_hit_events
    )
    prefill_chunks_saved = sum(
        int(d.get("chunks_saved", 0)) for d in prefix_hit_events
    )

    # fleet prefix cache: cache_fetch -> cache_ship round trips
    # (counted on the receiver, dir="in", where the bytes landed —
    # dir="out" double-counts the same frame on the sender), partial-
    # tail hits, decode-written block registrations
    ships_in = [
        r["data"]
        for r in life
        if r.get("kind") == "cache_ship"
        and isinstance(r.get("data"), dict)
        and r["data"].get("dir") == "in"
    ]
    partial_hit_events = [
        r["data"]
        for r in life
        if r.get("kind") == "partial_hit" and isinstance(r.get("data"), dict)
    ]

    # fleet: per-host roles from the run-start fleet_role events, and
    # block-migration volume from migrate_in (counted on the importer,
    # where the blocks actually landed; migrate_out double-counts a
    # drain-to-peer re-migration)
    fleet_roles: dict[int, str] = {}
    for r in life:
        if r.get("kind") == "fleet_role" and isinstance(r.get("data"), dict):
            fleet_roles[int(r.get("rank", 0))] = r["data"].get("role")
    migrate_in_events = [
        r for r in life
        if r.get("kind") == "migrate_in" and isinstance(r.get("data"), dict)
    ]
    migrated_blocks = sum(
        int(r["data"].get("blocks", 0)) for r in migrate_in_events
    )
    hosts: dict[str, dict] = {}
    if fleet_roles:
        per_rank: dict[int, dict[str, int]] = {}
        per_rank_cache: dict[int, dict[str, int]] = {}
        for r in life:
            rank = int(r.get("rank", 0))
            if rank not in fleet_roles:
                continue
            per_rank.setdefault(rank, {})
            k = r.get("kind", "?")
            per_rank[rank][k] = per_rank[rank].get(k, 0) + 1
            d = r.get("data") if isinstance(r.get("data"), dict) else None
            if d is None:
                continue
            acc = per_rank_cache.setdefault(rank, {})
            if k == "prefix_hit":
                acc["chunks_saved"] = (
                    acc.get("chunks_saved", 0)
                    + int(d.get("chunks_saved", 0))
                )
            elif k == "cache_ship":
                way = "in" if d.get("dir") == "in" else "out"
                acc[f"ships_{way}"] = acc.get(f"ships_{way}", 0) + 1
                acc[f"ship_bytes_{way}"] = (
                    acc.get(f"ship_bytes_{way}", 0) + int(d.get("bytes", 0))
                )
                acc[f"ship_blocks_{way}"] = (
                    acc.get(f"ship_blocks_{way}", 0)
                    + int(d.get("blocks", 0))
                )
        for rank in sorted(fleet_roles):
            c = per_rank.get(rank, {})
            cc = per_rank_cache.get(rank, {})
            admitted = c.get("request_admit", 0)
            hosts[str(rank)] = {
                "role": fleet_roles[rank],
                "admitted": admitted,
                "prefill_chunks": c.get("prefill", 0),
                "migrate_in": c.get("migrate_in", 0),
                "migrate_out": c.get("migrate_out", 0),
                "retired": c.get("retire", 0),
                "evicted": c.get("evict", 0),
                "drains": c.get("drain", 0),
                # fleet prefix cache, this host's view: hit rate over
                # its admissions, chunks its hits skipped, fetch/ship
                # traffic in both directions
                "prefix_hits": c.get("prefix_hit", 0),
                "prefix_hit_rate": (
                    round(c.get("prefix_hit", 0) / admitted, 4)
                    if admitted else None
                ),
                "partial_hits": c.get("partial_hit", 0),
                "chunks_saved": cc.get("chunks_saved", 0),
                "cache_fetches": c.get("cache_fetch", 0),
                "cache_fetch_timeouts": c.get("cache_fetch_timeout", 0),
                "cache_ships_in": cc.get("ships_in", 0),
                "cache_ships_out": cc.get("ships_out", 0),
                "ship_bytes_in": cc.get("ship_bytes_in", 0),
                "ship_bytes_out": cc.get("ship_bytes_out", 0),
            }

    # wire transport (comm/wire.py): connect/retry/timeout/redeliver
    # lifecycle counts plus per-peer send-latency percentiles from
    # wire_send events — enough to reconstruct connect -> retry ->
    # redeliver -> resume from a merged multi-host trace
    wire_counts = {
        k: counts.get(f"wire_{k}", 0)
        for k in (
            "connect", "send", "retry", "timeout", "redeliver",
            "crc_reject", "partition_heal",
        )
    }
    wire_peer_ms: dict[str, list[float]] = {}
    for r in life:
        if r.get("kind") != "wire_send" or not isinstance(
            r.get("data"), dict
        ):
            continue
        peer = str(r["data"].get("peer", "?"))
        wire_peer_ms.setdefault(peer, []).append(
            float(r["data"].get("ms", 0.0))
        )
    wire_peers = {}
    for peer in sorted(wire_peer_ms):
        ms = sorted(wire_peer_ms[peer])
        wire_peers[peer] = {
            "sends": len(ms),
            "send_ms": {
                "p50": round(_percentile(ms, 0.50), 3),
                "p99": round(_percentile(ms, 0.99), 3),
            },
        }

    # live weight rollout (serve/rollout.py): per-host flip history
    # keyed by rank from the cross-rank merge, weight-ship volume,
    # canary parity verdict, aborts/rollbacks, final verdict
    flip_events = [
        r for r in life
        if r.get("kind") == "rollout_flip"
        and isinstance(r.get("data"), dict)
    ]
    weight_ships = [
        r["data"] for r in life
        if r.get("kind") == "weight_ship"
        and isinstance(r.get("data"), dict)
    ]
    rollout_aborts = [
        r["data"] for r in life
        if r.get("kind") == "rollout_abort"
        and isinstance(r.get("data"), dict)
    ]
    rollout_canary = [
        r["data"] for r in life
        if r.get("kind") == "rollout_canary"
        and isinstance(r.get("data"), dict)
    ]
    rollout_done = [
        r["data"] for r in life
        if r.get("kind") == "rollout_done"
        and isinstance(r.get("data"), dict)
    ]
    rollout_hosts: dict[str, dict] = {}
    for r in flip_events:
        d = r["data"]
        e = rollout_hosts.setdefault(str(int(r.get("rank", 0))), {
            "version": 0, "flip_tick": None, "flips": 0,
            "rollbacks": 0,
        })
        e["flips"] += 1
        e["version"] = int(d.get("version", 0))
        e["flip_tick"] = d.get("tick")
        if d.get("rollback"):
            e["rollbacks"] += 1

    faults = [
        r["data"].get("fault")
        for r in life
        if r.get("kind") == "fault" and isinstance(r.get("data"), dict)
    ]
    guard_rollbacks = counts.get("guard_rollback", 0)
    last_steps = [
        r for r in life if r.get("kind") == "step"
    ]
    steps_per_s = [
        r["data"]["steps_per_s"]
        for r in last_steps
        if isinstance(r.get("data"), dict) and "steps_per_s" in r["data"]
    ]

    return {
        "records": len(records),
        "ranks": {str(k): v for k, v in sorted(by_rank.items())},
        "step_time_ms": {
            "p50": round(_percentile(per_step_ms, 0.50), 3),
            "p99": round(_percentile(per_step_ms, 0.99), 3),
            "n": len(per_step_ms),
        },
        "steps_per_s": {
            "mean": round(sum(steps_per_s) / len(steps_per_s), 3)
            if steps_per_s
            else None,
            "windows": len(steps_per_s),
        },
        "stall_shares": {
            "input": round(data_t / step_path, 4) if step_path > 0 else 0.0,
            "ckpt": round(ckpt_t / step_path, 4) if step_path > 0 else 0.0,
            # the gradient-collective machinery's modeled share of the
            # step (probe p50 / train per-step p50; see docstring)
            "comm": round(
                _percentile(comm_ms, 0.50)
                / _percentile(per_step_ms, 0.50),
                4,
            )
            if comm_ms and per_step_ms and _percentile(per_step_ms, 0.50)
            else 0.0,
        },
        "comm_ms_per_step": round(_percentile(comm_ms, 0.50), 4)
        if comm_ms
        else None,
        # which wire implementation reduced gradients (the
        # train.grad_allreduce kernel_select run-start event) and its
        # modeled per-device data-axis bytes per step
        "grad_wire_impl": grad_select.get("impl") if grad_select else None,
        "wire_bytes_per_step": (
            grad_select.get("wire_bytes_per_step") if grad_select else None
        ),
        "counts": {
            "faults": len(faults),
            "guard_rollbacks": guard_rollbacks,
            "restarts": counts.get("restart", 0),
            "crashes": counts.get("crash", 0),
            "drains": counts.get("drain", 0),
            "peer_deaths": counts.get("peer_death", 0),
            "watchdog_stalls": counts.get("watchdog_stall", 0),
            "checkpoints_written": counts.get("ckpt_written", 0),
            "latest_promotions": counts.get("ckpt_latest", 0),
            "torn_commits": sum(
                1
                for r in life
                if r.get("kind") == "ckpt_commit"
                and isinstance(r.get("data"), dict)
                and not r["data"].get("ok", True)
            ),
        },
        "fired_faults": faults,
        "max_rank_skew_s": round(skew, 4),
        # serving tier (None unless serving spans/events are present):
        # request-latency percentiles from per-request spans, decode
        # throughput from tick spans, lifecycle counts from events
        "serving": {
            # which attend implementation served this run (the
            # kernel_select run-start event; None = pre-kernels log)
            "attend_impl": attend_impl,
            "request_latency_ms": {
                "p50": round(_percentile(request_ms, 0.50), 2),
                "p99": round(_percentile(request_ms, 0.99), 2),
                "n": len(request_ms),
            },
            "decode_ticks": ticks,
            "tokens": tick_tokens + len(request_ms),
            "tokens_per_s": round(tick_tokens / tick_s, 1)
            if tick_s > 0
            else 0.0,
            # speculative decode's amortization factor: emitted tokens
            # per verify/decode tick (1.0 * live slots without
            # speculation; higher = accepted drafts riding one weight
            # stream) and the drafter's acceptance rate (None = no
            # speculation events in this log)
            "tokens_per_tick": round(tick_tokens / ticks, 2)
            if ticks
            else None,
            "acceptance_rate": round(spec_accepted / spec_drafted, 4)
            if spec_drafted
            else None,
            "spec_drafted": spec_drafted,
            "spec_accepted": spec_accepted,
            # prefix cache: hit rate over admissions, shared blocks,
            # and prefill chunks the hits skipped (None = no prefix
            # lifecycle events in this log — cache off or no hits)
            "prefix_hit_rate": round(
                len(prefix_hit_events)
                / max(1, counts.get("request_admit", 0)),
                4,
            )
            if prefix_hit_events
            else None,
            "blocks_shared": blocks_shared,
            "prefill_chunks_saved": prefill_chunks_saved,
            "cow_copies": counts.get("cow_copy", 0),
            "lru_evictions": counts.get("lru_evict", 0),
            "lru_reclaims": sum(
                int(r["data"].get("blocks", 1))
                for r in life
                if r.get("kind") == "lru_reclaim"
                and isinstance(r.get("data"), dict)
            ),
            "admitted": counts.get("request_admit", 0),
            "retired": counts.get("retire", 0),
            "evicted": counts.get("evict", 0),
            "backpressure": counts.get("backpressure", 0),
            # fleet (zero / empty without fleet events in the log):
            # cross-host sequence migrations, the block volume they
            # moved, front-door placements, and per-role host rows
            # keyed by rank from the cross-rank merge
            "migrations": len(migrate_in_events),
            "migrated_blocks": migrated_blocks,
            "routed": counts.get("route", 0),
            # fleet prefix cache (None = no fetch/ship/partial events
            # in this log): cross-host warm-KV traffic counted on the
            # receiving side, partial-tail sharing, decode-written
            # block registrations
            "fleet_cache": {
                "fetches": counts.get("cache_fetch", 0),
                "fetch_timeouts": counts.get("cache_fetch_timeout", 0),
                "ships": len(ships_in),
                "blocks_shipped": sum(
                    int(d.get("blocks", 0)) for d in ships_in
                ),
                "ship_bytes": sum(
                    int(d.get("bytes", 0)) for d in ships_in
                ),
                "partial_hits": len(partial_hit_events),
                "tail_tokens_shared": sum(
                    int(d.get("tail_tokens", 0))
                    for d in partial_hit_events
                ),
                "decode_registers": counts.get("decode_register", 0),
            }
            if (
                counts.get("cache_fetch") or ships_in
                or partial_hit_events or counts.get("decode_register")
            )
            else None,
            "hosts": hosts or None,
        }
        if (
            request_ms or ticks or counts.get("request_admit")
            or fleet_roles or counts.get("route")
        )
        else None,
        # live weight rollout (None unless rollout/weight_ship events
        # are present): ship volume counted on the receiver, torn-frame
        # rejections, per-rank flip history, canary parity verdict,
        # aborts with their documented reasons, and the controller's
        # final verdict (promoted / rollback / quarantined / paused)
        "rollout": {
            "ships_in": sum(
                1 for s in weight_ships
                if s.get("dir") == "in" and s.get("ok")
            ),
            "ship_bytes_in": sum(
                int(s.get("bytes", 0)) for s in weight_ships
                if s.get("dir") == "in" and s.get("ok")
            ),
            "torn_ships": sum(
                1 for s in weight_ships
                if s.get("dir") == "in" and not s.get("ok", True)
            ),
            "stages": counts.get("rollout_stage", 0),
            "flips": sum(
                1 for r in flip_events
                if not r["data"].get("rollback")
            ),
            "rollbacks": sum(
                1 for r in flip_events if r["data"].get("rollback")
            ),
            "canary": {
                "parity": bool(rollout_canary[-1].get("parity")),
                "probes": int(rollout_canary[-1].get("probes", 0)),
            }
            if rollout_canary
            else None,
            "aborts": [
                {
                    "reason": a.get("reason"),
                    "version": a.get("version"),
                }
                for a in rollout_aborts
            ],
            "verdict": rollout_done[-1].get("verdict")
            if rollout_done
            else None,
            "version": rollout_done[-1].get("version")
            if rollout_done
            else None,
            "hosts": rollout_hosts or None,
        }
        if (
            flip_events or weight_ships or rollout_done
            or rollout_aborts or counts.get("rollout_stage")
        )
        else None,
        # wire transport (None unless wire_* events are present — the
        # mailbox/in-process wirings emit none): retry/redelivery
        # verdict counts + per-peer send-latency percentiles
        "wire": {
            **wire_counts,
            "peer_deaths": counts.get("peer_death", 0),
            "peers": wire_peers or None,
        }
        if any(wire_counts.values())
        else None,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="trace", description=__doc__)
    ap.add_argument(
        "path", help="workspace (or its events/ dir) holding rank_*.jsonl"
    )
    ap.add_argument(
        "-o", "--output", default=None,
        help="merged Chrome-trace output (default: <path>/trace.json)",
    )
    ap.add_argument(
        "--summarize", action="store_true",
        help="print the incident summary JSON instead of merging",
    )
    args = ap.parse_args(argv)

    try:
        records, skipped = load_events(args.path)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 2
    if skipped:
        print(
            f"trace: skipped {skipped} unparseable line(s) "
            "(torn tail from a dead process?)",
            file=sys.stderr,
        )
    if args.summarize:
        print(json.dumps(summarize(records), indent=2))
        return 0
    trace = to_chrome_trace(records)
    out = args.output or os.path.join(args.path, "trace.json")
    tmp = out + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    os.replace(tmp, out)
    print(
        json.dumps({
            "trace": out,
            "events": len(trace["traceEvents"]),
            "records": len(records),
            "skipped": skipped,
        })
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
