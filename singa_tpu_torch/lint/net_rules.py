"""netlint pass family 1: config + graph + sharding rules.

Counterpart of ``singa_tpu/lint/net_rules.py`` over the port's own
``config``, ``graph``, ``ops`` and ``resilience`` modules. These run on the *parsed text*, never executing a layer: a raw-tree walk
(every-error-at-once schema checking with did-you-mean), then graph rules
over the typed ``ModelConfig`` (the static half of what
NeuralNet::ConstructNeuralNet would crash on at runtime, reference
src/worker/neuralnet.cc:72-110), then cluster-topology and sharding
divisibility checks (the statically-decidable slice of the layout
parallel/shardings.py picks).

One rule describes the port's code rather than the JAX package's:
KRN001 asks the CUDA paged-attention kernel's ``fusable`` (head_dim 64
or 128, any ``kv_block_len >= 1``) and fires whatever ``kernels {
interpret }`` says, because the port's Engine rejects an untileable
fused geometry on ``cuda`` whatever that field says.

Sharding rules need a cluster conf to know the mesh axis widths; model-only
runs skip them. Shape inference (which needs the data sources) lives in
``shape_rules``.
"""

from __future__ import annotations

import difflib
import re
from typing import Any

from ..config import schema, textproto
from ..config.schema import (
    ClusterConfig,
    ConfigError,
    Message,
    ModelConfig,
)
from ..graph.builder import active_phases
from ..graph.kahn import kahn_order
from .core import Collector, ERROR, Fix, INFO, WARNING, rule

# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

CFG000 = rule("CFG000", ERROR, "config does not parse (syntax or schema)")
CFG001 = rule("CFG001", ERROR, "unknown field name (with did-you-mean)")
CFG002 = rule("CFG002", ERROR, "unknown enum value (with did-you-mean)")
CFG003 = rule(
    "CFG003",
    INFO,
    "reference [sic] spelling kGaussain; corrected kGaussian is accepted",
)
NET001 = rule("NET001", ERROR, "srclayers edge references an unknown layer")
NET002 = rule("NET002", ERROR, "cycle in the layer graph")
NET003 = rule(
    "NET003", ERROR, "live layer depends on a layer excluded from its phase"
)
NET004 = rule("NET004", ERROR, "duplicate layer names live in one phase")
CLU001 = rule(
    "CLU001", ERROR, "nprocs_per_group not divisible by nseq*nexperts*npipes"
)
CLU002 = rule("CLU002", ERROR, "nworkers < nprocs_per_group: zero groups")
SHD001 = rule(
    "SHD001",
    WARNING,
    "kLayerPartition neuron dim not divisible by the model axis "
    "(storage is padded / experts replicate instead of sharding)",
)
SHD003 = rule(
    "SHD003", WARNING, "batchsize not divisible by the data axis width"
)
CMM001 = rule(
    "CMM001",
    ERROR,
    "active grad_comm block combined with the replica (async PS) engine",
)
SRV001 = rule(
    "SRV001",
    ERROR,
    "prefix_cache enabled but kv_blocks cannot hold one max-length "
    "prompt, or tail_stride does not tile kv_block_len",
)
FLT001 = rule(
    "FLT001",
    ERROR,
    "fleet topology cannot serve: a prefill-capable host whose "
    "kv_blocks cannot cover one max-length prompt, or a split-role "
    "fleet missing the other half (decode with no prefill-capable "
    "peer, prefill with no decode-capable peer)",
)
KRN001 = rule(
    "KRN001",
    ERROR,
    "fused paged_attention selected with a geometry the CUDA "
    "kernel is not built for",
)
KRN002 = rule(
    "KRN002",
    ERROR,
    "ring grad_allreduce (quantized_ring/q8_hier) without a quantized "
    "grad_comm block, with an un-chunkable data-axis geometry, with a "
    ">1-wide non-data mesh axis the factorization does not cover, "
    "with a broken ring {} two-level geometry (absent axis, "
    "indivisible intra_degree), with a batch-stat (kBatchNorm) net, "
    "or with the replica engine",
)
ELA001 = rule(
    "ELA001",
    ERROR,
    "resume checkpoint's sharded manifest cannot be hosted by the "
    "--cluster mesh (a spec names an axis the mesh lacks, or a dim "
    "has fewer elements than the target axis width — beyond even the "
    "pad/replicate fallback)",
)
WIR001 = rule(
    "WIR001",
    ERROR,
    "socket transport misconfigured: missing/duplicate peer or "
    "frontdoor addresses, non-positive wire timeouts/backoff, or a "
    "send deadline that cannot cover one max-size migration message "
    "(or, with the prefix cache on, one max-prefix cache_ship frame)",
)
ROL001 = rule(
    "ROL001",
    ERROR,
    "live weight rollout infeasible: no checkpoint to ship, a canary "
    "that is not a declared decode-capable host (or names the whole "
    "single-host fleet), degenerate probe/retry knobs, or "
    "dual-resident staged params that overflow the --cluster "
    "device_hbm_bytes budget (cost model)",
)

#: reverse of schema.ENUM_ALIASES: [sic] token -> corrected spelling
_TYPO_NOTES = {v: k for k, v in schema.ENUM_ALIASES.items()}


# ---------------------------------------------------------------------------
# loose schema walk: report every unknown field / enum value, don't fail-fast
# ---------------------------------------------------------------------------


def _line_of(text: str | None, needle: str) -> str:
    """Fallback line locator for callers without a parse span: first
    line containing ``needle`` as a whole token — a bare substring
    scan would attribute 'kGaussain' to a line holding
    'kGaussainSqrtFanIn'. Falls back to substring if no token match.
    The parse tree's own spans (textproto.parse_with_locs) are the
    primary source; this text search only covers needles that never
    were tokens (e.g. messages quoting a converted value)."""
    if not text:
        return ""
    token = re.compile(
        rf"(?<![A-Za-z0-9_]){re.escape(needle)}(?![A-Za-z0-9_])"
    )
    fallback = ""
    for i, line in enumerate(text.splitlines(), 1):
        if token.search(line):
            return str(i)
        if not fallback and needle in line:
            fallback = str(i)
    return fallback


def _loc(
    path: str,
    text: str | None,
    needle: str,
    ctx: str,
    span: tuple[int, int] | None = None,
) -> str:
    """Diagnostic location: ``path:LINE:COL`` from an exact parse span
    when the caller has one (a lookup, not a search), else the
    best-effort ``path:LINE`` text scan."""
    if span is not None:
        base = f"{path}:{span[0]}:{span[1]}"
    else:
        line = _line_of(text, needle)
        base = f"{path}:{line}" if line else path
    return f"{base} ({ctx})" if ctx else base


def walk_raw_config(
    raw: dict[str, list[Any]],
    cls: type[Message],
    path: str,
    col: Collector,
    *,
    text: str | None = None,
    ctx: str = "",
    locs: dict[str, list[textproto.FieldLoc]] | None = None,
    _seen_typos: set[tuple[str, str]] | None = None,
) -> None:
    """Check a textproto parse tree against ``cls``'s field schema,
    emitting CFG001/CFG002/CFG003 for everything wrong (the strict
    ``Message.from_fields`` stops at the first error; lint wants all).
    CFG003 is advisory, so it fires once per (field, spelling) per file
    rather than once per occurrence. ``locs`` is the parallel span tree
    from ``textproto.parse_with_locs`` — when present, diagnostics carry
    exact ``path:LINE:COL`` locations and unambiguous did-you-mean
    suggestions carry a machine-applicable Fix (``--fix``)."""
    if _seen_typos is None:
        _seen_typos = set()
    for fname, occurrences in raw.items():
        flocs = (locs or {}).get(fname, [])

        def span_of(i: int, *, value: bool = False):
            if i < len(flocs):
                fl = flocs[i]
                return fl.value if value else fl.key
            return None

        spec = cls.FIELDS.get(fname)
        if spec is None:
            close = difflib.get_close_matches(fname, cls.FIELDS, n=2)
            hint = f"did you mean {close[0]!r}?" if close else ""
            span = span_of(0)
            fix = None
            if len(close) == 1 and span is not None:
                fix = Fix(path, span[0], span[1], fname, close[0])
            col.emit(
                CFG001,
                _loc(path, text, fname, ctx, span),
                f"unknown field {fname!r} in {cls.__name__}",
                fix_hint=hint,
                fix=fix,
            )
            continue
        if spec.kind == "message":
            pairs = [
                (occ, span_of(i))
                for i, occ in enumerate(occurrences)
            ]
            dicts = [(o, s) for o, s in pairs if isinstance(o, dict)]
            sublocs = [
                flocs[i].sub if i < len(flocs) else None
                for i, occ in enumerate(occurrences)
                if isinstance(occ, dict)
            ]
            if len(dicts) < len(occurrences):
                bad = next(s for o, s in pairs if not isinstance(o, dict))
                col.emit(
                    CFG000,
                    _loc(path, text, fname, ctx, bad),
                    f"field {fname!r} expects a message block",
                )
            if not spec.repeated and len(dicts) > 1:
                # protobuf text-format merge (schema.from_fields): walk
                # the merged tree once, so a required subfield present in
                # any occurrence is not misreported as missing — the loc
                # trees merge the same way, keeping spans aligned
                merged: dict[str, list[Any]] = {}
                merged_locs: dict[str, list] = {}
                for (occ, _), sl in zip(dicts, sublocs):
                    for sub, subvals in occ.items():
                        merged.setdefault(sub, []).extend(subvals)
                        merged_locs.setdefault(sub, []).extend(
                            (sl or {}).get(
                                sub,
                                [textproto.FieldLoc(None)] * len(subvals),
                            )
                        )
                dicts = [(merged, None)]
                sublocs = [merged_locs]
            for (occ, _), sl in zip(dicts, sublocs):
                sub_ctx = fname
                names = occ.get("name")
                if names and isinstance(names[-1], str):
                    sub_ctx = f"{fname} {names[-1]!r}"
                if ctx:
                    sub_ctx = f"{ctx}.{sub_ctx}"
                walk_raw_config(
                    occ,
                    spec.message,
                    path,
                    col,
                    text=text,
                    ctx=sub_ctx,
                    locs=sl,
                    _seen_typos=_seen_typos,
                )
        elif spec.kind == "enum":
            for i, occ in enumerate(occurrences):
                if not isinstance(occ, str):
                    continue
                if occ in spec.enum and occ not in _TYPO_NOTES:
                    continue  # exact member, nothing to say
                vspan = span_of(i, value=True)
                if occ in _TYPO_NOTES and occ in spec.enum:
                    # a [sic] token used where it is actually valid: note
                    # the corrected spelling. Used in the WRONG field it
                    # falls through to the CFG002 membership check below.
                    if (fname, occ) not in _seen_typos:
                        _seen_typos.add((fname, occ))
                        col.emit(
                            CFG003,
                            _loc(path, text, occ, "", vspan),
                            f"{fname}: {occ!r} is the reference's [sic] "
                            f"spelling; the corrected {_TYPO_NOTES[occ]!r} "
                            "is accepted as an alias",
                        )
                    continue
                canonical = schema.ENUM_ALIASES.get(occ, occ)
                if canonical not in spec.enum:
                    vocab = list(spec.enum) + [
                        a
                        for a, t in schema.ENUM_ALIASES.items()
                        if t in spec.enum
                    ]
                    close = difflib.get_close_matches(occ, vocab, n=2)
                    hint = f"did you mean {close[0]!r}?" if close else ""
                    fix = None
                    if len(close) == 1 and vspan is not None:
                        fix = Fix(path, vspan[0], vspan[1], occ, close[0])
                    col.emit(
                        CFG002,
                        _loc(path, text, occ, ctx, vspan),
                        f"{fname}: {occ!r} not in {spec.enum}",
                        fix_hint=hint,
                        fix=fix,
                    )
        else:
            # scalar kinds: report every coercion failure with the exact
            # text the strict parse would use (it stops at the first; the
            # caller dedups by message)
            for i, occ in enumerate(occurrences):
                try:
                    spec.convert(occ, fname)
                except ConfigError as e:
                    col.emit(
                        CFG000,
                        _loc(
                            path, text, str(occ), ctx,
                            span_of(i, value=True),
                        ),
                        str(e),
                    )
    for fname, spec in cls.FIELDS.items():
        if (
            spec.required
            and not spec.repeated
            and spec.default is None
            and fname not in raw
        ):
            col.emit(
                CFG000,
                f"{path} ({ctx})" if ctx else path,
                f"{cls.__name__}: missing required {fname!r}",
            )


# ---------------------------------------------------------------------------
# graph rules (typed ModelConfig)
# ---------------------------------------------------------------------------


def graph_rules(model_cfg: ModelConfig, path: str, col: Collector) -> None:
    """NET001-NET004 over every phase the job will actually build."""
    net_cfg = model_cfg.neuralnet
    if net_cfg is None:
        col.emit(CFG000, path, "model config has no neuralnet block")
        return
    layers = net_cfg.layer
    global_names = {l.name for l in layers}
    seen_dangling: set[tuple[str, str]] = set()
    seen_cycles: set[frozenset] = set()
    for phase in active_phases(model_cfg):
        live = [l for l in layers if phase not in (l.exclude or [])]
        names = [l.name for l in live]
        dupes = sorted({n for n in names if names.count(n) > 1})
        for name in dupes:
            col.emit(
                NET004,
                f"{path} (layer {name!r})",
                f"{len([n for n in names if n == name])} layers named "
                f"{name!r} are all live in phase {phase}",
                fix_hint="add exclude: so at most one survives each "
                "phase the job runs",
            )
        live_names = set(names)
        for l in live:
            for src in l.srclayers:
                if src not in global_names:
                    if (l.name, src) not in seen_dangling:
                        seen_dangling.add((l.name, src))
                        close = difflib.get_close_matches(
                            src, sorted(global_names), n=1
                        )
                        hint = (
                            f"did you mean {close[0]!r}?" if close else ""
                        )
                        col.emit(
                            NET001,
                            f"{path} (layer {l.name!r})",
                            f"srclayers references unknown layer {src!r}",
                            fix_hint=hint,
                        )
                elif src not in live_names:
                    col.emit(
                        NET003,
                        f"{path} (layer {l.name!r})",
                        f"depends on {src!r}, which is excluded from "
                        f"phase {phase} while {l.name!r} is live",
                        fix_hint=f"exclude {l.name!r} from {phase} too, "
                        f"or un-exclude {src!r}",
                    )
        if dupes:
            continue  # cycle check is ill-defined with duplicate names
        stuck = _cycle_members(live, live_names)
        if stuck and frozenset(stuck) not in seen_cycles:
            seen_cycles.add(frozenset(stuck))
            col.emit(
                NET002,
                path,
                f"cycle in the layer graph involving {sorted(stuck)} "
                f"(phase {phase})",
            )


def _cycle_members(live, live_names) -> set[str]:
    """Kahn's-algorithm residue = the layers on (or downstream of) a
    cycle; dangling edges are ignored (NET001 owns those). The core loop
    is shared with builder.topo_sort (graph/kahn.py) — this caller keeps
    only the report-all policy."""
    del live_names  # kahn_order ignores edges to unknown names itself
    _, residue = kahn_order(
        [l.name for l in live], {l.name: l.srclayers for l in live}
    )
    return residue


# ---------------------------------------------------------------------------
# cluster rules
# ---------------------------------------------------------------------------


def cluster_rules(
    cluster_cfg: ClusterConfig, path: str, col: Collector
) -> dict[str, int] | None:
    """CLU001/CLU002; returns the mesh axis widths when the topology is
    coherent (the sharding rules' input), else None. Both checks run —
    a conf broken in both ways gets both diagnostics in one pass."""
    ngroups_err = None
    try:
        cluster_cfg.ngroups
    except ConfigError as e:
        ngroups_err = str(e)
        col.emit(CLU002, path, ngroups_err)
    try:
        widths = cluster_cfg.axis_widths
    except ConfigError as e:
        # axis_widths re-raises the ngroups error when only that one
        # exists; don't report it under two codes
        if str(e) != ngroups_err:
            col.emit(CLU001, path, str(e))
        return None
    return None if ngroups_err else widths


# ---------------------------------------------------------------------------
# engine-compatibility rules (model conf x cluster conf)
# ---------------------------------------------------------------------------


def engine_rules(
    model_cfg: ModelConfig, cluster_cfg: ClusterConfig | None, path: str,
    col: Collector,
) -> None:
    """CMM001 — the static mirror of the trainer-constructor rejection
    (trainer/replica.py ``_supports_grad_comm``): an asynchronous
    cluster with ``nservers > 0`` routes a backprop job to the replica
    engine, whose EASGD/RandomSync protocol owns its own gradient-sync
    math — an active ``grad_comm`` block (quantized mode or bucketized
    overlap) would be rejected at engine construction, so lint says it
    before any card time is spent. Mirrors the ``zero_update``
    rejection; the CD engine rides the shared seam and is fine."""
    gc = getattr(model_cfg, "grad_comm", None)
    if gc is None or (gc.mode == "exact" and gc.buckets <= 1):
        return
    if (
        cluster_cfg is not None
        and cluster_cfg.nservers > 0
        and not cluster_cfg.synchronous
        and model_cfg.alg != "kContrastiveDivergence"
        and model_cfg.updater is not None
    ):
        col.emit(
            CMM001,
            path,
            f"grad_comm (mode {gc.mode!r}, buckets {gc.buckets}) with an "
            "asynchronous nservers>0 cluster: the replica engine's "
            "EASGD protocol owns its own gradient sync and rejects the "
            "quantize/overlap machinery",
            fix_hint="drop the grad_comm block, or run the synchronous "
            "engine (synchronous: true / nservers: 0)",
        )


# ---------------------------------------------------------------------------
# serving rules (model conf alone)
# ---------------------------------------------------------------------------


def serving_rules(model_cfg: ModelConfig, path: str, col: Collector) -> None:
    """SRV001 — static admission feasibility for a prefix-caching
    serving tier (the shardlint direction: predict the capacity cliff
    before any card time is spent). serve/kv_pool.KVPool.for_model
    raises at engine construction when ``kv_blocks`` cannot hold even
    ONE full-length sequence plus the trash block; with
    ``prefix_cache`` enabled that failure is doubly wasteful — the
    operator sized the pool for cache wins it can never admit. The
    model's positional window comes from the kEmbedding layer's
    declared ``max_len``; a window left to the data layer's sequence
    length (max_len 0) is not statically decidable and is skipped."""
    srv = getattr(model_cfg, "serving", None)
    if srv is None or srv.prefix_cache is None or not srv.prefix_cache.enabled:
        return
    # partial-tail stride must tile the block: sub-block digests are
    # registered at multiples of tail_stride inside one block, so a
    # stride that does not divide kv_block_len (or is negative) is
    # rejected by PrefixCache at engine construction — say it before
    # any card time is spent
    stride = getattr(srv.prefix_cache, "tail_stride", 0)
    block_len = max(1, srv.kv_block_len)
    if stride < 0 or (stride and block_len % stride):
        col.emit(
            SRV001,
            path,
            f"serving.prefix_cache.tail_stride {stride} does not tile "
            f"kv_block_len {block_len}: sub-block tail digests land at "
            "multiples of the stride inside one block, so the engine "
            "rejects this geometry at construction",
            fix_hint=f"pick a positive tail_stride dividing "
            f"{block_len} (or 0 to disable partial-tail sharing)",
        )
    if srv.kv_blocks <= 0:
        return  # dense-equivalent sizing always fits one sequence
    window = _declared_window(model_cfg)
    if not window:
        return
    block_len = max(1, srv.kv_block_len)
    need = -(-window // block_len) + 1  # one full sequence + trash block
    if srv.kv_blocks < need:
        col.emit(
            SRV001,
            path,
            f"serving.prefix_cache enabled with kv_blocks "
            f"{srv.kv_blocks} < {need} needed to admit one max-length "
            f"prompt ({window} positions / kv_block_len {block_len} + "
            "the reserved trash block): every admission would raise "
            "before the cache could ever hit",
            fix_hint=f"set kv_blocks >= {need} (or 0 for "
            "dense-equivalent sizing)",
        )


def _declared_window(model_cfg: ModelConfig) -> int:
    """The model's statically-declared positional window (the
    kEmbedding layer's ``max_len``); 0 = not statically decidable
    (window left to the data layer's sequence length)."""
    net_cfg = model_cfg.neuralnet
    if net_cfg is None:
        return 0
    return max(
        (
            l.embedding_param.max_len
            for l in net_cfg.layer
            if l.embedding_param is not None and l.embedding_param.max_len
        ),
        default=0,
    )


def fleet_rules(model_cfg: ModelConfig, path: str, col: Collector) -> None:
    """FLT001 — static mirrors of the fleet-host construction
    rejections (serve/fleet/host.py), SRV001's sibling. Two arms,
    reported independently:

    (a) a host that will run the PREFILL role (explicit ``role:
        prefill``, or ``auto`` — where ranks below ``prefill_hosts``
        always exist, or an explicit prefill ``peers`` entry) with a
        ``serving.kv_blocks`` that cannot cover even ONE max-length
        prompt plus the trash block: every admission would raise
        before a single chunk ran (KVPool.for_model's runtime raise,
        said before any card time is spent). Skipped when the window
        is not statically decidable, like SRV001.
    (b) a split-role topology missing the other half: every host of
        the lonely role raises at FleetHost construction (a decode
        host with no prefill-capable peer has KV blocks nothing can
        ever fill; a prefill host with no decode-capable peer fills
        sequences that have nowhere to stream). Explicit ``peers``
        entries ARE the topology (rank order, the runtime's
        ``fleet_topology``); without them an explicit single role is
        the whole fleet. ``role: auto`` without peers splits ranks at
        runtime by a host count the model conf cannot see — skipped,
        like SRV001's not-statically-decidable window."""
    fleet = getattr(model_cfg, "fleet", None)
    if fleet is None:
        return
    # (c) elastic sizing that cannot describe a fleet. Explicit peers
    # entries ARE the topology, so max_hosts cannot invent hosts beyond
    # them, and min_hosts cannot exceed whatever is actually declared
    # (peers when present, else max_hosts) — both reject at
    # run_from_conf before any host serves
    if (
        fleet.peers
        and fleet.max_hosts
        and fleet.max_hosts > len(fleet.peers)
    ):
        col.emit(
            FLT001,
            path,
            f"fleet max_hosts {fleet.max_hosts} exceeds the "
            f"{len(fleet.peers)} declared peers entries — peers name "
            "the whole topology, max_hosts cannot invent hosts: the "
            "launch would reject before any host serves",
            fix_hint="declare the extra hosts as peers entries, or "
            "drop max_hosts",
        )
    n_declared = len(fleet.peers or ()) or (fleet.max_hosts or 0)
    if fleet.min_hosts and n_declared and fleet.min_hosts > n_declared:
        col.emit(
            FLT001,
            path,
            f"fleet min_hosts {fleet.min_hosts} exceeds the declared "
            f"topology ({n_declared} host(s) from "
            f"{'peers' if fleet.peers else 'max_hosts'}): the launch "
            "would reject before any host serves",
            fix_hint="lower min_hosts or declare more peers/max_hosts",
        )
    # (d) a LIVE prefix [0, min_hosts) that covers only one half of a
    # split-role fleet: latent peers are excluded from placement until
    # they join, so the lonely live half either rejects at FleetHost
    # construction (decode with no live prefill) or silently defers
    # every filled sequence forever (prefill with no live decode).
    # Statically decidable with explicit peers, or with role auto's
    # rank-split (ranks below prefill_hosts prefill, the rest decode).
    live_prefix: list[str] | None = None
    if fleet.min_hosts:
        if fleet.peers and fleet.min_hosts <= len(fleet.peers):
            live_prefix = [
                p.role for p in fleet.peers[: fleet.min_hosts]
            ]
        elif not fleet.peers and fleet.role == "auto":
            np_hosts = max(1, fleet.prefill_hosts)
            live_prefix = [
                "prefill" if k < np_hosts else "decode"
                for k in range(fleet.min_hosts)
            ]
    if live_prefix is not None:
        live = set(live_prefix)
        for lonely, need in (
            ("prefill", {"decode", "unified"}),
            ("decode", {"prefill", "unified"}),
        ):
            if lonely in live and not live & need:
                col.emit(
                    FLT001,
                    path,
                    f"fleet live prefix [0, min_hosts={fleet.min_hosts}) "
                    f"is {lonely}-only — the "
                    f"{'/'.join(sorted(need))} half is entirely LATENT "
                    "(excluded from placement until it joins), so the "
                    "fleet launches but cannot serve a single stream "
                    "until a join happens",
                    fix_hint="raise min_hosts to cover both roles, or "
                    "reorder peers so the live prefix is "
                    "self-sufficient",
                )
    peer_roles = [p.role for p in (fleet.peers or [])]
    if peer_roles:
        topo_roles = set(peer_roles)
    elif fleet.role in ("prefill", "decode", "unified"):
        topo_roles = {fleet.role}
    else:
        topo_roles = None  # auto rank-split: both halves, count unknown
    runs_prefill = (
        topo_roles is None or topo_roles & {"prefill", "unified"}
    )
    srv = getattr(model_cfg, "serving", None)
    if runs_prefill and srv is not None and srv.kv_blocks > 0:
        window = _declared_window(model_cfg)
        block_len = max(1, srv.kv_block_len)
        need = -(-window // block_len) + 1 if window else 0
        if window and srv.kv_blocks < need:
            col.emit(
                FLT001,
                path,
                f"fleet prefill host with kv_blocks {srv.kv_blocks} < "
                f"{need} needed to admit one max-length prompt "
                f"({window} positions / kv_block_len {block_len} + the "
                "reserved trash block): every admission would raise "
                "before a single prefill chunk ran",
                fix_hint=f"set kv_blocks >= {need} (or 0 for "
                "dense-equivalent sizing)",
            )
    if topo_roles is None:
        return
    if "decode" in topo_roles and not topo_roles & {"prefill", "unified"}:
        col.emit(
            FLT001,
            path,
            "fleet decode host(s) with no prefill-capable peer (no "
            "topology entry of role prefill/unified): nothing can "
            "ever fill their KV blocks — FleetHost rejects this "
            "config at construction",
            fix_hint="add a peers { name: ... role: prefill } entry, "
            "or run role: unified",
        )
    if "prefill" in topo_roles and not topo_roles & {"decode", "unified"}:
        col.emit(
            FLT001,
            path,
            "fleet prefill host(s) with no decode-capable peer (no "
            "topology entry of role decode/unified): filled sequences "
            "would have nowhere to stream — FleetHost rejects this "
            "config at construction",
            fix_hint="add a peers { name: ... role: decode } entry, "
            "or run role: unified",
        )


def rollout_rules(
    model_cfg: ModelConfig, path: str, col: Collector
) -> None:
    """ROL001 — static mirrors of the live-rollout controller's launch
    rejections and its two config-only failure modes
    (serve/rollout.py). A ``fleet { rollout {} }`` block counts as
    CONFIGURED once any of version / checkpoint / canary is set; an
    all-defaults block is inert and skipped. Arms, reported
    independently:

    (a) configured without a ``checkpoint``: the controller has no
        next-version weights to ship and rejects at launch.
    (b) a ``canary`` that is not a declared peer (the controller
        rejects at construction), or one whose declared role is
        ``prefill``: parity probes ride the real serving path, and a
        prefill host's decode phase is gated off — its probe streams
        can NEVER finish, so the canary "fails" by timeout every time,
        a pure config bug that reads like a bad rollout.
    (c) a ``canary`` named in a single-host fleet: the canary IS the
        whole fleet, so a parity mismatch has no un-flipped host to
        keep serving during the rollback window.
    (d) degenerate knobs that disable the health gate instead of
        tuning it (zero probes, zero probe budget, non-positive
        stage-ack window, negative retry budget).

    The dual-resident HBM arm (staged params double the weight
    footprint for the stage window) lives in the cost model
    (lint/cost_model.py), where the per-device bytes are computed."""
    fleet = getattr(model_cfg, "fleet", None)
    if fleet is None:
        return
    ro = getattr(fleet, "rollout", None)
    if ro is None:
        return
    if not (ro.version or ro.checkpoint or ro.canary):
        return
    if not ro.checkpoint:
        col.emit(
            ROL001,
            path,
            "fleet rollout declared (version/canary set) without a "
            "checkpoint — the controller has no next-version weights "
            "to ship and rejects at launch",
            fix_hint='set rollout { checkpoint: "<npz save | sharded '
            'dir | retention folder>" }',
        )
    peers = fleet.peers or []
    roles = {p.name: p.role for p in peers}
    if ro.canary and peers:
        if ro.canary not in roles:
            col.emit(
                ROL001,
                path,
                f"rollout canary {ro.canary!r} is not a declared "
                f"peers entry ({', '.join(sorted(roles))}) — the "
                "controller rejects at construction",
                fix_hint="name an existing peers entry (or omit "
                "canary to take the first decode-capable host)",
            )
        elif roles[ro.canary] == "prefill":
            col.emit(
                ROL001,
                path,
                f"rollout canary {ro.canary!r} has role prefill — its "
                "decode phase is gated off, so parity probe streams "
                "can never finish: every canary would 'fail' by probe "
                "timeout, a config bug that reads like a bad rollout",
                fix_hint="pick a decode/unified peer as the canary",
            )
    n_declared = len(peers) or (fleet.max_hosts or 0)
    if ro.canary and n_declared == 1:
        col.emit(
            ROL001,
            path,
            f"rollout canary {ro.canary!r} named in a single-host "
            "fleet — the canary IS the whole fleet, so a parity "
            "mismatch leaves no un-flipped host serving during the "
            "rollback window",
            fix_hint="drop the canary (single-host rollouts flip "
            "in place) or declare more hosts",
        )
    for knob, val, lo in (
        ("parity_probes", ro.parity_probes, 1),
        ("probe_tokens", ro.probe_tokens, 1),
        ("ship_retries", ro.ship_retries, 0),
    ):
        if val < lo:
            col.emit(
                ROL001,
                path,
                f"rollout {knob} {val} < {lo} — the health gate "
                "cannot run with a degenerate budget",
                fix_hint=f"set rollout {{ {knob}: >= {lo} }} (or omit "
                "for the default)",
            )
    if ro.stage_timeout_s <= 0:
        col.emit(
            ROL001,
            path,
            f"rollout stage_timeout_s {ro.stage_timeout_s:g} <= 0 — a "
            "zero stage-ack window reads every healthy host as a "
            "swap_die pause",
            fix_hint="set rollout { stage_timeout_s: > 0 } (or omit "
            "for the default)",
        )


def wire_rules(model_cfg: ModelConfig, path: str, col: Collector) -> None:
    """WIR001 — static mirrors of the socket transport's launch
    rejections and its one silent-degradation mode (comm/wire.py,
    selected by ``fleet { transport: socket }``). Arms, reported
    independently:

    (a) addressing the factory rejects at launch
        (serve/fleet/host._build_transport): no ``peers`` entries at
        all (a socket fleet has no runtime discovery — the address map
        IS the topology), a peers entry with an empty ``address``, two
        entries binding the SAME address (the second register's bind
        raises mid-launch, after the first host is already up), and a
        missing ``wire.frontdoor_address`` (the router/driver endpoint
        cannot be auto-bound across OS processes).
    (b) wire knobs that disable the retry machinery instead of tuning
        it: non-positive connect/send timeouts or backoff_s (a zero
        deadline times out every frame; a zero backoff is the hot
        reconnect loop the transport exists to prevent), negative
        max_retries.
    (c) a send deadline that cannot cover ONE max-size migration
        message: a retry re-sends the whole frame from scratch, so if
        ``send_timeout_s`` < the bulk npz migration's transfer time at
        the declared ``wire.link_bandwidth_bytes_per_s``, EVERY attempt
        times out mid-frame and the retry budget burns to a false
        peer-death tombstone — the one failure mode that looks like a
        network fault but is pure configuration. Skipped when the
        window/geometry is not statically decidable (SRV001's
        convention) or link_bandwidth_bytes_per_s is 0 (unset)."""
    fleet = getattr(model_cfg, "fleet", None)
    if fleet is None or fleet.transport != "socket":
        return
    wire = fleet.wire
    peers = fleet.peers or []
    if not peers:
        col.emit(
            WIR001,
            path,
            "transport: socket with no peers entries — the address map "
            "IS the topology (no runtime discovery), so the launch "
            "rejects before any host binds",
            fix_hint="declare every host as peers { name: ... role: "
            "... address: \"host:port\" }",
        )
    unaddressed = [p.name for p in peers if not p.address]
    if unaddressed:
        col.emit(
            WIR001,
            path,
            f"transport: socket peers without an address: "
            f"{', '.join(unaddressed)} — the launch rejects before any "
            "host binds (mailbox infers endpoints from the shared "
            "root; sockets cannot)",
            fix_hint="give every peers entry address: \"host:port\"",
        )
    seen_addr: dict[str, str] = {}
    frontdoor = wire.frontdoor_address if wire is not None else ""
    if frontdoor:
        seen_addr[frontdoor] = "wire.frontdoor_address"
    for p in peers:
        if not p.address:
            continue
        if p.address in seen_addr:
            col.emit(
                WIR001,
                path,
                f"peers entry {p.name!r} binds address {p.address!r} "
                f"already claimed by {seen_addr[p.address]} — the "
                "second register's bind raises mid-launch, after the "
                "first host is already up",
                fix_hint="give every endpoint a distinct host:port",
            )
        else:
            seen_addr[p.address] = f"peers entry {p.name!r}"
    if peers and not frontdoor:
        col.emit(
            WIR001,
            path,
            "transport: socket without wire.frontdoor_address — the "
            "front-door router/driver endpoint cannot be auto-bound "
            "across OS processes, so hosts cannot return results or "
            "hand back drained sequences",
            fix_hint='add wire { frontdoor_address: "host:port" }',
        )
    if wire is None:
        return
    for knob, val in (
        ("connect_timeout_s", wire.connect_timeout_s),
        ("send_timeout_s", wire.send_timeout_s),
        ("backoff_s", wire.backoff_s),
    ):
        if val is not None and val <= 0:
            col.emit(
                WIR001,
                path,
                f"wire.{knob} {val:g} <= 0 — a zero deadline times out "
                "every frame and a zero backoff is the hot reconnect "
                "loop the transport exists to prevent",
                fix_hint=f"set wire.{knob} > 0 (or omit for the "
                "default)",
            )
    if wire.max_retries is not None and wire.max_retries < 0:
        col.emit(
            WIR001,
            path,
            f"wire.max_retries {wire.max_retries} < 0 — the retry "
            "budget cannot be negative (0 means single-attempt)",
            fix_hint="set wire.max_retries >= 0 (or omit for the "
            "default)",
        )
    # (c) the deadline-vs-migration-size budget. A migration frame is
    # the sequence's whole serving state as ONE bulk message (gather,
    # wire, scatter): K and V per attention layer across every block a
    # max-length sequence touches, plus its token lane — sized from the
    # same declared geometry kernel_rules reads
    bw = wire.link_bandwidth_bytes_per_s
    timeout = wire.send_timeout_s
    srv = getattr(model_cfg, "serving", None)
    if not bw or bw <= 0 or not timeout or timeout <= 0 or srv is None:
        return
    n_layers, heads, head_dim = _declared_heads(model_cfg)
    window = _declared_window(model_cfg)
    if not (n_layers and heads and head_dim and window):
        return  # geometry not statically decidable: nothing to budget
    block_len = max(1, srv.kv_block_len)
    n_blocks = -(-window // block_len)
    msg_bytes = (
        2 * n_layers * heads * n_blocks * block_len * head_dim * 4
        + window * 4  # token lane (i32)
        + 4096  # npz/header overhead
    )
    need_s = msg_bytes / bw
    if timeout < need_s:
        col.emit(
            WIR001,
            path,
            f"wire.send_timeout_s {timeout:g} cannot cover one "
            f"max-size migration message: ~{msg_bytes} bytes "
            f"({n_layers} layers x {heads} heads x {n_blocks} blocks "
            f"x {block_len} x {head_dim} K+V f32, window {window}) at "
            f"link_bandwidth_bytes_per_s {bw:g} needs ~{need_s:.2f}s "
            "per attempt — retries re-send from scratch, so every "
            "attempt times out mid-frame and the budget burns to a "
            "false peer-death tombstone",
            fix_hint=f"set wire.send_timeout_s >= {need_s:.2f} or "
            "declare the real link bandwidth",
        )
    # (d) the same budget for the fleet prefix cache's cache_ship
    # frame: a max-depth ship carries every block of a max-length
    # prompt's K/V (no token lane — digests ride in the JSON header).
    # A too-short deadline here is WORSE than a failed migration: the
    # requester holds the request until its fetch deadline, then
    # degrades to plain prefill — every warm admission pays the fetch
    # timeout and the cache never helps. Gated on the prefix cache
    # actually being on (no cache, no ship frames)
    pc = getattr(srv, "prefix_cache", None)
    if pc is None or not getattr(pc, "enabled", False):
        return
    ship_bytes = (
        2 * n_layers * heads * n_blocks * block_len * head_dim * 4
        + n_blocks * 32  # hex digest chain in the JSON header
        + 4096  # npz/header overhead
    )
    ship_need_s = ship_bytes / bw
    if timeout < ship_need_s:
        col.emit(
            WIR001,
            path,
            f"wire.send_timeout_s {timeout:g} cannot cover one "
            f"max-prefix cache_ship frame: ~{ship_bytes} bytes "
            f"({n_layers} layers x {heads} heads x {n_blocks} blocks "
            f"x {block_len} x {head_dim} K+V f32) at "
            f"link_bandwidth_bytes_per_s {bw:g} needs "
            f"~{ship_need_s:.2f}s per attempt — every cross-host "
            "prefix fetch would burn its deadline and degrade to "
            "plain prefill, so the fleet cache never helps",
            fix_hint=f"set wire.send_timeout_s >= {ship_need_s:.2f}, "
            "declare the real link bandwidth, or disable "
            "serving.prefix_cache",
        )


def elastic_rules(
    model_cfg: ModelConfig,
    widths: dict[str, int] | None,
    path: str,
    col: Collector,
) -> None:
    """ELA001 — static mirror of the elastic-restore admission check
    (resilience/reshard.py ``check_manifest``; threaded through
    ``--cluster`` like SRV001/KRN002). When the conf's ``checkpoint``
    field names a SHARDED checkpoint dir whose manifest is readable,
    every saved entry's recorded PartitionSpec must be hostable by the
    target cluster's mesh: a spec naming an axis the mesh vocabulary
    lacks (a foreign manifest), or a dim with fewer elements than the
    named axes' combined target width wants shards (beyond even the
    pad/replicate fallback), rejects at restore time — after the job
    is already up. The SAME ``hostable`` predicate runs here, so lint
    and runtime can never disagree. A checkpoint path that does not
    exist (yet) or is an npz file is skipped: only a present, parseable
    manifest is statically decidable, like SRV001's window."""
    import json
    import os

    if widths is None:
        return
    ckpt = getattr(model_cfg, "checkpoint", None)
    if not ckpt or not os.path.isdir(ckpt):
        return
    try:
        with open(os.path.join(ckpt, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return  # not a readable sharded manifest: nothing decidable
    if manifest.get("format") != "singa-tpu-sharded-v1":
        # the runtime never feeds a foreign-format manifest to the
        # resharder (ShardedCheckpoint rejects it first) — lint must
        # not claim a reshard verdict the runtime would never reach
        return
    from ..resilience.reshard import check_manifest

    problems = check_manifest(manifest, widths)
    # one diagnostic per distinct reason, naming one exemplar entry —
    # a 200-param model sharing one bad axis is ONE problem
    by_reason: dict[str, str] = {}
    for key in sorted(problems):
        by_reason.setdefault(problems[key], key)
    for reason, key in by_reason.items():
        more = sum(1 for r in problems.values() if r == reason) - 1
        extra = f" (+{more} more entr{'y' if more == 1 else 'ies'})" \
            if more else ""
        col.emit(
            ELA001,
            path,
            f"checkpoint {ckpt!r} entry {key!r}{extra}: {reason} — "
            "the elastic restore would reject this resume at runtime "
            "(resilience/reshard.py)",
            fix_hint="resume on a mesh whose axis widths can host the "
            "manifest's specs, or point `checkpoint` at a compatible "
            "save",
        )


def kernel_rules(model_cfg: ModelConfig, path: str, col: Collector) -> None:
    """KRN001 — static mirror of the serving engine's fused-kernel
    geometry rejection (serve/engine.py consults the SAME
    ops.paged_attention.fusable predicate at construction on ``cuda``).
    A conf that selects ``kernels { paged_attention: fused }`` with a
    head_dim the CUDA kernel is not compiled for would reject at engine
    build time, after card time is already spent; flag it at lint time
    instead. The engine's check ignores ``interpret`` (the JAX package's
    Pallas switch), so this rule does too: the port's entry points run
    on the card. The head_dim comes from the conf's declared dims — the
    kEmbedding layer's ``embedding_dim`` over the kAttention layer's
    ``num_heads`` — and is skipped when either is undeclared (not
    statically decidable, like SRV001's window)."""
    kern = getattr(model_cfg, "kernels", None)
    if kern is None or kern.paged_attention != "fused":
        return
    from ..ops.paged_attention import KERNEL_HEAD_DIMS, fusable

    srv = getattr(model_cfg, "serving", None)
    block_len = srv.kv_block_len if srv is not None else (
        schema.ServingConfig.FIELDS["kv_block_len"].default
    )
    _, _, head_dim = _declared_heads(model_cfg)
    # check each declared dimension independently (a missing head_dim
    # must not mask an unusable block_len and vice versa)
    reasons = dict.fromkeys(
        r
        for r in (
            fusable(block_len, KERNEL_HEAD_DIMS[0]),
            fusable(1, head_dim) if head_dim else None,
        )
        if r is not None
    )
    for reason in reasons:
        col.emit(
            KRN001,
            path,
            f"kernels.paged_attention 'fused', but {reason} — the "
            "engine will reject this config at construction on cuda",
            fix_hint=f"pick a head_dim in {KERNEL_HEAD_DIMS} "
            "(embedding_dim / num_heads) and kv_block_len >= 1, or keep "
            "paged_attention: reference",
        )


def _declared_heads(model_cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_attention_layers, n_heads, head_dim) from declared dims; the
    head count and head_dim are 0 when not statically decidable."""
    net_cfg = model_cfg.neuralnet
    if net_cfg is None:
        return 0, 0, 0
    n_layers = sum(1 for l in net_cfg.layer if l.attention_param is not None)
    dim = max(
        (
            l.embedding_param.embedding_dim
            for l in net_cfg.layer
            if l.embedding_param is not None
        ),
        default=0,
    )
    heads = max(
        (
            l.attention_param.num_heads
            for l in net_cfg.layer
            if l.attention_param is not None
        ),
        default=0,
    )
    if not (dim and heads and dim % heads == 0):
        return n_layers, 0, 0
    return n_layers, heads, dim // heads


def ring_rules(
    model_cfg: ModelConfig,
    cluster_cfg: ClusterConfig | None,
    widths: dict[str, int] | None,
    path: str,
    col: Collector,
) -> None:
    """KRN002 — static mirror of the quantized-ring rejections (the
    trainer consults the SAME ``ring_reducible`` predicate and the same
    quantized-block requirement at construction;
    ops/quantized_collective.py). Seven arms, each reported
    independently: (1) ``kernels { grad_allreduce: quantized_ring }``
    without an active ``grad_comm { mode: quantized }`` block — the
    ring is the quantized collective's wire implementation, there is
    nothing to put on the wire; (2) combined with the replica (async
    PS) engine, whose EASGD protocol owns its own sync math — the
    CMM001 static mirror for this site, threaded through ``--cluster``;
    (3) the CD engine — its layerwise step is not the ring's per-rank
    backward (``CDTrainer`` rejects at construction); (4) a batch-stat
    (kBatchNorm) net — inside the ring's per-shard backward, sync BN's
    global moments would silently become local-shard stats; (5) a >1-wide non-data mesh axis under
    the FLAT ring — q8_hier with a covering ring {} factorization is
    the acceptance path; (5b, q8_hier only) a broken two-level
    geometry — ``hier_ring_geometry``'s reason verbatim (missing
    ``ring {}`` block, an intra/inter axis naming no mesh axis — with
    a did-you-mean over the cluster's axes — an intra_degree the data
    width cannot divide, or an uncovered >1-wide leftover axis),
    threaded through ``--cluster``; (6) a train batchsize the
    reduction width (K*M for q8_hier) cannot divide — each shard
    computes its own local partial; (7) a reduction width the ring's
    bucket chunking cannot divide — checked on the
    statically-declared neuron dims (a layer's bias gradient is
    ``(num_output,)``, chunked on dim 0; weight input dims need shape
    inference and are left to the runtime predicate)."""
    kern = getattr(model_cfg, "kernels", None)
    if kern is None or kern.grad_allreduce not in (
        "quantized_ring", "q8_hier"
    ):
        return
    impl = kern.grad_allreduce
    hier = impl == "q8_hier"
    gc = getattr(model_cfg, "grad_comm", None)
    if gc is None or gc.mode != "quantized":
        col.emit(
            KRN002,
            path,
            f"kernels.grad_allreduce '{impl}' without an active "
            "grad_comm { mode: quantized } block: the ring is the "
            "quantized collective's wire implementation — the trainer "
            "rejects this config at construction",
            fix_hint="add grad_comm { mode: quantized dtype: int8 }, or "
            "keep grad_allreduce: reference",
        )
    if (
        cluster_cfg is not None
        and cluster_cfg.nservers > 0
        and not cluster_cfg.synchronous
        and model_cfg.alg != "kContrastiveDivergence"
        and model_cfg.updater is not None
    ):
        col.emit(
            KRN002,
            path,
            f"kernels.grad_allreduce '{impl}' with an "
            "asynchronous nservers>0 cluster: the replica engine's "
            "EASGD protocol owns its own gradient sync and rejects the "
            "ring at construction",
            fix_hint="drop the kernels/grad_comm blocks, or run the "
            "synchronous engine (synchronous: true / nservers: 0)",
        )
    if model_cfg.alg == "kContrastiveDivergence":
        col.emit(
            KRN002,
            path,
            f"kernels.grad_allreduce '{impl}' with the "
            "kContrastiveDivergence engine: the CD trainer's layerwise "
            "step is not the ring's per-rank backward and rejects it "
            "at construction",
            fix_hint="keep grad_allreduce: reference for CD jobs",
        )
    bn = [
        l.name
        for l in (model_cfg.neuralnet.layer if model_cfg.neuralnet else [])
        if l.type == "kBatchNorm"
    ]
    if bn:
        col.emit(
            KRN002,
            path,
            f"kernels.grad_allreduce '{impl}' with batch-stat "
            f"layers {bn}: the ring's per-shard backward would turn "
            "sync BatchNorm into local-shard BN (biased variance) — "
            "the trainer rejects this config at construction",
            fix_hint="drop the kBatchNorm layers, or keep "
            "grad_allreduce: reference",
        )
    ring_cfg = getattr(model_cfg, "ring", None)
    ndata = (widths or {}).get("data", 0)
    if hier:
        from ..ops.quantized_collective import hier_ring_geometry

        if widths is not None:
            geom = hier_ring_geometry(widths, ring_cfg)
        else:
            # no --cluster: validate the ring {} block's FORM only,
            # against a mesh that cannot trigger width errors
            intra = getattr(ring_cfg, "intra_axis", "") or ""
            inter = getattr(ring_cfg, "inter_axis", "") or ""
            deg = int(getattr(ring_cfg, "intra_degree", 0) or 0)
            fake = {a: 1 for a in (intra, inter) if a}
            fake.setdefault("data", max(1, deg))
            geom = hier_ring_geometry(fake, ring_cfg)
        if isinstance(geom, str):
            hint = (
                "declare ring { intra_degree } dividing the data "
                "width, or intra_axis/inter_axis naming two real mesh "
                "axes that cover every >1-wide axis"
            )
            if widths and ring_cfg is not None:
                sugg = []
                for role in ("intra_axis", "inter_axis"):
                    ax = getattr(ring_cfg, role, "")
                    if ax and ax not in widths:
                        close = difflib.get_close_matches(
                            ax, sorted(widths), n=1
                        )
                        if close:
                            sugg.append(f"{role}: {close[0]}")
                if sugg:
                    hint = "did you mean " + ", ".join(sugg) + "?"
            col.emit(
                KRN002,
                path,
                f"kernels.grad_allreduce 'q8_hier' cannot run: {geom} "
                "— the trainer rejects this config at construction",
                fix_hint=hint,
            )
        else:
            ndata = geom[2] * geom[3]
            if geom[0] != geom[1] and bool(model_cfg.zero_update):
                col.emit(
                    KRN002,
                    path,
                    "kernels.grad_allreduce 'q8_hier' with named "
                    "intra_axis/inter_axis does not compose with "
                    "zero_update (the update layout shards over the "
                    "data axis only) — the trainer rejects this "
                    "config at construction",
                    fix_hint="use the factored ring { intra_degree } "
                    "form, or drop zero_update",
                )
    else:
        other = {
            a: w
            for a, w in (widths or {}).items()
            if a != "data" and w > 1
        }
        if other:
            col.emit(
                KRN002,
                path,
                "kernels.grad_allreduce 'quantized_ring' runs over the "
                f"data axis only, but the cluster also shards {other} "
                "— the trainer rejects this config at construction",
                fix_hint="switch to grad_allreduce: q8_hier with a "
                "ring { intra_axis/inter_axis } block covering the "
                "extra axis, widen only the data axis, or keep "
                "grad_allreduce: reference",
            )
    net_cfg = model_cfg.neuralnet
    if ndata <= 1 or net_cfg is None:
        return
    for l in net_cfg.layer:
        dp = getattr(l, "data_param", None)
        bs = getattr(dp, "batchsize", 0) if dp is not None else 0
        if bs and "kTrain" not in (l.exclude or []) and bs % ndata:
            col.emit(
                KRN002,
                path,
                f"kernels.grad_allreduce '{impl}' on a {ndata}"
                "-wide data reduction, but layer "
                f"{l.name!r}'s train batchsize {bs} is not divisible "
                "by it: each shard computes its own local partial "
                "gradients — the trainer rejects this config at "
                "construction",
                fix_hint=f"pick a batchsize divisible by {ndata}, or "
                "resize the data axis",
            )
    from ..ops.quantized_collective import ring_reducible

    shapes = {}
    for l in net_cfg.layer:
        fields = _NEURON_DIM_FIELDS.get(l.type)
        if fields:
            sub = getattr(l, fields[0], None)
            dim = getattr(sub, fields[1], None) if sub else None
            if dim:
                shapes[f"{l.name} ({fields[1]} {dim})"] = (dim,)
    reason = ring_reducible(shapes, ndata)
    if reason is not None:
        col.emit(
            KRN002,
            path,
            f"kernels.grad_allreduce '{impl}' on a {ndata}-wide "
            f"data reduction, but {reason} — the trainer rejects this "
            "config at construction",
            fix_hint=f"pick neuron dims divisible by {ndata}, resize "
            "the data axis, or keep grad_allreduce: reference",
        )


# ---------------------------------------------------------------------------
# sharding rules (model conf x cluster axis widths)
# ---------------------------------------------------------------------------

#: config-declared neuron-dim per layer type, for the static SHD001
#: fallback when the net can't be built (data sources absent). The
#: build-based check in shape_rules covers every param precisely — and
#: ring_rules reuses the table for KRN002's bias-gradient chunk check.
_NEURON_DIM_FIELDS = {
    "kInnerProduct": ("inner_product_param", "num_output"),
    "kDense": ("dense_param", "num_output"),
    "kConvolution": ("convolution_param", "num_filters"),
    "kRBM": ("rbm_param", "num_hidden"),
}


def sharding_rules_static(
    model_cfg: ModelConfig,
    widths: dict[str, int],
    path: str,
    col: Collector,
    *,
    neuron_dims: bool = True,
) -> None:
    """SHD001/SHD003 from config fields alone (no data, no layer setup).

    Mirrors parallel/shardings._param_layout's divisibility condition: a
    kLayerPartition layer whose neuron dim is not a multiple of the model
    axis gets padded storage (experts: replication) instead of an even
    shard — legal, but a silent perf/memory cliff worth a warning.

    ``neuron_dims=False`` keeps only the SHD003 batch check — used when
    the net built and _sharding_rules_built already covered every param
    precisely (the config-level SHD001 heuristic would double-report).
    """
    net_cfg = model_cfg.neuralnet
    if net_cfg is None:
        return
    nmodel = widths.get("model", 1)
    ndata = widths.get("data", 1)
    for l in net_cfg.layer:
        ptype = l.partition_type or net_cfg.partition_type
        if neuron_dims and nmodel > 1 and ptype == "kLayerPartition":
            fields = _NEURON_DIM_FIELDS.get(l.type)
            if fields:
                sub = getattr(l, fields[0], None)
                dim = getattr(sub, fields[1], None) if sub else None
                if dim and dim % nmodel:
                    col.emit(
                        SHD001,
                        f"{path} (layer {l.name!r})",
                        f"neuron dim {dim} ({fields[1]}) not divisible by "
                        f"model axis {nmodel}: storage pads to "
                        f"{dim + (-dim % nmodel)} rather than sharding "
                        "evenly",
                        fix_hint=f"pick a multiple of {nmodel} or widen "
                        "the data axis instead",
                    )
        if ndata > 1 and l.data_param is not None and l.data_param.batchsize:
            bs = l.data_param.batchsize
            if bs % ndata:
                col.emit(
                    SHD003,
                    f"{path} (layer {l.name!r})",
                    f"batchsize {bs} not divisible by data axis {ndata}",
                    fix_hint=f"use a multiple of {ndata}",
                )


def _locs_of(
    text: str | None,
) -> dict[str, list[textproto.FieldLoc]] | None:
    """The span tree for ``text``, or None when it cannot be lexed (the
    caller already reported the parse failure — spans are best-effort)."""
    if not text:
        return None
    try:
        _, locs = textproto.parse_with_locs(text)
    except textproto.TextProtoError:
        return None
    return locs


_UNKNOWN_FIELD = re.compile(r"unknown field '([^']+)'")
_BAD_ENUM = re.compile(r"field '[^']+': ('[^']+') not in enum")


def _walk_explains(err_msg: str, walk_diags: list) -> bool:
    """Whether the strict parser's ConfigError re-states a problem the raw
    walk already reported. The walk validates field names (CFG001), enum
    membership (CFG002), scalar coercion and required fields (CFG000, with
    the strict parser's exact message text); only a strict-parse failure
    matching none of those is new information. Matching is per-problem,
    never "the walk found *something*" — the strict parse stops at its
    first error, so suppressing on unrelated findings would hide it."""
    m = _UNKNOWN_FIELD.search(err_msg)
    if m:
        needle = f"unknown field '{m.group(1)}'"
        return any(
            d.code == "CFG001" and needle in d.msg for d in walk_diags
        )
    m = _BAD_ENUM.search(err_msg)
    if m:
        needle = f"{m.group(1)} not in"
        return any(
            d.code == "CFG002" and needle in d.msg for d in walk_diags
        )
    return any(d.msg == err_msg for d in walk_diags)


def lint_model_text(
    text: str,
    path: str,
    col: Collector,
    *,
    widths: dict[str, int] | None = None,
    raw: dict[str, list[Any]] | None = None,
) -> ModelConfig | None:
    """Full static pass over one model conf: raw walk, strict parse,
    graph rules, static sharding rules. Returns the parsed config when it
    parsed (the shape pass builds on it), else None. Pass ``raw`` when
    the caller already parsed the text (the CLI does, to classify
    model vs cluster confs)."""
    if raw is None:
        try:
            raw = textproto.parse(text)
        except textproto.TextProtoError as e:
            col.emit(CFG000, path, str(e))
            return None
    before = len(col.diagnostics)
    walk_raw_config(
        raw, ModelConfig, path, col, text=text, locs=_locs_of(text)
    )
    try:
        model_cfg = ModelConfig.from_fields(raw)
    except ConfigError as e:
        if not _walk_explains(str(e), col.diagnostics[before:]):
            col.emit(CFG000, path, str(e))
        return None
    graph_rules(model_cfg, path, col)
    serving_rules(model_cfg, path, col)
    fleet_rules(model_cfg, path, col)
    rollout_rules(model_cfg, path, col)
    wire_rules(model_cfg, path, col)
    kernel_rules(model_cfg, path, col)
    if widths:
        sharding_rules_static(model_cfg, widths, path, col)
    return model_cfg


def lint_cluster_text(
    text: str,
    path: str,
    col: Collector,
    *,
    raw: dict[str, list[Any]] | None = None,
) -> tuple[ClusterConfig | None, dict[str, int] | None]:
    """Static pass over one cluster conf; returns (config, axis widths)."""
    if raw is None:
        try:
            raw = textproto.parse(text)
        except textproto.TextProtoError as e:
            col.emit(CFG000, path, str(e))
            return None, None
    before = len(col.diagnostics)
    walk_raw_config(
        raw, ClusterConfig, path, col, text=text, locs=_locs_of(text)
    )
    try:
        cluster_cfg = ClusterConfig.from_fields(raw)
    except ConfigError as e:
        if not _walk_explains(str(e), col.diagnostics[before:]):
            col.emit(CFG000, path, str(e))
        return None, None
    return cluster_cfg, cluster_rules(cluster_cfg, path, col)
