"""Cost-aware shardlint: static per-config HBM / collective / bubble model.

Counterpart of ``singa_tpu/lint/cost_model.py``: the same arithmetic,
priced against the port's own program. The reference's parameter-server
era had no way to know a model/cluster config was infeasible until
workers ran out of memory or the server saturated (src/server/server.cc);
this pass answers the capacity question BEFORE any card time is spent.
From the parsed model conf + cluster conf + sharding plan it models:

  (a) the per-device HBM footprint — fp32 master params (stored, padded
      shapes, divided by their forward sharding), updater slots in the
      ``zero_update`` UPDATE layout (the same dim-selection rule as the
      Trainer's zero dims), error-feedback residuals, the activation
      working set per microbatch, and the serving tier's paged KV pool;
  (b) the collective bytes each device moves per step — the data-axis
      gradient reduction (fp32 ring all-reduce, reduce-scatter alone
      under zero_update, or the quantized ring's int8-on-the-wire
      ppermutes via ops/quantized_collective's analytic model), the
      ZeRO param allgather, MoE all-to-all capacity buffers, and
      pipeline edge sends;
  (c) the GPipe fill/drain bubble fraction from stage count x
      microbatches.

Rules (threaded through ``tools/lint.py --cluster`` like SRV001/KRN002):

  MEM001  ERROR  predicted per-device bytes exceed the cluster's declared
                 ``device_hbm_bytes`` budget (0 = no budget, silent)
  COST001 WARN   modeled collective bytes exceed a configurable fraction
                 of modeled compute bytes (``--cost-comm-fraction``)
  SRV002  WARN   KV-pool byte sizing + slots x block-budget admission
                 feasibility (SRV001's capacity sibling)
  FLT002  WARN   per-role fleet capacity below the declared offered load
                 (``fleet { load { ... } }``)

``tools/lint.py --explain-cost`` renders the full report table.

Parity bar (tests/test_torch_lint_cost.py, and chip_smoke's tools phase
on the card): the model equals the port's own counts, exactly — the
modeled optimizer bytes equal ``Trainer.opt_state_bytes_per_device()``,
the ring row equals ``Trainer.modeled_wire_bytes_per_step()`` and the
bytes one step adds to ``ops/quantized_collective.ppermute.sent_bytes``,
under ``grad_allreduce: q8_hier`` the intra-slice (f32) and inter-slice
(quantized) rows equal ``modeled_wire_bytes_levels``, and ``kv_bytes``
equals the bytes of the serving Engine's K/V pool tensors. A cost model
that drifts from the program is a lint bug. A declared ``cluster {
inter_slice_bandwidth }`` adds a transfer-time row to ``--explain-cost``.

Like shape_rules, the HBM/collective half needs a BUILT net (data layers
open their sources); when the shards aren't present the model degrades
silently — the config-only arms (SRV002 sizing, FLT002 load) still run.
"""

from __future__ import annotations

import dataclasses
import math

from ..config import schema
from ..config.schema import ClusterConfig, ModelConfig
from .core import Collector, ERROR, WARNING, rule
from .net_rules import _declared_heads, _declared_window

MEM001 = rule(
    "MEM001",
    ERROR,
    "predicted per-device HBM bytes exceed the declared device_hbm_bytes",
)
COST001 = rule(
    "COST001",
    WARNING,
    "modeled collective bytes exceed the budgeted fraction of compute",
)
SRV002 = rule(
    "SRV002",
    WARNING,
    "serving KV pool undersized for the declared slot concurrency",
)
FLT002 = rule(
    "FLT002",
    WARNING,
    "fleet role capacity below the declared offered load",
)

#: COST001's default comm/compute budget (overridable per run via
#: ``tools/lint.py --cost-comm-fraction``)
DEFAULT_COMM_FRACTION = 0.5


@dataclasses.dataclass
class CostReport:
    """The static cost model for one (model conf, cluster conf) pair.

    All byte figures are PER DEVICE; collectives are per STEP. Component
    naming mirrors the runtime it models: ``opt_bytes`` is the number
    ``trainer.opt_state_bytes_per_device()`` measures, the grad-reduce
    collective row is ``trainer.modeled_wire_bytes_per_step()``."""

    path: str
    widths: dict[str, int]
    nmicro: int
    stages: int
    # --- HBM components (bytes/device) ---
    param_bytes: int
    opt_bytes: int
    residual_bytes: int
    act_bytes: int  # activation working set per microbatch
    kv_bytes: int  # serving KV pool; 0 = none / not statically decidable
    #: per layer (param group): (layer name, n params, bytes/device)
    param_groups: list[tuple[str, int, int]]
    # --- collectives (label, bytes/device/step) ---
    collectives: list[tuple[str, int]]
    compute_bytes: int  # modeled tensor-core operand traffic a step (proxy)
    bubble: float  # GPipe fill/drain fraction, 0.0 when not pipelined
    notes: list[str]
    #: cluster { inter_slice_bandwidth } (bytes/s); 0 = undeclared
    inter_slice_bandwidth: int = 0

    @property
    def hbm_bytes(self) -> int:
        return (
            self.param_bytes
            + self.opt_bytes
            + self.residual_bytes
            + self.act_bytes
            + self.kv_bytes
        )

    @property
    def collective_bytes(self) -> int:
        return sum(b for _, b in self.collectives)


# ---------------------------------------------------------------------------
# sharding-layout mirrors (pure Python: lint builds no mesh)
# ---------------------------------------------------------------------------


def _layout(net, widths: dict[str, int]):
    """-> iterator of (layer, name, spec, stored_shape, fwd_divs).

    The pure-Python mirror of the Trainer's param layout (a
    kLayerPartition neuron dim padded to the model width, an expert dim
    split when the expert width divides it):
    ``stored_shape`` is the (possibly pad-to-multiple) storage shape and
    ``fwd_divs[d]`` the mesh-axis width dim ``d`` is sharded over in the
    FORWARD layout (None = replicated on that dim). Kept in lockstep
    with the Trainer — the parity tests hold the composition."""
    nmodel = widths.get("model", 1)
    nexpert = widths.get("expert", 1)
    for layer in net.layers:
        for name, spec in layer.param_specs().items():
            shape = list(spec.shape)
            divs: list[int | None] = [None] * len(shape)
            if (
                layer.partition_dim == 1
                and spec.neuron_axis is not None
                and nmodel > 1
            ):
                d = spec.neuron_axis
                shape[d] += -shape[d] % nmodel
                divs[d] = nmodel
            elif spec.expert_axis is not None and nexpert > 1:
                if spec.shape[spec.expert_axis] % nexpert == 0:
                    divs[spec.expert_axis] = nexpert
                # else: indivisible expert count replicates (SHD001)
            yield layer, name, spec, tuple(shape), divs


def _zero_dim(
    stored: tuple, divs: list, ndata: int
) -> int | None:
    """The dim zero_update lays over the data axis: the FIRST
    still-replicated dim the data width divides evenly (None = the
    replicate fallback) — the Trainer's zero-dim selection rule."""
    if ndata <= 1:
        return None
    for d, size in enumerate(stored):
        if divs[d] is None and size and size % ndata == 0:
            return d
    return None


def _shard_elems(stored: tuple, divs: list) -> int:
    n = 1
    for size, div in zip(stored, divs):
        n *= size // div if div else size
    return max(n, 1) if stored else 1


def _n_slots(model_cfg: ModelConfig) -> int:
    """Updater slot count (history / history+update) for the configured
    updater type — the multiplier on per-param optimizer bytes."""
    upd = model_cfg.updater
    if upd is None:
        return 0
    from ..optim import _UPDATERS

    cls = _UPDATERS.get(upd.type)
    return len(cls.SLOTS) if cls is not None else 0


def _act_itemsize(model_cfg: ModelConfig) -> int:
    return 2 if model_cfg.compute_dtype in ("bfloat16", "float16") else 4


# ---------------------------------------------------------------------------
# config-only components (no net build required)
# ---------------------------------------------------------------------------


def kv_pool_bytes(
    model_cfg: ModelConfig, widths: dict[str, int], notes: list[str]
) -> int:
    """Per-device bytes of the serving engine's paged KV pools: K and V
    per attention layer, each ``(n_blocks, heads, block_len, head_dim)``
    f32 (serve/engine.py ``Engine._pools``), heads split over the model
    axis when it divides. 0 when the conf declares no serving
    block or the geometry is not statically decidable."""
    srv = model_cfg.serving
    if srv is None:
        return 0
    window = _declared_window(model_cfg)
    n_layers, heads, head_dim = _declared_heads(model_cfg)
    if not window or not head_dim:
        notes.append(
            "serving KV pool not modeled: window or head geometry not "
            "statically declared"
        )
        return 0
    block_len = max(1, srv.kv_block_len)
    per_seq = window // block_len  # KVPool.for_model's floor
    n_blocks = srv.kv_blocks or srv.slots * per_seq + 1
    nmodel = widths.get("model", 1)
    div = nmodel if nmodel > 1 and heads % nmodel == 0 else 1
    return 2 * n_layers * n_blocks * (heads // div) * block_len * head_dim * 4


# ---------------------------------------------------------------------------
# the built-net model
# ---------------------------------------------------------------------------


def _grad_comm_active(model_cfg: ModelConfig) -> bool:
    gc = model_cfg.grad_comm
    return gc is not None and not (gc.mode == "exact" and gc.buckets <= 1)


def _ring_active(model_cfg: ModelConfig) -> bool:
    kern = model_cfg.kernels
    gc = model_cfg.grad_comm
    return (
        kern is not None
        and kern.grad_allreduce in ("quantized_ring", "q8_hier")
        and gc is not None
        and gc.mode == "quantized"
    )


def _hier_geometry(
    model_cfg: ModelConfig, widths: dict[str, int]
) -> tuple[int, int] | None:
    """(K, M) when the hierarchical ring is requested AND its geometry
    resolves on these widths; None for the flat ring or a broken ring{}
    block (KRN002 owns the diagnostic for the latter — the trainer
    rejects that config at construction, so there is no step to price)."""
    kern = model_cfg.kernels
    if kern is None or kern.grad_allreduce != "q8_hier":
        return None
    from ..ops.quantized_collective import hier_ring_geometry

    geom = hier_ring_geometry(widths, model_cfg.ring)
    if isinstance(geom, str):
        return None
    return geom[2], geom[3]


def build_cost_model(
    model_cfg: ModelConfig,
    widths: dict[str, int] | None,
    path: str,
) -> CostReport | None:
    """Build the train net and model its per-device cost, or None when
    the net cannot build (data sources absent — shape_rules' SHP000
    degradation — or a breakage shape_pass already reports)."""
    from ..graph.builder import build_net

    if model_cfg.neuralnet is None:
        return None
    try:
        net = build_net(model_cfg, "kTrain")
    except Exception:
        # OSError: data shards absent (the usual repo-lint case, SHP000).
        # Anything else: shape_pass owns the diagnostic (SHP001).
        return None

    widths = dict(widths or {})
    ndata = max(1, widths.get("data", 1))
    npipe = max(1, widths.get("pipe", 1))
    nexpert = max(1, widths.get("expert", 1))
    notes: list[str] = []

    # --- pipeline staging ------------------------------------------------
    staged_ids = sorted(
        {
            l.cfg.locationid
            for l in net.layers
            if l.cfg.locationid is not None
        }
    )
    stages = npipe if npipe > 1 and len(staged_ids) >= 2 else 1
    nmicro = 1
    if stages > 1:
        nmicro = model_cfg.pipeline_microbatches or stages
    bubble = (stages - 1) / (nmicro + stages - 1) if stages > 1 else 0.0

    # --- params / optimizer slots / residuals ----------------------------
    zero = bool(model_cfg.zero_update)
    nslots = _n_slots(model_cfg)
    gc = model_cfg.grad_comm
    residuals = (
        gc is not None and gc.mode == "quantized" and gc.error_feedback
    )
    ring = _ring_active(model_cfg)
    hier = _hier_geometry(model_cfg, widths) if ring else None
    if hier is not None:
        # the two-level ring reduces over intra*inter devices; the
        # named-axes form widens the data reduction past widths["data"]
        ndata = max(ndata, hier[0] * hier[1])

    param_bytes = 0
    opt_bytes = 0
    residual_bytes = 0
    groups: dict[str, tuple[int, int]] = {}
    zero_gather_bytes = 0  # stored bytes moved by the ZeRO param allgather
    gather: dict[str, bool] = {}  # ring allgather-phase map, per spec name
    sizes: dict[str, int] = {}  # LOGICAL elems per spec name (wire model)
    for layer, name, spec, stored, divs in _layout(net, widths):
        sizes[name] = int(math.prod(spec.shape)) if spec.shape else 1
        zdim = _zero_dim(stored, divs, ndata) if zero else None
        gather[name] = not (ring and zdim is not None)
        if spec.owner is not None:
            continue  # shared params alias their owner's storage
        pb = _shard_elems(stored, divs) * 4  # fp32 masters
        param_bytes += pb
        udivs = list(divs)
        if zdim is not None:
            udivs[zdim] = ndata
            zero_gather_bytes += int(math.prod(stored)) * 4
        ob = _shard_elems(stored, udivs) * nslots * 4
        opt_bytes += ob
        rb = 0
        if residuals:
            # error-feedback residuals are STORED-shape fp32 buffers;
            # under the ring each data shard owns only its chunk
            relems = int(math.prod(stored)) if stored else 1
            rb = (relems // ndata if ring else relems) * 4
            residual_bytes += rb
        n, b = groups.get(layer.name, (0, 0))
        groups[layer.name] = (n + 1, b + pb + ob + rb)
    if zero and nslots and ndata > 1 and opt_bytes == param_bytes * nslots:
        notes.append(
            "zero_update declared but no param dim is divisible by the "
            f"data axis ({ndata}): every update stays replicated"
        )

    # --- activation working set ------------------------------------------
    act_itemsize = _act_itemsize(model_cfg)
    b_dev = max(1, net.batchsize // ndata)
    b_micro = max(1, b_dev // nmicro)
    act_elems = sum(
        int(math.prod(l.out_shape))
        for l in net.layers
        if not l.is_datalayer and l.out_shape
    )
    act_bytes = act_elems * b_micro * act_itemsize
    nmodel = widths.get("model", 1)
    if nmodel > 1:
        notes.append(
            "activation bytes are the unsharded upper bound (model-axis "
            "activation sharding not modeled)"
        )

    # --- serving KV pool --------------------------------------------------
    kv_bytes = kv_pool_bytes(model_cfg, widths, notes)

    # --- collectives -------------------------------------------------------
    collectives: list[tuple[str, int]] = []
    from ..ops.quantized_collective import (
        modeled_wire_bytes,
        reference_wire_bytes,
    )

    if ndata > 1:
        if ring:
            from ..parallel.collectives import reverse_topo_buckets

            specs = net.param_specs()
            buckets = reverse_topo_buckets(
                net, frozenset(sizes), gc.buckets, specs
            )
            if hier is not None:
                from ..ops.quantized_collective import (
                    modeled_wire_bytes_levels,
                )

                levels = modeled_wire_bytes_levels(
                    sizes,
                    buckets,
                    ndata,
                    intra_degree=hier[0],
                    dtype=gc.dtype,
                    gather=gather,
                )
                collectives.append(
                    (
                        "grad ring intra-slice (f32 wire)",
                        int(levels["intra"]),
                    )
                )
                collectives.append(
                    (
                        f"grad ring inter-slice ({gc.dtype} wire)",
                        int(levels["inter"]),
                    )
                )
            else:
                wire = modeled_wire_bytes(
                    sizes, buckets, ndata, dtype=gc.dtype, gather=gather
                )
                collectives.append(
                    (f"grad ring reduce ({gc.dtype} wire)", int(wire))
                )
        else:
            wire = reference_wire_bytes(sizes, ndata, scatter_only=zero)
            label = (
                "grad reduce-scatter (f32 wire)"
                if zero
                else "grad all-reduce (f32 wire)"
            )
            collectives.append((label, int(wire)))
        if zero and zero_gather_bytes:
            # constraining fresh params back to the forward layout is the
            # allgather half zero_update moved off the grad collective
            collectives.append(
                (
                    "zero param allgather (f32)",
                    int(zero_gather_bytes * (ndata - 1) / ndata),
                )
            )

    if nexpert > 1:
        for l in net.layers:
            if l.TYPE != "kMoE" or getattr(l, "dispatch", "") != "alltoall":
                continue
            seq_d = int(math.prod(l.out_shape)) if l.out_shape else 0
            # parallel/moe.py moe_ffn_a2a: two all_to_alls move
            # 2 * cf * n_local * d elements forward (dispatch + combine);
            # the backward retraces both, doubling the volume
            tokens_elems = b_micro * seq_d // nexpert
            a2a = int(
                4 * l.capacity_factor * tokens_elems * act_itemsize * nmicro
            )
            collectives.append((f"moe all-to-all ({l.name})", a2a))

    if stages > 1:
        # per-microbatch ppermute of the stage boundary activation, fwd +
        # bwd; per device = its own boundary (worst stage modeled)
        edge_elems = 0
        prev_id = None
        for l in net.layers:
            lid = l.cfg.locationid
            if (
                prev_id is not None
                and lid is not None
                and lid == prev_id + 1
            ):
                edge_elems = max(edge_elems, int(math.prod(prev_shape)))
            if lid is not None:
                prev_id, prev_shape = lid, l.out_shape or ()
        collectives.append(
            (
                "pipeline edge sends",
                2 * nmicro * edge_elems * b_micro * act_itemsize,
            )
        )

    # --- compute proxy -----------------------------------------------------
    # operand-traffic proxy for one step: every activation is produced in
    # the forward and consumed twice in the backward (~3x the activation
    # stream), and every param is read in the forward, read again in the
    # backward, and its gradient written (~3x the param stream). COST001
    # is a RATIO heuristic on top of this, not a FLOP model.
    logical_param_elems = sum(
        sizes[n] for n, s in net.param_specs().items() if s.owner is None
    )
    compute_bytes = 3 * (
        act_elems * b_dev * act_itemsize
        + logical_param_elems * act_itemsize
    )

    return CostReport(
        path=path,
        widths=widths,
        nmicro=nmicro,
        stages=stages,
        param_bytes=param_bytes,
        opt_bytes=opt_bytes,
        residual_bytes=residual_bytes,
        act_bytes=act_bytes,
        kv_bytes=kv_bytes,
        param_groups=sorted(
            ((ln, n, b) for ln, (n, b) in groups.items()),
            key=lambda t: -t[2],
        ),
        collectives=collectives,
        compute_bytes=compute_bytes,
        bubble=bubble,
        notes=notes,
    )


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


def _fmt_bytes(n: int | float) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} GiB"  # pragma: no cover - loop always returns


def _declared_hit_rate(model_cfg: ModelConfig) -> float:
    """The operator-declared expected prefix-cache hit rate
    (``fleet { load { prefix_hit_rate } }``), clamped to [0, 1] —
    honored by the capacity discounts ONLY when
    ``serving.prefix_cache`` is actually enabled (a declared rate on a
    cache-less conf is a wish, not capacity)."""
    srv = getattr(model_cfg, "serving", None)
    fleet = getattr(model_cfg, "fleet", None)
    if (
        srv is None or srv.prefix_cache is None
        or not srv.prefix_cache.enabled
        or fleet is None or fleet.load is None
    ):
        return 0.0
    return min(1.0, max(0.0, fleet.load.prefix_hit_rate))


def serving_cost_rules(
    model_cfg: ModelConfig,
    cluster_cfg: ClusterConfig | None,
    widths: dict[str, int] | None,
    path: str,
    col: Collector,
) -> None:
    """SRV002 — SRV001's capacity sibling, config-only (no net build).

    (a) slots x block-budget admission feasibility: a declared
        ``kv_blocks`` pool that can hold fewer concurrent max-length
        sequences than the declared ``slots`` lanes — the engine
        backpressures admissions long before the decode batch fills, so
        the operator's declared concurrency is statically unreachable.
        Skipped when the window is not statically decidable (SRV001's
        convention).
    (b) full KV-pool byte sizing: the pool's modeled bytes alone exceed
        the cluster's declared ``device_hbm_bytes`` — a serving-only
        deployment OOMs at engine construction, before MEM001's
        training-footprint total even applies."""
    srv = model_cfg.serving
    if srv is None:
        return
    window = _declared_window(model_cfg)
    block_len = max(1, srv.kv_block_len)
    per_seq = window // block_len if window else 0
    hit = _declared_hit_rate(model_cfg)
    if srv.kv_blocks > 0 and per_seq > 0:
        # prefix-cache sharing discount: a hit admission SHARES its
        # cached prompt blocks instead of allocating fresh ones, so at
        # the declared fleet { load { prefix_hit_rate } } the expected
        # per-sequence block demand drops by hit_rate x the cacheable
        # prompt blocks. Without the declared rate (or with the cache
        # off) the undiscounted bound stands — sizing must not assume
        # wins the operator never promised
        shared = 0
        load = model_cfg.fleet.load if model_cfg.fleet else None
        if hit > 0 and load is not None and load.prompt_tokens > 0:
            shared = int(
                hit * (min(load.prompt_tokens, window) // block_len)
            )
        per_seq_eff = max(1, per_seq - shared)
        conc = (srv.kv_blocks - 1) // per_seq_eff  # minus the trash block
        if conc < srv.slots:
            col.emit(
                SRV002,
                path,
                f"serving kv_blocks {srv.kv_blocks} holds only {conc} "
                f"concurrent max-length sequence(s) ({per_seq_eff} "
                "blocks each"
                + (
                    f" after the prefix_hit_rate {hit:g} sharing "
                    f"discount of {shared} block(s)"
                    if shared
                    else ""
                )
                + " + the reserved trash block) but slots declares "
                f"{srv.slots} decode lanes: the declared concurrency is "
                "statically unreachable — admissions backpressure at "
                f"{conc} live sequence(s)",
                fix_hint=f"set kv_blocks >= "
                f"{srv.slots * per_seq_eff + 1} (dense-equivalent), "
                "lower slots, or enable prefix_cache to share blocks",
            )
    budget = cluster_cfg.device_hbm_bytes if cluster_cfg is not None else 0
    if budget > 0:
        notes: list[str] = []
        kv = kv_pool_bytes(model_cfg, widths or {}, notes)
        if kv > budget:
            col.emit(
                SRV002,
                path,
                f"serving KV pool alone needs {_fmt_bytes(kv)} per device "
                f"— over the declared device_hbm_bytes budget "
                f"({_fmt_bytes(budget)}): the engine OOMs at pool "
                "allocation",
                fix_hint="shrink kv_blocks/slots/max_len, shard heads "
                "over a wider model axis, or raise device_hbm_bytes",
            )


def fleet_cost_rules(
    model_cfg: ModelConfig,
    cluster_cfg: ClusterConfig | None,
    path: str,
    col: Collector,
) -> None:
    """FLT002 — per-role fleet sizing against the declared offered load
    (``fleet { load { ... } }``; FleetLoadConfig documents the capacity
    math). Host counts come from explicit peers entries, else the
    cluster's nworkers (run_from_conf's synthetic topology), else
    max_hosts; a topology whose host count the confs cannot see is
    skipped (FLT001's not-statically-decidable convention). Unified
    hosts count toward BOTH roles — an upper bound, since a real
    unified host splits its ticks between prefill and decode."""
    fleet = model_cfg.fleet
    if fleet is None or fleet.load is None:
        return
    load = fleet.load
    if load.requests_per_s <= 0 or load.ticks_per_s <= 0:
        return
    if fleet.peers:
        roles = [p.role for p in fleet.peers]
    else:
        n_hosts = (
            (cluster_cfg.nworkers if cluster_cfg is not None else 0)
            or fleet.max_hosts
        )
        if not n_hosts:
            return  # host count not statically decidable
        if fleet.role == "auto":
            np_hosts = min(n_hosts, max(1, fleet.prefill_hosts))
            roles = ["prefill"] * np_hosts + ["decode"] * (
                n_hosts - np_hosts
            )
        else:
            roles = [fleet.role] * n_hosts
    n_prefill = sum(1 for r in roles if r in ("prefill", "unified"))
    n_decode = sum(1 for r in roles if r in ("decode", "unified"))
    srv = model_cfg.serving
    slots = (
        srv.slots
        if srv is not None
        else schema.ServingConfig.FIELDS["slots"].default
    )
    chunk = (
        srv.max_prefill_chunk
        if srv is not None
        else schema.ServingConfig.FIELDS["max_prefill_chunk"].default
    )
    rps, ticks = load.requests_per_s, load.ticks_per_s
    hit = _declared_hit_rate(model_cfg)
    for role, n_hosts, per_tick, demand_tokens, knob in (
        ("decode", n_decode, slots, load.decode_tokens, "slots"),
        ("prefill", n_prefill, chunk, load.prompt_tokens,
         "max_prefill_chunk"),
    ):
        if demand_tokens <= 0:
            continue
        capacity = n_hosts * per_tick * ticks
        demand = rps * demand_tokens
        discounted = False
        if role == "prefill" and hit > 0:
            # prefix-cache discount: a hit admission skips the prefill
            # chunks its cached blocks cover, so at the declared
            # fleet { load { prefix_hit_rate } } only (1 - rate) of
            # the prompt tokens reach the prefill tier. Decode demand
            # is untouched — every token still decodes
            demand *= 1.0 - hit
            discounted = True
        if demand > capacity:
            col.emit(
                FLT002,
                path,
                f"fleet {role} capacity {capacity:.0f} tokens/s "
                f"({n_hosts} host(s) x {per_tick} {knob} x "
                f"{ticks:g} ticks/s) is below the offered load "
                f"{demand:.0f} tokens/s ({rps:g} req/s x "
                f"{demand_tokens} {role} tokens"
                + (
                    f" x (1 - prefix_hit_rate {hit:g})"
                    if discounted
                    else ""
                )
                + (
                    "; unified hosts counted toward both roles"
                    if "unified" in roles
                    else ""
                )
                + ")",
                fix_hint=f"add {role}-capable hosts, raise {knob}, or "
                "lower the declared load",
            )


def cost_rules(
    model_cfg: ModelConfig,
    cluster_cfg: ClusterConfig | None,
    widths: dict[str, int] | None,
    path: str,
    col: Collector,
    *,
    comm_fraction: float = DEFAULT_COMM_FRACTION,
) -> CostReport | None:
    """All four cost rules for one model conf; returns the CostReport
    (for ``--explain-cost``) or None when the net did not build —
    SRV002/FLT002's config-only arms run either way."""
    serving_cost_rules(model_cfg, cluster_cfg, widths, path, col)
    fleet_cost_rules(model_cfg, cluster_cfg, path, col)
    report = build_cost_model(model_cfg, widths, path)
    if report is None:
        return None
    if cluster_cfg is not None:
        report.inter_slice_bandwidth = cluster_cfg.inter_slice_bandwidth
    budget = cluster_cfg.device_hbm_bytes if cluster_cfg is not None else 0
    if budget > 0 and report.hbm_bytes > budget:
        parts = ", ".join(
            f"{label} {_fmt_bytes(b)}"
            for label, b in (
                ("params", report.param_bytes),
                ("opt slots", report.opt_bytes),
                ("residuals", report.residual_bytes),
                ("activations", report.act_bytes),
                ("KV pool", report.kv_bytes),
            )
            if b
        )
        col.emit(
            MEM001,
            path,
            f"predicted per-device footprint {_fmt_bytes(report.hbm_bytes)} "
            f"exceeds the declared device_hbm_bytes budget "
            f"({_fmt_bytes(budget)}): {parts}",
            fix_hint="shard wider (zero_update, model/expert axes), "
            "shrink the model/batch, or raise device_hbm_bytes",
        )
    # live weight rollout (serve/rollout.py): during the stage window
    # a host holds TWO resident param trees — the serving copy and the
    # staged next version — so a fleet whose steady-state footprint
    # fits can still OOM the moment a weight_ship lands. Only the
    # headroom arm fires here: a steady-state overflow is already
    # MEM001 above, and doubling down would be noise.
    ro = getattr(getattr(model_cfg, "fleet", None) or object(),
                 "rollout", None)
    if (
        ro is not None
        and (ro.version or ro.checkpoint or ro.canary)
        and budget > 0
        and report.hbm_bytes <= budget
        and report.hbm_bytes + report.param_bytes > budget
    ):
        from .net_rules import ROL001

        col.emit(
            ROL001,
            path,
            "live rollout stages a second resident param tree: "
            f"footprint {_fmt_bytes(report.hbm_bytes)} + staged params "
            f"{_fmt_bytes(report.param_bytes)} = "
            f"{_fmt_bytes(report.hbm_bytes + report.param_bytes)} "
            f"exceeds device_hbm_bytes ({_fmt_bytes(budget)}) during "
            "the stage window — the hot-swap would OOM a host that "
            "serves fine at steady state",
            fix_hint="free HBM headroom >= one param tree (shrink the "
            "KV pool / model, or raise device_hbm_bytes)",
        )
    if (
        comm_fraction > 0
        and report.compute_bytes > 0
        and report.collective_bytes
        > comm_fraction * report.compute_bytes
    ):
        ratio = report.collective_bytes / report.compute_bytes
        col.emit(
            COST001,
            path,
            f"modeled collective bytes {_fmt_bytes(report.collective_bytes)}"
            f"/step are {ratio:.2f}x the modeled compute bytes "
            f"{_fmt_bytes(report.compute_bytes)} (budget "
            f"{comm_fraction:g}): the step is communication-bound on "
            "paper before it ever runs",
            fix_hint="quantize the wire (grad_comm int8 + quantized_ring),"
            " grow the per-device batch, or narrow the data axis",
        )
    return report


# ---------------------------------------------------------------------------
# --explain-cost rendering
# ---------------------------------------------------------------------------


def render_cost_report(report: CostReport) -> str:
    """The ``--explain-cost`` table: per-component HBM bytes, per-param-
    group bytes, per-collective bytes, and the pipeline bubble."""
    w = report.widths
    axes = " ".join(
        f"{a}={w[a]}" for a in ("data", "model", "expert", "pipe", "seq")
        if w.get(a, 1) > 1
    ) or "single-device"
    lines = [f"cost model: {report.path} ({axes})"]
    lines.append("  HBM (bytes/device)")
    for label, b in (
        ("params (fp32 masters)", report.param_bytes),
        ("optimizer slots", report.opt_bytes),
        ("error-feedback residuals", report.residual_bytes),
        ("activations / microbatch", report.act_bytes),
        ("serving KV pool", report.kv_bytes),
    ):
        lines.append(f"    {label:<28} {b:>14}  {_fmt_bytes(b)}")
    lines.append(
        f"    {'total':<28} {report.hbm_bytes:>14}  "
        f"{_fmt_bytes(report.hbm_bytes)}"
    )
    if report.param_groups:
        lines.append("  param groups (params+slots+residuals, bytes/device)")
        for layer, n, b in report.param_groups:
            lines.append(
                f"    {layer:<28} {b:>14}  {_fmt_bytes(b)} "
                f"({n} param(s))"
            )
    lines.append("  collectives (bytes/device/step)")
    if report.collectives:
        for label, b in report.collectives:
            lines.append(f"    {label:<28} {b:>14}  {_fmt_bytes(b)}")
    else:
        lines.append("    (none: single-device step)")
    inter = sum(
        b for label, b in report.collectives if "inter-slice" in label
    )
    if report.inter_slice_bandwidth > 0 and inter:
        secs = inter / report.inter_slice_bandwidth
        lines.append(
            f"  inter-slice transfer/step    {secs * 1e3:>13.3f}ms  "
            f"({_fmt_bytes(inter)} at "
            f"{_fmt_bytes(report.inter_slice_bandwidth)}/s "
            "inter_slice_bandwidth)"
        )
    lines.append(
        f"  compute bytes/step (proxy)     {report.compute_bytes:>14}  "
        f"{_fmt_bytes(report.compute_bytes)}"
    )
    lines.append(
        f"  pipeline bubble                {report.bubble * 100:>13.1f}%  "
        f"(stages={report.stages}, microbatches={report.nmicro})"
    )
    for note in report.notes:
        lines.append(f"  note: {note}")
    return "\n".join(lines)
