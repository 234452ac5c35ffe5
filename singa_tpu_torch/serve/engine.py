"""Serving engine: fixed-shape prefill/decode/verify over a slot-batched
state, the PyTorch counterpart of ``singa_tpu/serve/engine.py``.

Device state is per-slot token/position/liveness lanes, per-slot block
tables (int32) and the per-layer paged K/V pools
``(n_blocks, heads, block_len, head_dim)``. Three programs touch it:

  decode   every live slot advances one token: embed the slots' last
           tokens, run each block against the pool (write the new K/V
           into each slot's current block, attend), sample per slot.
           Dead slots ride along masked; their writes go to the trash
           block 0.
  prefill  a fixed (1, max_prefill_chunk) chunk of one slot's prompt
           through the same block body; padding positions write to the
           trash block and are masked out of every softmax.
  verify   the speculative tick (spec_k > 0): every live slot's current
           token plus its drafted candidates, (slots, k+1) positions in
           one pass. Greedy acceptance takes the longest draft prefix
           matching the model's own argmax plus one bonus token; the
           pool is written only after acceptance, and only at the
           positions sequential decode would have written (KV rewind by
           construction).

All three run ``_block_apply``/``lm_head`` from models/transformer.py,
the same body as ``generate``.

Where JAX donated the state to a jitted program and got new arrays back,
this engine updates the pools and lanes IN PLACE (``index_put_``,
``copy_``): the pools are the largest tensors of a server and are never
copied, and the lanes keep their addresses.

Dispatch: where JAX jits ``decode`` and ``prefill`` once each, here each
is a body over static tensors run through ``utils.graphs.Graphed``: on
the card the first call runs eagerly and the second captures a CUDA
graph that every later call replays (one graph for every prefill
chunk: the slot, start position, valid length and tokens go up as one
static int64 block); on the CPU, or with ``graphs=False``, the body is
called. Decode's graph writes the logits and each lane's greedy next
token; a temperature slot's draw runs after the replay on those
logits, with the slot's own generator. ``verify`` runs eagerly.

ATTENTION is the ``attend_impl`` knob, with the JAX package's names:
``"fused"`` (the default) runs the CUDA paged-attention kernel
(ops/paged_attention.py), which reads K/V blocks in place through the
block table; ``"reference"`` gathers a dense (S, H, cache_len, D) view
per layer and runs ``cache_attend``, the stream oracle. On the CPU the
fused path runs the kernel's plain PyTorch version.

Sampling: greedy argmax for temperature 0; a slot with temperature > 0
samples from its own ``torch.Generator``, seeded with the request's seed
at activation, one draw per emitted token. A stream is therefore a
function of its seed alone (not of what shares the batch), but it is
not the JAX package's stream: JAX's threefry keys give other numbers.

Index discipline: JAX clamps out-of-range gathers and drops
out-of-range scatters; PyTorch raises (CPU) or asserts (CUDA). Every
index here is clamped explicitly. Tables and positions are int32, as in
JAX and as the kernel reads them.

PREFIX CACHE (``prefix_cache``): the allocator is content-addressed and
refcounted (kv_pool.py, a copy of the JAX package's). ``admit`` with the
prompt shares its longest cached block-prefix, COW-extends a registered
partial tail, and copies the last matched block on a whole-prompt hit
(copy-on-write) so the one-token re-derivation chunk writes only a
private block. Slots move between engines as one host payload
(``export_slot``/``import_slot``, serve/fleet/migrate.py frames it),
cached blocks ship without a slot (``export_blocks``/
``install_prefix``), and a next weight version is staged beside the
live one (``stage_params``/``flip_params``/``rollback_params``).

Every one of these writes the pools, lanes and params IN PLACE
(``copy_``, ``index_copy_``): the decode and prefill graphs captured
the tensors' addresses, so a rebound tensor would leave them replaying
the old bytes without an error. The engine therefore owns its params
(copied at construction), and a flip swaps the staged tree's bytes
into the live tensors.

MESH (``Engine(mesh=...)``, a :class:`parallel.mesh.Mesh`): the serving
analog of kLayerPartition, as the JAX engine lays it. The params take
the code-API LM's tensor-parallel layout over the model axis
(``models/transformer.lm_param_shardings``; each model rank keeps its
own copies of its pieces, refreshed in place by every flip), and every
program runs ``_block_apply_tp``. Each model rank owns its own
contiguous K/V pools of its ``n_heads / M`` heads and the paged kernel
runs once per rank over them; where M does not divide the heads the
pools replicate (each rank holds every head) with the JAX package's
warning. The block tables, positions, slot lanes and the block
allocator are one, shared by every rank (block ids are a namespace
every rank resolves). An exported slot or block set gathers the heads in
rank order, so a mesh engine and a plain one exchange them. The data
axis replicates the engine in the JAX package; here the ranks of data
index 0 run it. Decode and prefill are captured over every rank when the
ranks share one device; ranks on several devices run eager, the reason
logged.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..device import resolve_device
from ..models.transformer import (
    TransformerConfig,
    _block_apply,
    _block_apply_tp,
    cache_attend,
    decode_capacity,
    lm_head,
    lm_param_shardings,
    split_lm_params,
)
from ..ops.paged_attention import (
    _gather,
    fusable,
    paged_attention,
    paged_attention_overlay,
)
from ..utils.graphs import Graphed
from .kv_pool import BlockAllocator, KVPool, PoolExhausted


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving-plane knobs (the ``serving`` model-conf block)."""

    slots: int = 8
    kv_block_len: int = 16
    kv_blocks: int = 0          # 0 = dense-equivalent sizing (see KVPool)
    max_prefill_chunk: int = 64
    #: draft tokens per live greedy slot per speculative tick; 0 = one-
    #: token decode ticks
    spec_k: int = 0
    #: drafter name (serve/speculate.py DRAFTERS)
    spec_drafter: str = "ngram"
    #: ``prefix_cache { enabled }``: content-addressed, refcounted block
    #: sharing; admissions reuse cached full-block prompt prefixes
    prefix_cache: bool = False
    #: keep refcount-0 cached blocks on an LRU list (reclaimed lazily)
    #: instead of freeing them at retirement
    prefix_lru: bool = True
    #: ``prefix_cache { tail_stride }``: > 0 indexes each prompt's last
    #: partial block at this token stride, so a prompt whose shared
    #: prefix ends mid-block COW-extends the deepest partial match; must
    #: divide kv_block_len. 0 = full blocks only
    prefix_tail_stride: int = 0
    #: ``prefix_cache { decode_blocks }``: register full decode-written
    #: blocks at retirement, so multi-turn traffic hits its own history
    #: (warm streams over them are token-identical to cold, not bitwise)
    prefix_decode_blocks: bool = False
    #: ``prefix_cache { fetch_timeout_s }``: how long a fleet host holds a
    #: request awaiting a peer's cache_ship before plain prefill
    prefix_fetch_timeout_s: float = 2.0
    #: "fused" = the CUDA paged-attention kernel (plain version on the
    #: CPU); "reference" = gather + cache_attend, the stream oracle
    attend_impl: str = "fused"

    @classmethod
    def from_conf(cls, serving, kernels=None) -> "EngineConfig":
        """From parsed ``serving { ... }`` / ``kernels { ... }`` blocks
        (config/schema.py; None = defaults). ``kernels``'
        ``paged_attention`` picks ``attend_impl``; without the block the
        port's default (the kernel) holds."""
        kw = {} if kernels is None else {
            "attend_impl": kernels.paged_attention
        }
        if serving is None:
            return cls(**kw)
        spec, pc = serving.speculate, serving.prefix_cache
        if spec is not None:
            kw.update(spec_k=spec.k, spec_drafter=spec.drafter)
        if pc is not None:
            kw.update(
                prefix_cache=pc.enabled, prefix_lru=pc.lru,
                prefix_tail_stride=pc.tail_stride,
                prefix_decode_blocks=pc.decode_blocks,
                prefix_fetch_timeout_s=pc.fetch_timeout_s,
            )
        return cls(
            slots=serving.slots, kv_block_len=serving.kv_block_len,
            kv_blocks=serving.kv_blocks,
            max_prefill_chunk=serving.max_prefill_chunk, **kw,
        )


@dataclasses.dataclass(frozen=True)
class Admission:
    """What admit() did for one request: the sequence's block list
    (shared prefix blocks first), how many prompt tokens the prefix
    cache covered, where prefill must start (``cached_tokens`` except on
    a whole-prompt hit, where the last token re-runs through a COW'd
    block to re-derive the activation logits), and whether a
    copy-on-write happened."""

    blocks: list
    cached_tokens: int = 0
    prefill_from: int = 0
    cow_copied: bool = False
    #: tokens of ``cached_tokens`` served by COW-extending a registered
    #: partial tail; 0 = the hit ended on a block boundary
    tail_tokens: int = 0


class Engine:
    """Slot-batched continuous-decode engine for the code-API LM."""

    def __init__(self, params: dict, cfg: TransformerConfig,
                 serving: EngineConfig | None = None, *, device=None,
                 mesh=None, temperature: float = 0.0, graphs: bool = True):
        self.cfg = cfg
        self.serving = serving or EngineConfig()
        self.temperature = float(temperature)
        #: each model rank's device (one, without a mesh)
        self._devices = self._rank_devices(mesh, device)
        nmodel = len(self._devices)
        if nmodel > 1 and cfg.n_heads % nmodel:
            warnings.warn(
                f"serving: n_heads {cfg.n_heads} not divisible by the "
                f"model axis ({nmodel}); KV pools fall back to replication",
                stacklevel=2,
            )
        #: the heads each rank's pools hold
        self._rank_heads = (cfg.n_heads // nmodel
                            if cfg.n_heads % nmodel == 0 else cfg.n_heads)
        if self.serving.attend_impl not in ("reference", "fused"):
            raise ValueError(
                f"kernels.paged_attention must be 'reference' or "
                f"'fused', got {self.serving.attend_impl!r}"
            )
        self._fused = self.serving.attend_impl == "fused"
        #: MoE routing at capacity E on every program: drop-free, so a
        #: slot's tokens never depend on what shares the batch
        self._moe_cf = decode_capacity(cfg)
        self.device = self._devices[0]
        if self._fused and self.device.type == "cuda":
            # the kernel's geometry limits (the plain CPU version has none)
            reason = fusable(self.serving.kv_block_len, cfg.head_dim)
            if reason is not None:
                raise ValueError(
                    f"kernels {{ paged_attention: fused }}: {reason}"
                )
        self.pool = KVPool.for_model(
            cfg.max_len, self.serving.kv_block_len,
            self.serving.kv_blocks, self.serving.slots,
        )
        self.allocator = BlockAllocator(
            self.pool,
            prefix_cache=self.serving.prefix_cache,
            lru=self.serving.prefix_lru,
            tail_stride=self.serving.prefix_tail_stride,
        )
        #: the engine's own copy: flip_params writes into these tensors,
        #: which the captured graphs read, so they must not be the
        #: caller's
        self.params = {k: v.detach().to(self.device, copy=True)
                       for k, v in params.items()}
        #: the tensor-parallel layout (no split param without a mesh)
        #: and each model rank's own copies of its pieces
        self._layout = lm_param_shardings(nmodel, self.params)
        self._pieces = split_lm_params(self.params, self._layout,
                                       self._devices)
        #: version tag of the live params; a staged next version waits
        #: beside them until flip_params, and the previous one stays
        #: pinned for rollback_params
        self.params_version = 0
        self._staged: tuple[int, dict] | None = None
        self._prev: tuple[int, dict] | None = None
        #: params version each slot was admitted or imported under: its
        #: K/V bytes belong to those weights, so registering them in the
        #: prefix index is gated on that version still being live
        self._slot_version: dict[int, int] = {}
        #: the admission-time digest chain per slot (register_prefix
        #: reuses it: one hashing pass per request)
        self._slot_chain: dict[int, list[bytes]] = {}
        s, mb = self.serving.slots, self.pool.max_blocks_per_seq
        shape = (
            self.pool.n_blocks, self._rank_heads,
            self.pool.block_len, cfg.head_dim,
        )
        dev, dtype = self.device, self.params["embed/tok"].dtype
        #: each model rank's own K and V pools, one per layer, on its device
        self._pools = [
            {kv: [torch.zeros(shape, dtype=dtype, device=d)
                  for _ in range(cfg.n_layers)] for kv in ("k", "v")}
            for d in self._devices]
        self.state = {
            "tokens": torch.zeros(s, dtype=torch.int64, device=dev),
            "pos": torch.zeros(s, dtype=torch.int32, device=dev),
            "live": torch.zeros(s, dtype=torch.bool, device=dev),
            "tables": torch.zeros((s, mb), dtype=torch.int32, device=dev),
        }
        #: per-slot sampling streams, seeded at activation
        self._gens = [torch.Generator(device=dev) for _ in range(s)]
        #: slot -> temperature, for live slots that sample (host mirror of
        #: the JAX temperature lane: greedy slots are not in it)
        self._sampling: dict[int, float] = {}
        #: blocks owned per slot, freed at retire
        self._slot_blocks: dict[int, list[int]] = {}
        # --- the programs' static tensors and their graphs ---
        c = self.serving.max_prefill_chunk
        #: decode's logits (slots, vocab), the temperature draws' input
        self._dec_logits = torch.zeros((s, cfg.vocab), dtype=dtype,
                                       device=dev)
        #: prefill's [slot, pos0, n_valid, chunk tokens...] and its host
        #: mirror, uploaded in one copy per chunk
        self._pf_host = np.zeros((3 + c,), np.int64)
        self._pf_args = torch.zeros((3 + c,), dtype=torch.int64, device=dev)
        self._pf_ar = torch.arange(c, device=dev)
        #: prefill's logits at the chunk's last valid position
        self._pf_out = torch.zeros((cfg.vocab,), dtype=dtype, device=dev)
        #: why decode and prefill run eager ("" when they may be graphs)
        self.dispatch_reason = ""
        if len(set(self._devices)) > 1:
            self.dispatch_reason = (
                f"the mesh's {nmodel} model ranks on "
                f"{len(set(self._devices))} devices: one CUDA graph "
                "cannot hold them")
            print(f"engine dispatch: eager ({self.dispatch_reason})")
        graphs = graphs and not self.dispatch_reason
        self._decode_graph = Graphed(self._decode, dev, enabled=graphs)
        self._prefill_graph = Graphed(self._prefill, dev, enabled=graphs)

    @staticmethod
    def _rank_devices(mesh, device) -> list:
        """The model ranks' devices: the mesh's data-index-0 ranks', in
        model order, or ``device`` alone without a mesh."""
        if mesh is None:
            return [resolve_device(device)]
        from ..parallel.mesh import Mesh, _device

        if not isinstance(mesh, Mesh):
            raise TypeError(
                "Engine(mesh=...) takes a singa_tpu_torch.parallel Mesh "
                f"(build_mesh), not {type(mesh).__name__}")
        if mesh.nprocs > 1:
            raise ValueError(
                f"Engine(mesh=...) over {mesh.nprocs} processes: the "
                "serving engine runs its mesh in one process")
        devices = [mesh.device(mesh.rank(model=m))
                   for m in range(mesh.widths["model"])]
        if device is not None and _device(device) != devices[0]:
            raise ValueError(
                f"Engine(device={device!r}, mesh=...): the mesh's first "
                f"rank is on {devices[0]}")
        return devices

    def _block(self, p, x, attend):
        """One block of the live params -> (x', [each rank's extra]):
        ``_block_apply`` without a mesh, ``_block_apply_tp`` over the
        model ranks' pieces on one. ``attend(m, q, k, v)`` is rank m's
        attention over its heads and its pools."""
        if len(self._devices) == 1:
            x, _, extra = _block_apply(
                self.params, p, x, lambda q, k, v: attend(0, q, k, v),
                self.cfg, moe_capacity_factor=self._moe_cf)
            return x, [extra]
        x, _, extras = _block_apply_tp(
            self.params, self._pieces, self._layout, p, x, attend, self.cfg,
            moe_capacity_factor=self._moe_cf)
        return x, extras

    # ------------------------------------------------------------------
    # the programs
    # ------------------------------------------------------------------

    def _gather(self, pool_arr, tables):
        """(NB, H, BL, D) pool + (S', MB) tables -> (S', H, CL, D) dense
        per-sequence cache views (CL = MB * BL, the dense cache_len)."""
        return _gather(pool_arr, tables)

    def _gather_kv(self, kp, vp, tables):
        """Both dense views of one layer's K and V pools."""
        return self._gather(kp, tables), self._gather(vp, tables)

    def _paged_attend(self, q, kp, vp, tables, positions):
        """The fused path's write-then-read attend (decode + prefill):
        the fresh K/V are already in ``kp``/``vp``; the kernel reads
        blocks in place through ``tables``."""
        return paged_attention(
            q.contiguous(), kp, vp, tables.contiguous(),
            positions.to(torch.int32).contiguous(),
        )

    def _sample(self, logits, live, prev):
        """Per-slot next token: argmax for greedy slots (the generate()
        decision rule), one draw from the slot's own generator for
        sampling slots; dead slots keep ``prev``."""
        nxt = logits.argmax(-1)
        for slot, temp in self._sampling.items():
            probs = (logits[slot] / temp).softmax(-1)
            nxt[slot] = torch.multinomial(
                probs, 1, generator=self._gens[slot]
            )[0]
        return torch.where(live, nxt, prev)

    def _write(self, i, bid, off, k, v, m=0):
        """Scatter fresh K/V (index shape + (H, D), rank ``m``'s heads)
        into rank m's layer-``i`` pools IN PLACE at (block ``bid``,
        offset ``off``). Padding, dead and rejected lanes all target the
        trash block 0, so indices may repeat; ``index_put_`` then writes
        them in an undefined order, which is harmless: only trash bytes
        collide, and every attend masks them."""
        kp, vp = self._pools[m]["k"][i], self._pools[m]["v"][i]
        bid, off = bid.to(kp.device), off.to(kp.device)
        kp[bid, :, off] = k.to(kp.device)
        vp[bid, :, off] = v.to(kp.device)

    def _embed(self, tokens, positions):
        """Token + position embeddings; positions past max_len (dead or
        padding lanes, whose outputs are never read) are clamped."""
        p = self.params
        safe = positions.long().clamp(0, self.cfg.max_len - 1)
        return p["embed/tok"][tokens.long()] + p["embed/pos"][safe]

    def _block_of(self, tables, positions):
        """``positions`` (S', Q) through ``tables`` (S', MB) -> (pool
        block id, in-block offset) of each position; positions and table
        rows are clamped into range (only dead or padding lanes reach
        past them, and those write to the trash block)."""
        bl, mb = self.pool.block_len, self.pool.max_blocks_per_seq
        safe = positions.long().clamp(0, self.cfg.max_len - 1)
        row = (safe // bl).clamp(max=mb - 1)
        return tables.gather(1, row).long(), safe % bl

    @torch.no_grad()
    def _decode(self):
        """One decode tick over the static lanes: writes each live
        slot's K/V, attends, and leaves the logits in ``_dec_logits``,
        each live lane's greedy next token in ``tokens`` and its
        position advanced (dead lanes keep theirs)."""
        st = self.state
        tokens, pos, live, tables = (
            st["tokens"], st["pos"], st["live"], st["tables"]
        )
        x = self._embed(tokens, pos)[:, None, :]
        bid, off = self._block_of(tables, pos[:, None])
        # dead lanes route to the trash block: a slot still prefilling has
        # a real table whose first block its stale lane must not clobber
        bid = torch.where(live, bid[:, 0], 0)
        off = off[:, 0]
        # the kernel reads no block for a dead row at position -1 (and
        # emits 0, which nothing reads): a retired slot keeps its stale
        # position, which would otherwise walk that many trash-block keys
        pos_attend = torch.where(live, pos, -1)[:, None]

        def mk_attend(i):
            def attend(m, q, k, v):
                self._write(i, bid, off, k[:, :, 0], v[:, :, 0], m)
                kp, vp = self._pools[m]["k"][i], self._pools[m]["v"][i]
                tab = tables.to(kp.device)
                if self._fused:
                    o = self._paged_attend(q, kp, vp, tab,
                                           pos_attend.to(kp.device))
                else:
                    o = cache_attend(
                        q, *self._gather_kv(kp, vp, tab),
                        pos[:, None].to(kp.device)
                    )
                return o, None
            return attend

        for i in range(self.cfg.n_layers):
            x, _ = self._block(f"blk{i}", x, mk_attend(i))
        logits = lm_head(self.params, x)[:, 0]
        self._dec_logits.copy_(logits)
        tokens.copy_(torch.where(live, logits.argmax(-1), tokens))
        pos.add_(live.to(torch.int32))

    @torch.no_grad()
    def _prefill(self):
        """One (1, C) prompt chunk from the static args block [slot, pos0,
        n_valid, tokens]: writes the chunk's K/V into the slot's blocks
        at absolute positions [pos0, pos0 + C) (padding positions to the
        trash block) and leaves the logits at the last valid position in
        ``_pf_out``."""
        args = self._pf_args
        slot, pos0, n_valid, chunk = args[0], args[1], args[2], args[3:]
        ar = self._pf_ar
        p = pos0 + ar
        valid = ar < n_valid
        x = self._embed(chunk, p)[None]
        row = self.state["tables"].index_select(0, slot.view(1))  # (1, MB)
        bid, off = self._block_of(row, p[None])
        bid = torch.where(valid, bid[0], 0)
        off = off[0]

        def mk_attend(i):
            def attend(m, q, k, v):
                self._write(
                    i, bid, off, k[0].transpose(0, 1), v[0].transpose(0, 1),
                    m
                )
                kp, vp = self._pools[m]["k"][i], self._pools[m]["v"][i]
                tab, pm = row.to(kp.device), p[None].to(kp.device)
                if self._fused:
                    o = self._paged_attend(q, kp, vp, tab, pm)
                else:
                    o = cache_attend(q, *self._gather_kv(kp, vp, tab), pm)
                return o, None
            return attend

        for i in range(self.cfg.n_layers):
            x, _ = self._block(f"blk{i}", x, mk_attend(i))
        logits = lm_head(self.params, x)[0]
        last = (n_valid - 1).clamp(min=0).view(1)
        self._pf_out.copy_(logits.index_select(0, last)[0])

    @torch.no_grad()
    def _verify(self, draft, n_draft):
        """The speculative tick: score every live slot's current token
        plus its drafted candidates, (S, K+1) positions, in one forward.

        t_0 = the slot's current token at position pos, t_1..t_K =
        ``draft`` at pos+1..pos+K (``n_draft`` gates how many are real;
        the rest ride masked). Query j's logits predict position pos+j+1
        given the draft prefix, so greedy acceptance is the longest draft
        prefix matching the model's own argmax, plus the bonus token at
        the first mismatch: exactly what one-token ticks would emit.

        The pool is not written before acceptance is known: attention
        sees the chunk's fresh K/V overlaid (the kernel's overlay form,
        or the dense gathered view with the chunk scattered over it on
        the reference path), then ONE masked scatter writes the accepted
        positions and routes everything else to the trash block.
        -> (emitted (S, K+1), -1 beyond each accepted run and on dead
        slots; accepted (S,) draft-token counts)."""
        st = self.state
        tokens, pos, live, tables = (
            st["tokens"], st["pos"], st["live"], st["tables"]
        )
        s, kd = draft.shape
        nq = kd + 1
        seq = torch.cat([tokens[:, None], draft], dim=1)        # (S, Q)
        j = torch.arange(nq, device=self.device)[None, :]
        p = pos[:, None].long() + j                              # (S, Q)
        valid = live[:, None] & (j <= n_draft[:, None])
        x = self._embed(seq, p)
        bid, off = self._block_of(tables, p)
        bid = torch.where(valid, bid, 0)
        # clamped column of the reference overlay: only positions past
        # max_len - 1 (invalid lanes: a valid draft never reaches past
        # max_len - 2, the scheduler clamps drafts to the budget) collide
        p_col = p.clamp(max=self.cfg.max_len - 1)
        s_idx = torch.arange(s, device=self.device)[:, None]
        # dead rows at position -1 read no pool block (as in _decode)
        p32 = torch.where(live[:, None], p, -1).to(torch.int32)
        fresh = []

        def mk_attend(i):
            def attend(m, qh, kh, vh):
                kp, vp = self._pools[m]["k"][i], self._pools[m]["v"][i]
                d = kp.device
                tab = tables.to(d)
                if self._fused:
                    # the overlay form IS the rewind contract at every
                    # draft width: the pool is never written here
                    o = paged_attention_overlay(
                        qh.contiguous(), kp, vp, tab, p32.to(d),
                        kh.contiguous(), vh.contiguous(), valid.to(d),
                    )
                    return o, (kh, vh)
                if kd == 0:
                    # zero draft width: nothing can be rejected, so write
                    # then gather like the decode tick
                    self._write(
                        i, bid, off, kh.transpose(1, 2), vh.transpose(1, 2),
                        m
                    )
                    o = cache_attend(qh, *self._gather_kv(kp, vp, tab),
                                     p.to(d))
                    return o, None
                dk, dv = self._gather_kv(kp, vp, tab)
                dk[s_idx.to(d), :, p_col.to(d)] = kh.transpose(1, 2)
                dv[s_idx.to(d), :, p_col.to(d)] = vh.transpose(1, 2)
                return cache_attend(qh, dk, dv, p.to(d)), (kh, vh)
            return attend

        for i in range(self.cfg.n_layers):
            x, extras = self._block(f"blk{i}", x, mk_attend(i))
            fresh.append(extras)
        logits = lm_head(self.params, x)                         # (S, Q, V)
        greedy = logits.argmax(-1)
        # position 0 samples through the slot's own stream (temperature
        # slots ride with n_draft == 0); positions >= 1 are greedy-only
        first = self._sample(logits[:, 0], live, tokens)
        g = torch.cat([first[:, None], greedy[:, 1:]], dim=1)
        match = (draft == g[:, :kd]) & (
            torch.arange(kd, device=self.device)[None, :] < n_draft[:, None]
        )
        acc = match.to(torch.int64).cumprod(dim=1).sum(dim=1)
        emit_mask = live[:, None] & (j <= acc[:, None])
        emitted = torch.where(emit_mask, g, -1)
        last_tok = g.gather(1, acc[:, None])[:, 0]
        if self._fused or kd > 0:
            # the rewind-by-construction scatter: only positions sequential
            # decode would have written land in real blocks
            bid_keep = torch.where(emit_mask, bid, 0)
            for i, extras in enumerate(fresh):
                for m, (kh, vh) in enumerate(extras):
                    self._write(i, bid_keep, off, kh.transpose(1, 2),
                                vh.transpose(1, 2), m)
        # in place: the lanes keep the addresses decode's graph reads
        tokens.copy_(torch.where(live, last_tok, tokens))
        pos.add_(torch.where(live, acc + 1, 0).to(torch.int32))
        return emitted, torch.where(live, acc, 0)

    # ------------------------------------------------------------------
    # admission-path API
    # ------------------------------------------------------------------

    def admit(self, slot: int, n_total_tokens: int,
              prompt=None) -> Admission:
        """Allocate ``blocks_for(n_total_tokens)`` blocks to ``slot`` and
        install its block table (raises PoolExhausted with nothing
        touched: admission backpressure). The slot stays dead until
        activate().

        With the prefix cache on and a ``prompt`` given, the prompt's
        longest cached block-prefix is SHARED instead of allocated
        (matched blocks retained, LRU blocks revived) and only the rest
        draws fresh blocks. Feasibility is checked before any state is
        touched, so a backpressured admission is a true no-op (free list,
        LRU order, index and statistics untouched). A hit covering the
        whole prompt still needs the last position's logits: the last
        matched block is copied into a fresh one (copy-on-write) and
        ``prefill_from`` points at the last prompt token, whose one-token
        chunk writes into the private copy only. With ``tail_stride``, a
        hit whose shared tokens end mid-block copies the deepest
        registered partial tail into this sequence's next block and
        prefill starts past the covered tokens."""
        needed = self.pool.blocks_for(n_total_tokens)
        alloc = self.allocator
        hit: list[int] = []
        chain: list[bytes] = []
        if alloc.cache is not None and prompt is not None:
            # one digest pass per admission: the same chain serves the
            # match here and register_prefix() after prefill
            chain = alloc.cache.chain(prompt)
            hit = alloc.cache.match_chain(chain)
        cached = len(hit) * self.pool.block_len
        cow = bool(hit) and cached >= len(prompt)
        tail_src = tail_tokens = 0
        if (not cow and prompt is not None and alloc.cache is not None
                and alloc.cache.tail_stride):
            tail_src, tail_tokens = alloc.cache.match_tail(
                prompt, len(hit), chain
            )
            cached += tail_tokens
        fresh_n = needed - len(hit) + (1 if cow else 0)
        protect = hit + ([tail_src] if tail_tokens else [])
        if fresh_n > alloc.headroom_excluding(protect):
            raise PoolExhausted(
                f"need {fresh_n} fresh blocks beyond a {len(hit)}-block "
                f"prefix hit, {alloc.headroom_excluding(protect)} "
                "allocatable"
            )
        if hit:
            alloc.retain(hit)
        if tail_tokens:
            # pin the tail source across alloc(): a fresh allocation may
            # otherwise LRU-reclaim the very block about to be copied
            alloc.retain([tail_src])
        fresh = alloc.alloc(fresh_n)
        if cow:
            # the whole prompt is cached: the last matched block is copied
            # so the re-derivation chunk writes a private block
            blocks = hit[:-1] + fresh
            self._copy_block(hit[-1], fresh[0])
            alloc.release([hit[-1]])
        elif tail_tokens:
            # bytes past the covered tokens are re-prefilled or masked
            blocks = hit + fresh
            self._copy_block(tail_src, fresh[0])
            alloc.release([tail_src])
        else:
            blocks = hit + fresh
        self._install_table(slot, blocks)
        st = self.state
        st["pos"][slot] = 0
        st["live"][slot] = False
        self._slot_blocks[slot] = blocks
        self._slot_chain[slot] = chain
        self._slot_version[slot] = self.params_version
        return Admission(
            blocks=blocks,
            cached_tokens=cached,
            prefill_from=min(cached, max(len(prompt), 1) - 1)
            if prompt is not None else 0,
            cow_copied=cow,
            tail_tokens=tail_tokens,
        )

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write: block ``src``'s K/V into block ``dst`` in every
        layer of every rank, in place (the source stays shared)."""
        for pools in self._pools:
            for pool in pools["k"] + pools["v"]:
                pool[dst].copy_(pool[src])

    def _install_table(self, slot: int, blocks: list[int]) -> None:
        """Write ``slot``'s block-table row in place (trash block 0
        beyond its allocation)."""
        row = np.zeros((self.pool.max_blocks_per_seq,), np.int32)
        row[: len(blocks)] = blocks
        self.state["tables"][slot] = torch.from_numpy(row).to(self.device)

    def register_prefix(self, slot: int, prompt) -> int:
        """Index ``slot``'s fully prompt-covered blocks by their chained
        content digests, once the prompt is completely prefilled (every
        registered position is prefill-written, so a later hit's bytes
        are a cold prefill's). Digests already present are skipped; new
        entries link to their parent digest. With ``tail_stride``, the
        prompt's last partial block registers at every covered stride.
        Skipped for a slot admitted under a since-replaced params
        version. -> newly registered blocks."""
        cache = self.allocator.cache
        if cache is None or not self._version_live(slot):
            return 0
        blocks = self._slot_blocks.get(slot)
        if not blocks:
            return 0
        chain = self._slot_chain.get(slot) or cache.chain(prompt)
        new = self._register_chain(chain, blocks)
        nb = len(chain)
        if cache.tail_stride and len(blocks) > nb:
            cache.register_tail(prompt, blocks[nb])
        return new

    def register_history(self, slot: int, tokens) -> int:
        """Index ``slot``'s full blocks under the chained digests of
        ``tokens`` (the prompt and the emitted history), at retirement
        with ``prefix_decode_blocks``, so a follow-up turn replaying this
        conversation hits the decode-written blocks too. Only blocks
        whose every position was written register: the last emitted
        token's K/V never is, so the chain stops at ``len(tokens) - 1``
        positions. -> newly registered blocks."""
        cache = self.allocator.cache
        if cache is None or not self._version_live(slot):
            return 0
        blocks = self._slot_blocks.get(slot)
        if not blocks:
            return 0
        safe = (len(tokens) - 1) // self.pool.block_len
        return self._register_chain(cache.chain(tokens)[:safe], blocks)

    def _version_live(self, slot: int) -> bool:
        """Whether ``slot``'s bytes were written under the live params
        (a flip mid-flight makes them another version's)."""
        return self._slot_version.get(slot, self.params_version) \
            == self.params_version

    def _register_chain(self, chain: list[bytes], blocks: list[int]) -> int:
        """Register ``blocks[i]`` under ``chain[i]`` where the digest is
        new, each linked to its parent. -> blocks registered."""
        cache = self.allocator.cache
        new = 0
        for i, digest in enumerate(chain[: len(blocks)]):
            if not cache.has(digest):
                new += cache.register(
                    digest, blocks[i], parent=chain[i - 1] if i else None,
                )
        return new

    def prefill_chunk(self, slot: int, tokens: np.ndarray, pos0: int):
        """Run one prompt chunk (<= max_prefill_chunk tokens) for
        ``slot``; returns the logits (vocab,) at the chunk's last valid
        position (meaningful only for the final chunk)."""
        c = self.serving.max_prefill_chunk
        n = len(tokens)
        if n > c:
            raise ValueError(f"prefill chunk {n} > max_prefill_chunk {c}")
        h = self._pf_host
        h[:3] = (slot, pos0, n)
        h[3:3 + n] = tokens
        h[3 + n:] = 0
        src = torch.from_numpy(h)
        if self.device.type == "cuda":
            src = src.pin_memory()
        self._pf_args.copy_(src, non_blocking=True)
        self._prefill_graph(1)
        return self._pf_out.clone()

    @torch.no_grad()
    def activate(self, slot: int, last_logits, plen: int, seed: int,
                 temperature: float | None = None) -> int:
        """Pick the first token from the final prefill chunk's logits
        (argmax, or the first draw of the slot's generator seeded with
        ``seed``), set the slot's sampling mode and flip it live. ->
        the first token."""
        temp = self.temperature if temperature is None else float(temperature)
        gen = self._gens[slot]
        gen.manual_seed(int(seed))
        if temp > 0.0:
            probs = (last_logits / temp).softmax(-1)
            first = torch.multinomial(probs, 1, generator=gen)[0]
            self._sampling[slot] = temp
        else:
            first = last_logits.argmax(-1)
            self._sampling.pop(slot, None)
        st = self.state
        st["tokens"][slot] = first
        st["pos"][slot] = int(plen)
        st["live"][slot] = True
        return int(first)

    @torch.no_grad()
    def decode(self):
        """One tick: every live slot advances one token. -> emitted
        (slots,) int64 device tensor, -1 on dead slots. The graph (or
        body) takes the greedy token; each live temperature slot then
        draws from its own generator on the tick's logits."""
        self._decode_graph(1)
        st = self.state
        for slot, temp in self._sampling.items():
            probs = (self._dec_logits[slot] / temp).softmax(-1)
            st["tokens"][slot] = torch.multinomial(
                probs, 1, generator=self._gens[slot]
            )[0]
        return torch.where(st["live"], st["tokens"], -1)

    def verify(self, draft, n_draft):
        """One speculative tick: every live slot advances by its
        accepted-prefix length + 1. ``draft`` (slots, K) proposed tokens,
        ``n_draft`` (slots,) how many are real (0 = the slot rides as a
        one-token tick). -> (emitted (slots, K+1) device tensor, -1
        beyond each accepted run and on dead slots; accepted (slots,))."""
        dev = self.device
        return self._verify(
            torch.as_tensor(np.asarray(draft), dtype=torch.int64, device=dev),
            torch.as_tensor(np.asarray(n_draft), dtype=torch.int64,
                            device=dev),
        )

    def retire(self, slot: int) -> None:
        """Release the slot's blocks (a refcount decrement: shared prefix
        blocks stay for their other owners, registered refcount-0 blocks
        park on the LRU list, the rest return to the free list) and kill
        its lane."""
        st = self.state
        st["live"][slot] = False
        st["tables"][slot] = 0
        self._sampling.pop(slot, None)
        self._slot_chain.pop(slot, None)
        self._slot_version.pop(slot, None)
        blocks = self._slot_blocks.pop(slot, None)
        if blocks:
            self.allocator.release(blocks)

    # ------------------------------------------------------------------
    # migration: a slot, or cached blocks, as host values
    # ------------------------------------------------------------------

    def _head_ranks(self) -> list[int]:
        """The ranks whose pools together hold every head once, in head
        order: every rank when the heads split, else rank 0."""
        if self._rank_heads == self.cfg.n_heads:
            return [0]
        return list(range(len(self._pools)))

    def _gather_blocks(self, blocks: list[int]):
        """Every layer's K/V of ``blocks`` -> two host arrays
        (L, n, H, BL, D) of the pool's dtype, the heads gathered from the
        ranks in rank order. One copy to the host, so it waits for the
        card."""
        out = []
        for kv in ("k", "v"):
            parts = []
            for m in self._head_ranks():
                pools = self._pools[m][kv]
                idx = torch.tensor(blocks, dtype=torch.int64,
                                   device=pools[0].device)
                parts.append(torch.stack(
                    [p.index_select(0, idx) for p in pools]).to(self.device))
            out.append(torch.cat(parts, dim=2).cpu().numpy())
        return out[0], out[1]

    def _scatter_blocks(self, blocks: list[int], k, v) -> None:
        """Write host K/V arrays (L, n, H, BL, D) into ``blocks`` of every
        layer, each rank its heads (every head where they replicate):
        one ``index_copy_`` per pool."""
        if not blocks:
            return
        hm = self._rank_heads
        for m, pools in enumerate(self._pools):
            sl = slice(0, hm) if hm == self.cfg.n_heads else slice(
                m * hm, (m + 1) * hm)
            dev = pools["k"][0].device
            idx = torch.tensor(blocks, dtype=torch.int64, device=dev)
            for kv, host in (("k", k), ("v", v)):
                t = torch.from_numpy(
                    np.ascontiguousarray(host[:, :, sl])).to(dev)
                for i, pool in enumerate(pools[kv]):
                    pool.index_copy_(0, idx, t[i])

    def _check_blocks(self, what: str, k, v) -> None:
        """Shipped K/V must match this pool's layers, geometry and dtype
        (raises: nothing is cast)."""
        pool = self._pools[0]["k"][0]
        want = str(pool.dtype).removeprefix("torch.")
        shape = (self.cfg.n_layers, self.cfg.n_heads) + tuple(pool.shape[2:])
        for name, a in (("k", k), ("v", v)):
            if a.dtype.name != want:
                raise ValueError(
                    f"{what}: {a.dtype.name} {name} into a {want} pool "
                    "(K/V bytes are never cast)"
                )
            if a.ndim != 5 or (a.shape[0],) + a.shape[2:] != shape:
                raise ValueError(
                    f"{what}: {name} {a.shape} does not fit this pool's "
                    f"(layers, n, heads, block_len, head_dim) "
                    f"{shape[:1] + ('n',) + shape[1:]}"
                )
        if k.shape != v.shape:
            raise ValueError(f"{what}: k {k.shape} != v {v.shape}")

    def export_slot(self, slot: int) -> dict:
        """One admitted, activated slot's migratable state as host
        values: every layer's K/V blocks gathered through its table,
        trimmed to its allocation; the lanes (token, position,
        temperature); and the admission digest chain. A temperature slot
        ships its ``torch.Generator`` state (``gen_state``) and the
        device type it belongs to, so the importer's stream continues
        bitwise; ``rng`` is the JAX package's key lane, zero here. The
        slot is untouched (the caller retires it). Synchronises with the
        card: call it between ticks."""
        blocks = self._slot_blocks.get(slot)
        if not blocks:
            raise ValueError(f"slot {slot} owns no blocks (not admitted?)")
        k, v = self._gather_blocks(blocks)
        st = self.state
        lanes = torch.stack([st["tokens"][slot],
                             st["pos"][slot].long()]).cpu()
        temp = self._sampling.get(slot, 0.0)
        payload = {
            "k": k,
            "v": v,
            "token": int(lanes[0]),
            "pos": int(lanes[1]),
            "temp": float(temp),
            "rng": np.zeros((2,), np.uint32),
            "chain": list(self._slot_chain.get(slot) or ()),
        }
        if temp > 0.0:
            payload["gen_state"] = self._gens[slot].get_state().numpy()
            payload["gen_device"] = self.device.type
        return payload

    def import_slot(self, slot: int, payload: dict) -> dict:
        """Install an exported sequence into dead ``slot``: share this
        pool's cached blocks wherever the shipped digest chain matches,
        allocate the rest, write the shipped bytes into the fresh blocks
        only, install the lanes live, and register the shipped digests
        for later local hits. The payload is checked first (dtype,
        geometry, a temperature slot's generator state) and so is
        feasibility, so a refused or backpressured import (ValueError,
        PoolExhausted) touches nothing. -> {"blocks", "shared",
        "registered"}."""
        k, v = payload["k"], payload["v"]
        self._check_blocks("import_slot", k, v)
        temp = float(payload["temp"])
        state = None
        if temp > 0.0:
            if "gen_state" not in payload:
                raise ValueError(
                    "import_slot: a temperature slot without a "
                    "torch.Generator state (a JAX threefry key cannot "
                    "continue its stream here)"
                )
            if payload.get("gen_device") != self.device.type:
                raise ValueError(
                    f"import_slot: a {payload.get('gen_device')} "
                    f"generator state into a {self.device.type} engine"
                )
            state = torch.from_numpy(
                np.array(payload["gen_state"], np.uint8))
            if state.numel() != self._gens[slot].get_state().numel():
                raise ValueError(
                    f"import_slot: a {state.numel()}-byte generator state "
                    f"for a {self._gens[slot].get_state().numel()}-byte "
                    "generator"
                )
        alloc = self.allocator
        n = int(k.shape[1])
        chain = list(payload.get("chain") or ())
        hit: list[int] = []
        if alloc.cache is not None and chain:
            hit = alloc.cache.match_chain(chain)[:n]
        fresh_n = n - len(hit)
        if fresh_n > alloc.headroom_excluding(hit):
            raise PoolExhausted(
                f"import needs {fresh_n} fresh blocks beyond a "
                f"{len(hit)}-block prefix hit, "
                f"{alloc.headroom_excluding(hit)} allocatable"
            )
        if hit:
            alloc.retain(hit)
        fresh = alloc.alloc(fresh_n)
        blocks = hit + fresh
        # shared blocks already hold these bytes: only fresh rows move
        self._scatter_blocks(fresh, k[:, len(hit):], v[:, len(hit):])
        self._install_table(slot, blocks)
        st = self.state
        st["tokens"][slot] = int(payload["token"])
        st["pos"][slot] = int(payload["pos"])
        st["live"][slot] = True
        if state is None:
            self._sampling.pop(slot, None)
        else:
            self._gens[slot].set_state(state)
            self._sampling[slot] = temp
        self._slot_blocks[slot] = blocks
        self._slot_chain[slot] = chain
        self._slot_version[slot] = self.params_version
        registered = 0
        if alloc.cache is not None:
            registered = self._register_chain(chain[:n], blocks)
        return {"blocks": blocks, "shared": len(hit),
                "registered": registered}

    def export_blocks(self, blocks: list[int]) -> tuple:
        """Registered blocks' K/V as host arrays ``(k, v)`` shaped
        (L, n, H, BL, D): the payload of a ``cache_ship``. The caller
        retains the blocks across the call (an admission could
        otherwise reclaim them)."""
        return self._gather_blocks(list(blocks))

    def install_prefix(self, chain: list[bytes], k, v) -> dict:
        """Warm this pool with a peer's shipped prefix: allocate blocks
        for every chain position not cached here, write the shipped K/V
        into them (no lane touched), register them under the shipped
        digests and park them on the LRU. Checked first (geometry, dtype,
        feasibility), so a refused or backpressured install touches
        nothing. Idempotent: a re-sent ship installs nothing. ->
        {"installed", "shared"}."""
        alloc = self.allocator
        if alloc.cache is None or not alloc.lru_enabled:
            # a refcount-0 block cannot outlive this call without the LRU
            return {"installed": 0, "shared": 0}
        n = len(chain)
        mb = self.pool.max_blocks_per_seq
        if n > mb or int(k.shape[1]) != n:
            raise ValueError(
                f"install_prefix: {n} digests vs {int(k.shape[1])} "
                f"shipped blocks (table width {mb})"
            )
        self._check_blocks("install_prefix", k, v)
        have = alloc.cache.match_chain(chain)
        todo = n - len(have)
        if todo == 0:
            return {"installed": 0, "shared": n}
        if todo > alloc.headroom_excluding(have):
            raise PoolExhausted(
                f"install needs {todo} fresh blocks beyond a "
                f"{len(have)}-block local prefix, "
                f"{alloc.headroom_excluding(have)} allocatable"
            )
        # pin the matched parents across alloc(): evicting one would
        # orphan the chain about to be extended
        if have:
            alloc.retain(have)
        fresh = alloc.alloc(todo)
        self._scatter_blocks(fresh, k[:, len(have):], v[:, len(have):])
        for i in range(len(have), n):
            alloc.cache.register(
                chain[i], fresh[i - len(have)],
                parent=chain[i - 1] if i else None,
            )
        # the warmed blocks belong to no sequence: release parks them
        alloc.release(fresh)
        if have:
            alloc.release(have)
        return {"installed": todo, "shared": len(have)}

    # ------------------------------------------------------------------
    # live weight rollout: a staged next version beside the live one
    # ------------------------------------------------------------------

    @property
    def staged_version(self) -> int | None:
        """Version tag of the staged (not yet live) tree, or None."""
        return self._staged[0] if self._staged is not None else None

    def stage_params(self, params: dict, version: int) -> int:
        """Hold next-version ``params`` (tensors or numpy arrays, e.g. a
        deserialized weight frame) on the device beside the live tree.
        Validated against the live tree's exact key set, shapes and
        dtypes before anything is copied: the captured graphs are reused
        across the flip, so a mismatched tree is rejected here, never
        staged. -> staged byte count."""
        version = int(version)
        if version == self.params_version:
            raise ValueError(f"stage_params: version {version} is already "
                             "live")
        missing = sorted(set(self.params) - set(params))
        extra = sorted(set(params) - set(self.params))
        if missing or extra:
            raise ValueError(
                f"stage_params v{version}: param tree mismatch "
                f"(missing {missing[:3]}, extra {extra[:3]})"
            )
        host = {}
        for name, live in self.params.items():
            a = params[name]
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.array(a))
            if tuple(t.shape) != tuple(live.shape):
                raise ValueError(
                    f"stage_params v{version}: {name!r} shape "
                    f"{tuple(t.shape)} != live {tuple(live.shape)}"
                )
            if t.dtype != live.dtype:
                raise ValueError(
                    f"stage_params v{version}: {name!r} dtype {t.dtype} "
                    f"!= live {live.dtype}"
                )
            host[name] = t
        self._staged = (version, {
            name: t.detach().to(self.device, copy=True)
            for name, t in host.items()
        })
        return sum(t.numel() * t.element_size() for t in host.values())

    def unstage(self) -> None:
        """Drop the staged tree (an aborted version)."""
        self._staged = None

    def _swap_params(self, other: dict) -> None:
        """Exchange the bytes of the live tensors and ``other``'s, in
        place: the live tensors keep their addresses (the graphs read
        them) and ``other`` ends up holding the previous weights."""
        for name, live in self.params.items():
            old = live.clone()
            live.copy_(other[name])
            other[name].copy_(old)
            d = self._layout.get(name)
            for m, pc in enumerate(self._pieces):
                if d is not None:
                    pc[name].copy_(live.chunk(len(self._pieces), dim=d)[m])

    def flip_params(self) -> dict:
        """Make the staged tree live at a tick boundary: its bytes are
        copied into the live tensors, the previous weights stay pinned
        (in the staged tree's tensors) for rollback, and the prefix cache
        is purged (its bytes belong to the old weights). In-flight slots
        ride through on their written K/V. -> {"version",
        "prev_version", "purged_blocks"}."""
        if self._staged is None:
            raise ValueError("flip_params: nothing staged")
        version, tree = self._staged
        self._swap_params(tree)
        self._prev = (self.params_version, tree)
        self.params_version = version
        self._staged = None
        return {
            "version": version,
            "prev_version": self._prev[0],
            "purged_blocks": self.allocator.purge_cache(),
        }

    def rollback_params(self) -> dict:
        """Restore the pinned previous version (a canary abort), in place
        as flip_params does, and purge the cache again: blocks written
        under the aborted version are garbage to the restored one.
        Raises if no previous version is pinned."""
        if self._prev is None:
            raise ValueError("rollback_params: no previous version pinned")
        version, tree = self._prev
        self._swap_params(tree)
        aborted = self.params_version
        self.params_version = version
        self._prev = None
        self._staged = None
        return {
            "version": version,
            "aborted_version": aborted,
            "purged_blocks": self.allocator.purge_cache(),
        }
