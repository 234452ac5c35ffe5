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

Not in this slice (raise ``NotImplementedError``): the prefix cache,
a mesh, slot export/import, COW, prefix install and weight staging.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..models.transformer import (
    TransformerConfig,
    _block_apply,
    cache_attend,
    decode_capacity,
    lm_head,
)
from ..ops.paged_attention import (
    _gather,
    fusable,
    paged_attention,
    paged_attention_overlay,
)
from ..utils.graphs import Graphed
from .kv_pool import BlockAllocator, KVPool

_PREFIX_SLICE = "the prefix-cache and fleet slice (ROADMAP.md)"


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
    #: content-addressed block sharing; not ported yet (raises)
    prefix_cache: bool = False
    #: "fused" = the CUDA paged-attention kernel (plain version on the
    #: CPU); "reference" = gather + cache_attend, the stream oracle
    attend_impl: str = "fused"


@dataclasses.dataclass(frozen=True)
class Admission:
    """What admit() did for one request: the sequence's block list.
    (The prefix-cache slice adds the cached-prefix fields.)"""

    blocks: list


class Engine:
    """Slot-batched continuous-decode engine for the code-API LM."""

    def __init__(self, params: dict, cfg: TransformerConfig,
                 serving: EngineConfig | None = None, *, device=None,
                 mesh=None, temperature: float = 0.0, graphs: bool = True):
        self.cfg = cfg
        self.serving = serving or EngineConfig()
        self.temperature = float(temperature)
        if mesh is not None:
            raise NotImplementedError(
                "Engine(mesh=...): sharded serving comes with the "
                "distribution slice (ROADMAP.md)"
            )
        if self.serving.prefix_cache:
            raise NotImplementedError(
                f"prefix_cache=True: comes with {_PREFIX_SLICE}"
            )
        if self.serving.attend_impl not in ("reference", "fused"):
            raise ValueError(
                f"kernels.paged_attention must be 'reference' or "
                f"'fused', got {self.serving.attend_impl!r}"
            )
        self._fused = self.serving.attend_impl == "fused"
        #: MoE routing at capacity E on every program: drop-free, so a
        #: slot's tokens never depend on what shares the batch
        self._moe_cf = decode_capacity(cfg)
        self.device = resolve_device(device)
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
        self.allocator = BlockAllocator(self.pool)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        s, mb = self.serving.slots, self.pool.max_blocks_per_seq
        shape = (
            self.pool.n_blocks, cfg.n_heads,
            self.pool.block_len, cfg.head_dim,
        )
        dev, dtype = self.device, self.params["embed/tok"].dtype
        self.state = {
            "tokens": torch.zeros(s, dtype=torch.int64, device=dev),
            "pos": torch.zeros(s, dtype=torch.int32, device=dev),
            "live": torch.zeros(s, dtype=torch.bool, device=dev),
            "tables": torch.zeros((s, mb), dtype=torch.int32, device=dev),
            "k": [torch.zeros(shape, dtype=dtype, device=dev)
                  for _ in range(cfg.n_layers)],
            "v": [torch.zeros(shape, dtype=dtype, device=dev)
                  for _ in range(cfg.n_layers)],
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
        self._decode_graph = Graphed(self._decode, dev, enabled=graphs)
        self._prefill_graph = Graphed(self._prefill, dev, enabled=graphs)

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

    def _write(self, i, bid, off, k, v):
        """Scatter fresh K/V (index shape + (H, D)) into layer ``i``'s
        pools IN PLACE at (block ``bid``, offset ``off``). Padding, dead
        and rejected lanes all target the trash block 0, so indices may
        repeat; ``index_put_`` then writes them in an undefined order,
        which is harmless: only trash bytes collide, and every attend
        masks them."""
        self.state["k"][i][bid, :, off] = k
        self.state["v"][i][bid, :, off] = v

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
            def attend(q, k, v):
                self._write(i, bid, off, k[:, :, 0], v[:, :, 0])
                kp, vp = st["k"][i], st["v"][i]
                if self._fused:
                    o = self._paged_attend(q, kp, vp, tables, pos_attend)
                else:
                    o = cache_attend(
                        q, *self._gather_kv(kp, vp, tables), pos[:, None]
                    )
                return o, None
            return attend

        for i in range(self.cfg.n_layers):
            x, _, _ = _block_apply(
                self.params, f"blk{i}", x, mk_attend(i), self.cfg,
                moe_capacity_factor=self._moe_cf,
            )
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
            def attend(q, k, v):
                self._write(
                    i, bid, off, k[0].transpose(0, 1), v[0].transpose(0, 1)
                )
                kp, vp = self.state["k"][i], self.state["v"][i]
                if self._fused:
                    o = self._paged_attend(q, kp, vp, row, p[None])
                else:
                    o = cache_attend(
                        q, *self._gather_kv(kp, vp, row), p[None]
                    )
                return o, None
            return attend

        for i in range(self.cfg.n_layers):
            x, _, _ = _block_apply(
                self.params, f"blk{i}", x, mk_attend(i), self.cfg,
                moe_capacity_factor=self._moe_cf,
            )
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
            def attend(qh, kh, vh):
                kp, vp = st["k"][i], st["v"][i]
                if self._fused:
                    # the overlay form IS the rewind contract at every
                    # draft width: the pool is never written here
                    o = paged_attention_overlay(
                        qh.contiguous(), kp, vp, tables, p32,
                        kh.contiguous(), vh.contiguous(), valid,
                    )
                    return o, (kh, vh)
                if kd == 0:
                    # zero draft width: nothing can be rejected, so write
                    # then gather like the decode tick
                    self._write(
                        i, bid, off, kh.transpose(1, 2), vh.transpose(1, 2)
                    )
                    o = cache_attend(
                        qh, *self._gather_kv(kp, vp, tables), p
                    )
                    return o, None
                dk, dv = self._gather_kv(kp, vp, tables)
                dk[s_idx, :, p_col] = kh.transpose(1, 2)
                dv[s_idx, :, p_col] = vh.transpose(1, 2)
                return cache_attend(qh, dk, dv, p), (kh, vh)
            return attend

        for i in range(self.cfg.n_layers):
            x, _, extra = _block_apply(
                self.params, f"blk{i}", x, mk_attend(i), self.cfg,
                moe_capacity_factor=self._moe_cf,
            )
            fresh.append(extra)
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
            for i, (kh, vh) in enumerate(fresh):
                self._write(
                    i, bid_keep, off, kh.transpose(1, 2), vh.transpose(1, 2)
                )
        # in place: the lanes keep the addresses decode's graph reads
        tokens.copy_(torch.where(live, last_tok, tokens))
        pos.add_(torch.where(live, acc + 1, 0).to(torch.int32))
        return emitted, torch.where(live, acc, 0)

    # ------------------------------------------------------------------
    # admission-path API
    # ------------------------------------------------------------------

    def admit(self, slot: int, n_total_tokens: int) -> Admission:
        """Allocate ``blocks_for(n_total_tokens)`` blocks to ``slot`` and
        install its block table (raises PoolExhausted with nothing
        touched: admission backpressure). The slot stays dead until
        activate()."""
        blocks = self.allocator.alloc(self.pool.blocks_for(n_total_tokens))
        row = np.zeros((self.pool.max_blocks_per_seq,), np.int32)
        row[: len(blocks)] = blocks
        st = self.state
        st["tables"][slot] = torch.from_numpy(row).to(self.device)
        st["pos"][slot] = 0
        st["live"][slot] = False
        self._slot_blocks[slot] = blocks
        return Admission(blocks=blocks)

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
        """Release the slot's blocks and kill its lane."""
        st = self.state
        st["live"][slot] = False
        st["tables"][slot] = 0
        self._sampling.pop(slot, None)
        blocks = self._slot_blocks.pop(slot, None)
        if blocks:
            self.allocator.release(blocks)

    # ------------------------------------------------------------------
    # later slices
    # ------------------------------------------------------------------

    def export_slot(self, slot: int):
        raise NotImplementedError(f"export_slot: comes with {_PREFIX_SLICE}")

    def import_slot(self, slot: int, payload: dict):
        raise NotImplementedError(f"import_slot: comes with {_PREFIX_SLICE}")

    def install_prefix(self, chain, k, v):
        raise NotImplementedError(
            f"install_prefix: comes with {_PREFIX_SLICE}"
        )

    def stage_params(self, params: dict, version: int):
        raise NotImplementedError(
            f"stage_params (live weight rollout): comes with {_PREFIX_SLICE}"
        )

    def flip_params(self):
        raise NotImplementedError(
            f"flip_params (live weight rollout): comes with {_PREFIX_SLICE}"
        )
