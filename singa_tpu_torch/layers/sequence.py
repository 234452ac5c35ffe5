"""Sequence-modeling layers: the conf-driven transformer LM vocabulary.

Counterpart of ``singa_tpu/layers/sequence.py``: (B, S) tokens from
kSequenceData, through kEmbedding -> (B, S, D), residual blocks built
from kLayerNorm / kAttention / kDense / kAdd, into kLMLoss (next-token
cross-entropy), with kMoE's dense path in place of a block's FFN.
kEmbedding and kAttention carry the ``decode_step`` hooks of the
conf-net KV-cache decode (``serve/conf_decode.py``); kLayerNorm and
kDense are position-wise and decode through ``apply``.

On a mesh (``Layer.apply_ranks``, ``parallel/axes.py``): over a seq
axis kEmbedding adds the rank's GLOBAL positions, kAttention runs ring
attention (``mode: "ring"``; any other mode attends the seq group's
gathered K/V) and kLMLoss shifts over the global sequence (a shard's
last target is the next shard's first token; the mean is over every
rank's B·(S−1) targets); kMoE routes the tokens the JAX program routes
together (the global batch, or over an expert axis each data shard
through its expert-parallel forms; each with its whole sequence); under
kLayerPartition on a model axis kAttention and kDense compute their
output slices from their shards (Concate in rank order; ``out``, split
on its input dim, sums its partial outputs in rank order), beside a seq
axis too.

Numerical points where PyTorch's defaults differ from JAX's:
``jax.nn.gelu`` is the tanh approximation and ``jnp.var`` the
population variance; the layers below ask for both explicitly.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..config.schema import ConfigError
from ..ops.attention import (attention, attention_rows, auto_attention,
                             dense_fits)
from ..parallel.axes import concate, rank_sum
from .base import Layer, Shape, require_one_src
from .data import _ArrayDataLayer


def load_token_arrays(path: str):
    """Decode a token shard: each record's uint8 ``pixel`` bytes are one
    fixed-length sequence (byte-level vocab), label unused. -> (tokens
    int32 (N, S), labels int32 (N,))."""
    from ..data.pipeline import load_shard_arrays

    images, labels = load_shard_arrays(path)
    if images.ndim != 2:
        raise ConfigError(
            f"token shard {path!r}: expected flat (N, S) sequences, got "
            f"shape {images.shape}"
        )
    return images.astype("int32"), labels


class SequenceDataLayer(_ArrayDataLayer):
    """kSequenceData: batches of fixed-length token sequences."""

    TYPE = "kSequenceData"
    LOADER = staticmethod(load_token_arrays)


class EmbeddingLayer(Layer):
    """kEmbedding: token + learned positional embedding."""

    TYPE = "kEmbedding"

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        p = self.cfg.embedding_param
        if p is None:
            raise ConfigError(
                f"layer {self.name!r}: embedding_param required"
            )
        src = require_one_src(self, src_shapes)
        if len(src) != 2:
            raise ConfigError(
                f"layer {self.name!r}: expects (batch, seq) token input"
            )
        self.seq_len = src[1]
        self.vocab = p.vocab_size
        self.dim = p.embedding_dim
        max_len = p.max_len or self.seq_len
        if max_len < self.seq_len:
            raise ConfigError(
                f"layer {self.name!r}: max_len {max_len} < sequence "
                f"length {self.seq_len}"
            )
        self.tok = self._declare_param(
            0, "tok", (self.vocab, self.dim), fan_in=self.dim
        )
        self.pos = self._declare_param(
            1, "pos", (max_len, self.dim), fan_in=self.dim
        )
        return (src[0], self.seq_len, self.dim)

    def validate(self, src_layers) -> None:
        # an out-of-range id would index past the table; catch an
        # undersized vocab at build time, as the JAX package does
        src = src_layers[0]
        if getattr(src, "is_datalayer", False) and hasattr(src, "images"):
            top = int(src.images.max())
            if top >= self.vocab:
                raise ConfigError(
                    f"layer {self.name!r}: vocab_size {self.vocab} <= max "
                    f"token id {top} in {src.name!r}'s data"
                )

    def apply(self, params, inputs, *, training, generator=None):
        tokens = inputs[0]["image"].long()
        s = tokens.shape[1]
        return params[self.tok][tokens] + params[self.pos][:s]

    def crosses(self) -> bool:
        return self.mesh is not None and self.mesh.widths["seq"] > 1

    def apply_ranks(self, params, inputs, lanes, *, training):
        """Each seq rank embeds its shard at its global positions."""
        outs = []
        for j, (p, x) in enumerate(zip(params, inputs)):
            tokens = x[0]["image"].long()
            s = tokens.shape[1]
            off = lanes.coords(j)["seq"] * s
            outs.append(p[self.tok][tokens] + p[self.pos][off:off + s])
        return outs

    def decode_step(self, params, tokens, pos: int):
        """The incremental decode's apply (serve/conf_decode.py): embed
        the Q tokens (1, Q) at ABSOLUTE positions [pos, pos + Q), clamped
        to the table as the JAX package clamps them; ``apply``'s ``[:s]``
        assumes the window starts at 0."""
        table = params[self.pos]
        p = (pos + torch.arange(tokens.shape[1], device=table.device)
             ).clamp(max=table.shape[0] - 1)
        return params[self.tok][tokens.long()] + table[p]


class LayerNormLayer(Layer):
    """kLayerNorm over the last dim; stats in fp32 under bf16 compute."""

    TYPE = "kLayerNorm"
    decode_positionwise = True  # per-position stats: decode reuses apply

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        p = self.cfg.layernorm_param
        self.eps = p.eps if p else 1e-5
        src = require_one_src(self, src_shapes)
        d = src[-1]
        self.scale = self._declare_param(0, "scale", (d,))
        self.bias = self._declare_param(1, "bias", (d,))
        return src

    def apply(self, params, inputs, *, training, generator=None):
        x = inputs[0]
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (
            y.to(x.dtype) * params[self.scale] + params[self.bias]
        ).to(x.dtype)


class AttentionLayer(Layer):
    """kAttention: causal multi-head self-attention with fused QKV.

    ``mode`` "flash" (and "ring" off a seq axis, the JAX package's
    degradation to one shard) picks dense or the flash kernels by the
    score footprint (``ops.attention.auto_attention``, one rank's
    shapes); anything else is dense. ``qkv`` splits its output dim and
    ``out`` its input dim under kLayerPartition."""

    TYPE = "kAttention"

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        p = self.cfg.attention_param
        if p is None:
            raise ConfigError(
                f"layer {self.name!r}: attention_param required"
            )
        src = require_one_src(self, src_shapes)
        if len(src) != 3:
            raise ConfigError(
                f"layer {self.name!r}: expects (batch, seq, dim) input"
            )
        d = src[-1]
        self.heads = p.num_heads
        if d % self.heads:
            raise ConfigError(
                f"layer {self.name!r}: dim {d} not divisible by "
                f"num_heads {self.heads}"
            )
        self.mode = p.mode
        self.qkv = self._declare_param(
            0, "qkv", (d, 3 * d), fan_in=d, neuron_axis=1
        )
        self.out = self._declare_param(
            1, "out", (d, d), fan_in=d, neuron_axis=0
        )
        return src

    def _heads(self, qkv):
        """(B, S, 3D) -> q, k, v as (B, H, S, D/H)."""
        b, s, d3 = qkv.shape
        qkv = qkv.reshape(b, s, 3, self.heads, d3 // (3 * self.heads))
        return [qkv[:, :, j].movedim(2, 1) for j in range(3)]

    def _attend(self, q, k, v):
        if self.mode in ("flash", "ring"):
            return auto_attention(q, k, v, causal=True, n_devices=1)
        return attention(q, k, v, causal=True)

    def apply(self, params, inputs, *, training, generator=None):
        x = inputs[0]
        b, s, d = x.shape
        w = params[self.qkv]
        o = self._attend(*self._heads(x.to(w.dtype) @ w))
        o = o.movedim(1, 2).reshape(b, s, d)
        return o.to(w.dtype) @ params[self.out]

    def crosses(self) -> bool:
        return (self.mesh is not None and self.mesh.widths["seq"] > 1
                or self.model_split())

    def _attend_seq(self, heads: list, lanes, g: list) -> list:
        """One seq group's attention: ``heads[k]`` the (q, k, v) of lane
        ``g[k]`` (this walk's lanes of the group, each of its own seq
        shard) -> each lane's output. Off a seq axis a shard attends
        alone (ring mode too: the JAX package's degradation). On one,
        the group's K/V blocks reach every lane through one exchange
        over the seq axis (``Lanes.exchange``; it may cross processes),
        and each lane computes its own query block's output: in ``mode:
        "ring"`` its ring over every block (``ring_fold``), else its rows
        of the global attention the JAX program computes over a
        seq-sharded input (``attention_rows``, on the route that
        attention takes: flash where its footprint calls for it)."""
        if lanes.mesh.widths["seq"] == 1:
            return [self._attend(*h) for h in heads]
        from ..parallel.ring import ring_fold

        wholes = lanes.exchange(g, [torch.stack(h[1:]) for h in heads],
                                axes=("seq",))
        outs = []
        for j, h, whole in zip(g, heads, wholes):
            my = lanes.coords(j)["seq"]
            if self.mode == "ring":
                outs.append(ring_fold(h[0], [(b[0], b[1]) for b in whole],
                                      my, causal=True))
                continue
            k, v = (torch.cat([b[i] for b in whole], dim=2) for i in (0, 1))
            bsz, nh, s, _ = h[0].shape
            flash = (self.mode == "flash"
                     and not dense_fits(bsz, nh, s * len(whole)))
            outs.append(attention_rows(h[0], k, v, my * s, flash=flash))
        return outs

    def apply_ranks(self, params, inputs, lanes, *, training):
        if self.model_split():
            return self._model_ranks(params, inputs, lanes)
        outs = [None] * len(params)
        for g in lanes.groups("seq"):
            x = [inputs[j][0] for j in g]
            w = [params[j][self.qkv] for j in g]
            heads = [self._heads(xi.to(wi.dtype) @ wi)
                     for xi, wi in zip(x, w)]
            os = self._attend_seq(heads, lanes, g)
            for j, xi, o in zip(g, x, os):
                b, s, d = xi.shape
                o = o.movedim(1, 2).reshape(b, s, d)
                outs[j] = o.to(w[0].dtype) @ params[j][self.out]
        return outs

    def _project_out(self, os, params, js, lanes):
        """The model ranks ``js``' ``out`` shards (rows of the input dim)
        on their attended heads ``os[k]`` (B, S, D): each rank's partial
        output, and every lane's sum of the group's partials in rank
        order (the partials through ``Lanes.exchange``)."""
        rows = params[js[0]][self.out].shape[0]
        parts = []
        for j, o in zip(js, os):
            o = F.pad(o, (0, rows * lanes.mesh.widths["model"]
                          - o.shape[-1]))
            m = lanes.coords(j)["model"]
            parts.append(o[..., m * rows:(m + 1) * rows].to(
                params[j][self.out].dtype) @ params[j][self.out])
        return [rank_sum(p) for p in lanes.exchange(js, parts)]

    def _fused_qkv(self, params, inputs, js, lanes):
        """The model ranks ``js``' slices of the fused projection of
        their (replicated) input, Concate in rank order, pad cut off:
        once for this process (``Lanes.exchange``'s one consumer)."""
        d = inputs[js[0]][0].shape[-1]
        parts = [inputs[j][0].to(params[j][self.qkv].dtype)
                 @ params[j][self.qkv] for j in js]
        whole, = lanes.exchange(js, parts, per_lane=False)
        return concate(whole, -1)[..., :3 * d]

    def _model_ranks(self, params, inputs, lanes):
        """kLayerPartition: each seq shard's heads (the whole sequence
        off a seq axis) from its model ranks' ``qkv`` shards, once a
        process; off a seq axis a shard attends once a process (its
        group's heads meet on one device), on one each lane runs its seq
        group's attention (``_attend_seq``, over the lanes of its model
        index); each lane's output from its model ranks' ``out``
        shards."""
        outs = [None] * len(params)
        for g in lanes.groups("seq", "model"):
            by: dict[int, list] = {}
            for j in g:
                by.setdefault(lanes.coords(j)["seq"], []).append(j)
            shards = [by[s] for s in sorted(by)]
            heads = [self._heads(self._fused_qkv(params, inputs, js, lanes))
                     for js in shards]
            o_of = {}
            if lanes.mesh.widths["seq"] == 1:
                for js, h in zip(shards, heads):
                    o = self._attend(*h)
                    o_of.update((j, o) for j in js)
            else:
                for k in range(len(shards[0])):
                    seq_lanes = [js[k] for js in shards]
                    o_of.update(zip(seq_lanes, self._attend_seq(
                        heads, lanes, seq_lanes)))
            for js in shards:
                b, s, d = inputs[js[0]][0].shape
                ys = self._project_out(
                    [o_of[j].movedim(1, 2).reshape(b, s, d) for j in js],
                    params, js, lanes)
                for j, y in zip(js, ys):
                    outs[j] = y
        return outs

    def decode_step(self, params, x, cache, pos: int):
        """The incremental decode's apply: the Q new positions [pos,
        pos + Q) write their K/V into the (B, H, C, D) caches IN PLACE
        (the JAX package returns new caches; here the decoder owns
        them) and attend the whole masked cache through the serving
        tier's ``cache_attend`` (models/transformer.py), as the JAX
        package does; the flash modes are a training-shape choice the
        chunked cache path does not need. -> (out, (k cache, v cache))."""
        from ..models.transformer import cache_attend

        b, q_len, d = x.shape
        w = params[self.qkv]
        qkv = (x.to(w.dtype) @ w).reshape(
            b, q_len, 3, self.heads, d // self.heads
        )
        q, k, v = (qkv[:, :, j].movedim(2, 1) for j in range(3))
        kc, vc = cache
        kc[:, :, pos:pos + q_len] = k.to(kc.dtype)
        vc[:, :, pos:pos + q_len] = v.to(vc.dtype)
        positions = (
            pos + torch.arange(q_len, device=x.device)
        )[None, :].expand(b, q_len)
        o = cache_attend(q, kc, vc, positions)
        o = o.movedim(1, 2).reshape(b, q_len, d)
        return o.to(w.dtype) @ params[self.out], (kc, vc)


class DenseLayer(Layer):
    """kDense: per-position linear map over the last dim (+ optional
    fused activation)."""

    TYPE = "kDense"
    decode_positionwise = True  # per-position map: decode reuses apply

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        p = self.cfg.dense_param
        if p is None:
            raise ConfigError(f"layer {self.name!r}: dense_param required")
        src = require_one_src(self, src_shapes)
        d = src[-1]
        self.hdim = p.num_output
        self.activation = p.activation
        self.w = self._declare_param(
            0, "weight", (d, self.hdim), fan_in=d, neuron_axis=1
        )
        self.bias_term = p.bias_term
        if self.bias_term:
            self.b = self._declare_param(1, "bias", (self.hdim,))
        return (*src[:-1], self.hdim)

    def _activate(self, out):
        if self.activation == "gelu":
            return F.gelu(out, approximate="tanh")
        if self.activation == "relu":
            return F.relu(out)
        return out

    def apply(self, params, inputs, *, training, generator=None):
        w = params[self.w]
        out = inputs[0].to(w.dtype) @ w
        if self.bias_term:
            out = out + params[self.b]
        return self._activate(out)

    def crosses(self) -> bool:
        return self.model_split()

    def apply_ranks(self, params, inputs, lanes, *, training):
        """kLayerPartition: each model rank computes its columns of the
        output from its weight shard and its slice of the (replicated)
        bias; every lane concatenates the group's slices in rank order
        (``Lanes.exchange``) and cuts the pad off."""
        width = lanes.mesh.widths["model"]
        outs = [None] * len(params)
        for g in lanes.groups("model"):
            parts = []
            for j in g:
                w = params[j][self.w]
                part = inputs[j][0].to(w.dtype) @ w
                if self.bias_term:
                    m, k = w.shape[-1], lanes.coords(j)["model"]
                    bias = F.pad(params[j][self.b], (0, m * width
                                                     - self.hdim))
                    part = part + bias[k * m:(k + 1) * m]
                parts.append(part)
            for j, whole in zip(g, lanes.exchange(g, parts)):
                outs[j] = self._activate(concate(whole, -1)[..., :self.hdim])
        return outs


class MoELayer(Layer):
    """kMoE: Switch-style top-1 mixture-of-experts FFN on
    ``parallel/moe.py``'s index form. ``apply`` returns (out, aux): the
    load-balancing aux loss joins Net.forward's total loss with weight
    moe_param.aux_loss_weight. Its expert weights split over the mesh's
    expert axis, where ``apply_ranks`` runs ``moe_param.dispatch``'s form
    (psum or alltoall); without one the dense path runs, the same
    math, on every rank's tokens at once."""

    TYPE = "kMoE"
    has_aux_loss = True

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        p = self.cfg.moe_param
        if p is None:
            raise ConfigError(f"layer {self.name!r}: moe_param required")
        src = require_one_src(self, src_shapes)
        if len(src) != 3:
            raise ConfigError(
                f"layer {self.name!r}: expects (batch, seq, dim) input"
            )
        d = src[-1]
        self.n_experts = p.num_experts
        self.d_ff = p.d_ff
        self.capacity_factor = p.capacity_factor
        self.aux_weight = p.aux_loss_weight
        self.dispatch = p.dispatch
        if self.dispatch not in ("psum", "alltoall"):
            raise ConfigError(
                f"layer {self.name!r}: moe_param.dispatch must be "
                f"'psum' or 'alltoall', got {self.dispatch!r}"
            )
        self.gate = self._declare_param(0, "gate", (d, self.n_experts),
                                        fan_in=d)
        self.up = self._declare_param(
            1, "up", (self.n_experts, d, self.d_ff), fan_in=d,
            expert_axis=0)
        self.down = self._declare_param(
            2, "down", (self.n_experts, self.d_ff, d), fan_in=self.d_ff,
            expert_axis=0)
        return src

    def _p(self, params):
        return {"gate": params[self.gate], "up": params[self.up],
                "down": params[self.down]}

    def apply(self, params, inputs, *, training, generator=None):
        from ..parallel.moe import moe_ffn_dense

        return moe_ffn_dense(inputs[0], self._p(params),
                             self.capacity_factor)

    def crosses(self) -> bool:
        # the JAX program routes the tokens of every rank of the walk
        # together (off the rings' per-shard step, which walks no lanes)
        return self.mesh is not None and self.mesh.width > 1

    def apply_ranks(self, params, inputs, lanes, *, training):
        """The JAX program's routing groups -> each lane's (out, aux):
        without an expert axis the global batch's tokens at once
        (GSPMD's: its data shards in rank order, each with its whole
        sequence); over an expert axis each data shard with its whole
        sequence through the psum or the all-to-all form. Every lane
        computes its own (out, aux) with its own params, so each gate
        gradient and each aux loss counts once a lane: its tokens come
        from its routing group through one exchange (``_tokens``: its
        data shard's seq ranks, or every data shard's without an expert
        axis; never across the data axis in a replica engine's walk),
        the expert ranks' partial outputs, or their experts' outputs on
        every source's buffers, through a second over the expert axis,
        and the all-to-all form's statistics over the data axis (each
        through ``moe.share``). Any of them may cross processes; each
        lane keeps its rows."""
        from ..parallel import moe

        widths = lanes.mesh.widths
        nexp, nseq = widths["expert"], widths["seq"]
        if self.n_experts % nexp:
            raise ConfigError(
                f"layer {self.name!r}: num_experts {self.n_experts} "
                f"not divisible by expert axis width {nexp}"
            )
        across = ("data",) if lanes.data and nexp == 1 else ()
        xs = self._tokens(inputs, lanes, (*across, "seq"))
        cf = self.capacity_factor

        def rows(y, j):
            # lane j's block of its data shard's output (B, S, D)
            c = lanes.coords(j)
            if across:
                y = y.chunk(widths["data"])[c["data"]]
            return y.chunk(nseq, 1)[c["seq"]]

        outs = [None] * len(params)
        if nexp == 1:
            for j, x in enumerate(xs):
                y, aux = moe.moe_ffn_dense(x, self._p(params[j]), cf)
                outs[j] = (rows(y, j), aux)
            return outs
        if self.dispatch == "alltoall":
            b = xs[0].shape[0]
            if b % nexp:
                raise ConfigError(
                    f"layer {self.name!r}: alltoall dispatch shards "
                    f"the batch over data x expert — batch "
                    f"{b * widths['data']} must be divisible by "
                    f"{widths['data'] * nexp}"
                )
            return self._alltoall(params, xs, lanes, rows)
        parts, auxes = zip(*(
            moe.moe_psum_part(x, self._p(params[j]),
                              lanes.coords(j)["expert"], nexp, cf)
            for j, x in enumerate(xs)))
        for g in lanes.groups("expert"):
            for j, every in zip(g, moe.share(
                    lanes, g, [parts[j] for j in g], ("expert",))):
                y = rank_sum(every).reshape(xs[j].shape).to(xs[j].dtype)
                outs[j] = (rows(y, j), auxes[j])
        return outs

    @staticmethod
    def _tokens(inputs, lanes, axes) -> list:
        """Each lane's token set: the inputs of its group over ``axes``
        (``moe.share``, rank order: data shards outer, seq shards inner)
        joined, seq shards along the sequence, data shards along the
        batch."""
        from ..parallel import moe

        nseq = lanes.mesh.widths["seq"]
        if all(lanes.mesh.widths[a] == 1 for a in axes):
            return [x[0] for x in inputs]
        out = [None] * len(inputs)
        for g in lanes.groups(*axes):
            for j, parts in zip(g, moe.share(
                    lanes, g, [inputs[j][0] for j in g], axes)):
                out[j] = concate([concate(parts[i:i + nseq], 1)
                                  for i in range(0, len(parts), nseq)], 0)
        return out

    def _alltoall(self, params, xs, lanes, rows) -> list:
        """The all-to-all form, each lane of expert index e: every
        source's routing of its data shard's tokens through its own
        gate, its own experts on every source's buffers for them, the
        owners' outputs through an exchange over the expert axis, each
        source's rows back; the aux loss over every data shard's and
        source's statistics (an exchange over the data axis in the sync
        Trainer's walk)."""
        from ..parallel import moe

        nexp = lanes.mesh.widths["expert"]
        cf = self.capacity_factor
        routed, owned = [], []
        for j, x in enumerate(xs):
            p = self._p(params[j])
            routed.append([moe.a2a_route(x, p, src, nexp, cf)
                           for src in range(nexp)])
            owned.append(moe.a2a_experts([r[0] for r in routed[j]], p,
                                         lanes.coords(j)["expert"]))
        stats = [torch.stack([torch.stack([r[2] for r in rs]),
                              torch.stack([r[3] for r in rs])])
                 for rs in routed]
        if lanes.data:
            every = [None] * len(xs)
            for g in lanes.groups("data"):
                for j, got in zip(g, moe.share(
                        lanes, g, [stats[j] for j in g], ("data",))):
                    every[j] = got
        else:
            every = [[st] for st in stats]
        outs = [None] * len(xs)
        for g in lanes.groups("expert"):
            for j, by_owner in zip(g, moe.share(
                    lanes, g, [owned[j] for j in g], ("expert",))):
                b, s, d = xs[j].shape
                y = torch.cat([moe.a2a_back(by_owner, routed[j][src][1], src)
                               .reshape(b // nexp, s, d)
                               for src in range(nexp)]).to(xs[j].dtype)
                aux = moe.a2a_aux([f for st in every[j] for f in st[0]],
                                  [m for st in every[j] for m in st[1]])
                outs[j] = (rows(y, j), aux)
        return outs


class LMLossLayer(Layer):
    """kLMLoss: next-token cross-entropy over (B, S, V) logits.

    srclayers: (logits, kSequenceData). Position t's logits predict token
    t+1; the final position is dropped. Metrics: loss (mean NLL) and
    precision (next-token top-1 accuracy)."""

    TYPE = "kLMLoss"
    is_losslayer = True

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        if len(src_shapes) != 2:
            raise ConfigError(
                f"layer {self.name!r}: kLMLoss needs (logits, tokens) "
                f"srclayers, got {len(src_shapes)}"
            )
        if len(src_shapes[0]) != 3:
            raise ConfigError(
                f"layer {self.name!r}: logits must be (batch, seq, vocab)"
            )
        return src_shapes[0]

    def apply(self, params, inputs, *, training, generator=None):
        logits, feed = inputs
        tokens = feed["image"].long()
        logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
        targets = tokens[:, 1:]
        ll = torch.gather(logp, -1, targets[..., None])[..., 0]
        loss = -ll.mean()
        hit = logp.argmax(-1) == targets
        return loss, {
            "loss": loss,
            "precision": hit.float().mean(),
        }

    def crosses(self) -> bool:
        return self.mesh is not None and self.mesh.widths["seq"] > 1

    def apply_ranks(self, params, inputs, lanes, *, training):
        """The global sequence's loss per seq group: shard i's last
        position predicts shard i + 1's first token, the last shard drops
        its last position, and the mean runs over the group's B·(S−1)
        targets; every rank of the group takes it. The first tokens and
        each shard's sums (log-likelihood, hits) reach the group's lanes
        through exchanges over the seq axis, so a group may span
        processes; each lane sums the shards' in rank order."""
        nseq = lanes.mesh.widths["seq"]
        outs = [None] * len(params)
        for g in lanes.groups("seq"):
            firsts = lanes.exchange(
                g, [inputs[j][1]["image"][:, :1] for j in g], axes=("seq",))
            sums = []
            for j, first in zip(g, firsts):
                logits, feed = inputs[j]
                tokens = feed["image"].long()
                my = lanes.coords(j)["seq"]
                if my + 1 < nseq:
                    targets = torch.cat([tokens[:, 1:],
                                         first[my + 1].long()], 1)
                else:
                    logits, targets = logits[:, :-1], tokens[:, 1:]
                logp = F.log_softmax(logits.float(), dim=-1)
                ll = torch.gather(logp, -1, targets[..., None])
                hits = (logp.argmax(-1) == targets).sum().float()
                sums.append(torch.stack([ll.sum(), hits]))
            b, s = inputs[g[0]][1]["image"].shape
            count = b * (s * nseq - 1)
            for j, every in zip(g, lanes.exchange(g, sums, axes=("seq",))):
                total = rank_sum(every)
                loss = -total[0] / count
                outs[j] = (loss, {"loss": loss,
                                  "precision": total[1] / count})
        return outs
