"""Sequence-modeling layers: the conf-driven transformer LM vocabulary.

Counterpart of ``singa_tpu/layers/sequence.py``: (B, S) tokens from
kSequenceData, through kEmbedding -> (B, S, D), residual blocks built
from kLayerNorm / kAttention / kDense / kAdd, into kLMLoss (next-token
cross-entropy), with kMoE's dense path in place of a block's FFN.
kEmbedding and kAttention carry the ``decode_step`` hooks of the
conf-net KV-cache decode (``serve/conf_decode.py``); kLayerNorm and
kDense are position-wise and decode through ``apply``.

Numerical points where PyTorch's defaults differ from JAX's:
``jax.nn.gelu`` is the tanh approximation and ``jnp.var`` the
population variance; the layers below ask for both explicitly.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..config.schema import ConfigError
from ..ops.attention import attention, auto_attention
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

    ``mode`` "flash" (and "ring", which has no sequence mesh to ride in
    this single-device port) picks dense or the flash kernels by the
    score footprint (``ops.attention.auto_attention``, one device);
    anything else is dense."""

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
            0, "qkv", (d, 3 * d), fan_in=d
        )
        self.out = self._declare_param(
            1, "out", (d, d), fan_in=d
        )
        return src

    def apply(self, params, inputs, *, training, generator=None):
        x = inputs[0]
        b, s, d = x.shape
        w = params[self.qkv]
        qkv = (x.to(w.dtype) @ w).reshape(
            b, s, 3, self.heads, d // self.heads
        )
        q, k, v = (qkv[:, :, j].movedim(2, 1) for j in range(3))
        if self.mode in ("flash", "ring"):
            o = auto_attention(q, k, v, causal=True, n_devices=1)
        else:
            o = attention(q, k, v, causal=True)
        o = o.movedim(1, 2).reshape(b, s, d)
        return o.to(w.dtype) @ params[self.out]

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
            0, "weight", (d, self.hdim), fan_in=d
        )
        self.bias_term = p.bias_term
        if self.bias_term:
            self.b = self._declare_param(1, "bias", (self.hdim,))
        return (*src[:-1], self.hdim)

    def apply(self, params, inputs, *, training, generator=None):
        w = params[self.w]
        out = inputs[0].to(w.dtype) @ w
        if self.bias_term:
            out = out + params[self.b]
        if self.activation == "gelu":
            out = F.gelu(out, approximate="tanh")
        elif self.activation == "relu":
            out = F.relu(out)
        return out


class MoELayer(Layer):
    """kMoE: Switch-style top-1 mixture-of-experts FFN, the dense path
    (``parallel/moe.py``'s index form). ``apply`` returns (out, aux):
    the load-balancing aux loss joins Net.forward's total loss with
    weight moe_param.aux_loss_weight. Expert parallelism (the JAX
    package's shard_map over an expert mesh axis) is not ported; the
    Trainer refuses a cluster with an expert axis by name."""

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
            1, "up", (self.n_experts, d, self.d_ff), fan_in=d)
        self.down = self._declare_param(
            2, "down", (self.n_experts, self.d_ff, d), fan_in=self.d_ff)
        return src

    def apply(self, params, inputs, *, training, generator=None):
        from ..parallel.moe import moe_ffn_dense

        p = {"gate": params[self.gate], "up": params[self.up],
             "down": params[self.down]}
        return moe_ffn_dense(inputs[0], p, self.capacity_factor)


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
