"""KV-cache decode for conf-surface nets (the tools/generate.py path).

Counterpart of ``singa_tpu/serve/conf_decode.py``. The conf-driven LM
jobs (examples/lm/tinylm*.conf) train a fixed-(B, S) forward; sampling
from them by re-running that forward for every emitted token costs
O(S) a token. ``NetDecoder`` gives a built ``Net`` the serving tier's
incremental path instead: chunked prefill writes the prompt's K/V into
per-attention-layer caches, then each new token is one (1, 1) step
against them, through each layer's ``decode_step`` and the same
``cache_attend`` body as ``models/transformer.generate`` and the
engine's reference path.

Supported graphs: kSequenceData -> any DAG of position-wise layers
(``decode_positionwise``: kLayerNorm, kDense, kAdd) plus kEmbedding and
kAttention, into kLMLoss. Anything else (convs, pooling, kMoE) raises
``UnsupportedNet`` and the caller falls back to the rolling-buffer
recompute decode: slower, never another result. A pipeline-staged net
(one a Trainer on a pipe axis planned) decodes full-window too, as in
the JAX package.

Prefill chunks have the fixed shape (1, C) and a count of valid tokens:
padding tokens write K/V only at positions beyond every live query's
mask, which later real writes overwrite before anything attends there,
so chunking is split-invariant. The caches are written in place by
slice assignment; their length is rounded up to a multiple of C so a
final chunk's window [c0, c0 + C) always fits.

Sampling: greedy is argmax; temperature sampling draws with
``torch.multinomial`` from one ``torch.Generator`` seeded from ``seed``
on the logits' device (the port's RNG, not JAX's: temperature streams
are deterministic under a seed, not equal to the JAX package's).
"""

from __future__ import annotations

import torch


class UnsupportedNet(ValueError):
    """The graph has a layer the incremental decode cannot serve."""


class NetDecoder:
    """Incremental (KV-cache) token decoder over a built conf Net."""

    def __init__(self, net, *, max_prefill_chunk: int = 32):
        self.net = net
        self.chunk = int(max_prefill_chunk)
        (self.datalayer,) = net.datalayers
        if len(net.losslayers) != 1:
            raise UnsupportedNet("decode needs exactly one loss layer")
        (loss,) = net.losslayers
        self.head = next(
            s for s in loss.srclayers if s != self.datalayer.name
        )
        self.attn_layers = []
        for layer in net.layers:
            if layer.is_datalayer or layer.is_losslayer:
                continue
            if hasattr(layer, "decode_step"):
                if layer.TYPE == "kAttention":
                    self.attn_layers.append(layer)
                continue
            if not layer.decode_positionwise:
                raise UnsupportedNet(
                    f"layer {layer.name!r} ({layer.TYPE}) has no "
                    "incremental decode"
                )
        if net.pipeline_plan is not None:
            raise UnsupportedNet("pipeline-staged nets decode full-window")
        # cache capacity: the embedding's positional table bounds how far
        # absolute positions can run
        embeds = [l for l in net.layers if l.TYPE == "kEmbedding"]
        if len(embeds) != 1:
            raise UnsupportedNet("decode needs exactly one kEmbedding")
        self.embed = embeds[0]
        self.max_positions = int(
            net.param_specs()[self.embed.pos].shape[0]
        )
        # rounded UP to a chunk multiple: a final prefill chunk's window
        # [c0, c0 + chunk) must always fit (the JAX package's
        # dynamic_update_slice would clamp its start and overwrite
        # earlier positions); the tail is permanently masked
        self.cache_len = -(-self.max_positions // self.chunk) * self.chunk

    def init_caches(self, device, dtype=torch.float32) -> dict:
        """{attention layer name: (k, v)} zero caches, (1, H, C, D)."""
        out = {}
        for layer in self.attn_layers:
            d = layer.out_shape[-1]
            h = layer.heads
            out[layer.name] = tuple(
                torch.zeros((1, h, self.cache_len, d // h), dtype=dtype,
                            device=device)
                for _ in range(2)
            )
        return out

    @torch.no_grad()
    def _step_impl(self, params, tokens, caches, pos: int, n_valid: int):
        """tokens (1, Q) at absolute positions [pos, pos + Q) -> logits
        at the last VALID position; ``caches`` are written in place.
        Walks the graph in Net.forward's topo order: attention layers
        thread their cache, everything else applies position-wise."""
        net = self.net
        resolved = net.resolve_params(params)
        acts: dict = {}
        for layer in net.layers:
            if layer.is_datalayer:
                acts[layer.name] = tokens
                continue
            if layer.is_losslayer:
                continue
            inputs = [acts[s] for s in layer.srclayers]
            if layer.TYPE == "kEmbedding":
                acts[layer.name] = layer.decode_step(
                    resolved, inputs[0], pos
                )
            elif layer.TYPE == "kAttention":
                acts[layer.name], _ = layer.decode_step(
                    resolved, inputs[0], caches[layer.name], pos
                )
            else:
                acts[layer.name] = layer.apply(
                    resolved, inputs, training=False, generator=None
                )
        logits = acts[self.head][0]  # (Q, vocab)
        return logits[max(n_valid - 1, 0)]

    def generate(self, params, prompt_tokens, n: int, temperature: float,
                 seed: int) -> list[int]:
        """prompt ids -> prompt + n generated ids, via chunked prefill +
        per-token KV-cache decode on the params' device. Raises
        UnsupportedNet when the total length exceeds the positional
        table (the rolling-buffer path slides its window; a KV cache
        cannot)."""
        toks = [int(t) for t in prompt_tokens] or [0]
        if len(toks) + n > self.max_positions:
            raise UnsupportedNet(
                f"prompt {len(toks)} + n {n} exceeds the positional "
                f"table ({self.max_positions}); use the rolling decode"
            )
        dev = next(iter(params.values())).device
        caches = self.init_caches(dev)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        out = list(toks)
        last = None
        for c0 in range(0, len(toks), self.chunk):
            chunk = toks[c0:c0 + self.chunk]
            buf = torch.zeros((1, self.chunk), dtype=torch.long)
            buf[0, :len(chunk)] = torch.tensor(chunk)
            last = self._step_impl(params, buf.to(dev), caches, c0,
                                   len(chunk))
        for i in range(n):
            if temperature <= 0.0:
                nxt = int(last.argmax())
            else:
                probs = (last.float() / temperature).softmax(-1)
                nxt = int(torch.multinomial(probs, 1, generator=gen))
            out.append(nxt)
            if i + 1 < n:
                last = self._step_impl(
                    params, torch.full((1, 1), nxt, dtype=torch.long,
                                       device=dev),
                    caches, len(out) - 1, 1,
                )
        return out
