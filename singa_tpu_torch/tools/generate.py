"""Sample from a trained config-surface LM checkpoint.

Counterpart of ``singa_tpu/tools/generate.py``, with its flags and its
output bytes, plus ``-device``:

    python -m singa_tpu_torch.tools.generate \\
        -model_conf examples/lm/tinylm.conf \\
        -checkpoint ws/checkpoints/step_2000.npz \\
        -prompt "hello " -n 64 [-temperature 0.8] [-seed 0] [-raw] \\
        [-device cpu]

The checkpoint is an npz save of either package. Decode rides the
serving tier's KV-cache path (serve/conf_decode.NetDecoder) whenever
the net's graph supports incremental apply and the requested length
fits the positional table: chunked prefill writes the prompt's K/V
once, then every emitted token is one (1, 1) cached step instead of a
full (1, S) forward. Unsupported graphs (convs, kMoE) and generations
past the window fall back to the rolling decode: a (1, S) buffer,
prompt left-aligned, logits read at the last live position through
``Net.forward(..., return_acts=True)``; slower, never another result.
The fallback is logged on stderr, as the JAX package logs it, and the
path that ran is reported (``info["path"]``; the CLI prints it on
stderr with the device and the decode time), so a fallback never
passes unseen.

Runs on the GPU unless ``-device cpu`` is given. Temperature sampling
draws from a ``torch.Generator`` seeded with ``-seed``: deterministic
under a seed, not the JAX package's stream.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="singa_tpu_torch.tools.generate", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("-model_conf", required=True)
    ap.add_argument("-checkpoint", required=True)
    ap.add_argument("-prompt", default="")
    ap.add_argument("-n", type=int, default=64)
    ap.add_argument("-temperature", type=float, default=0.0)
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument(
        "-raw", action="store_true",
        help="emit token ids (one line) instead of decoding bytes",
    )
    ap.add_argument("-device", default=None,
                    help="torch device; default cuda (raises without a GPU)")
    return ap


def _ensure_shard(cfg, vocab: int) -> None:
    """build_net reads the data shard (the embedding checks the vocab
    against the token stream); when the training shard is gone,
    synthesize a stub whose max token pins the same vocab."""
    import tempfile

    from ..data.loader import write_records

    for layer in cfg.neuralnet.layer:
        p = layer.data_param
        if layer.type == "kSequenceData" and p is not None:
            if not os.path.exists(p.path):
                stub = np.zeros((2, 16), dtype=np.uint8)
                stub[0, 0] = vocab - 1
                tmp = tempfile.mkdtemp(prefix="singa_gen_stub_")
                path = os.path.join(tmp, "stub_shard")
                write_records(path, stub, np.zeros((2,), np.uint8))
                p.path = path


def generate_from_net(net, params, prompt_tokens, n: int,
                      temperature: float, seed: int,
                      log=lambda s: None, serving=None,
                      info: dict | None = None) -> list[int]:
    """Decode over the conf net: KV-cache path when the graph supports
    it (serve/conf_decode.py), rolling-buffer recompute otherwise.
    ``serving`` is the job's parsed ``serving { }`` block (None =
    defaults); its ``max_prefill_chunk`` sizes the prefill chunks.
    ``info``, when given, receives ``path`` ("kv_cache" or "rolling")
    and, on a fallback, ``reason``."""
    from ..serve.conf_decode import NetDecoder, UnsupportedNet
    from ..serve.engine import EngineConfig

    info = {} if info is None else info
    try:
        dec = NetDecoder(
            net,
            max_prefill_chunk=EngineConfig.from_conf(
                serving
            ).max_prefill_chunk,
        )
        out = dec.generate(params, prompt_tokens, n, temperature, seed)
        info["path"] = "kv_cache"
        return out
    except UnsupportedNet as e:
        log(f"generate: KV-cache decode unavailable ({e}); "
            "falling back to rolling-buffer recompute")
        info["reason"] = str(e)
    info["path"] = "rolling"
    return rolling_generate_from_net(
        net, params, prompt_tokens, n, temperature, seed
    )


@torch.no_grad()
def rolling_generate_from_net(net, params, prompt_tokens, n: int,
                              temperature: float, seed: int) -> list[int]:
    """Rolling-buffer greedy/temperature decode over the conf net (the
    universal fallback, and the oracle the KV-cache path is tested
    against), on the params' device."""
    (dl,) = net.datalayers
    # sequence length = the data layer's declared window
    s = dl.out_shape[1]
    # the logits layer is whatever feeds the LM loss
    (loss_layer,) = net.losslayers
    head = next(src for src in loss_layer.srclayers if src != dl.name)
    dev = next(iter(params.values())).device
    label = torch.zeros((1,), dtype=torch.int32, device=dev)

    def logits_at(tokens, pos):
        batch = {dl.name: {"image": tokens, "label": label}}
        _, _, acts = net.forward(params, batch, training=False,
                                 return_acts=True)
        return acts[head][0, pos]

    toks = list(prompt_tokens)
    if not toks:
        toks = [0]
    if len(toks) >= s:
        toks = toks[-(s - 1):]
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = list(toks)
    for _ in range(n):
        window = out[-(s - 1):] if len(out) >= s else out
        buf = torch.zeros((1, s), dtype=torch.int32)
        buf[0, :len(window)] = torch.tensor(window, dtype=torch.int32)
        lg = logits_at(buf.to(dev), len(window) - 1)
        if temperature <= 0.0:
            nxt = int(lg.argmax())
        else:
            probs = (lg.float() / temperature).softmax(-1)
            nxt = int(torch.multinomial(probs, 1, generator=gen))
        out.append(nxt)
    return out


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from ..config import load_model_config
    from ..device import resolve_device
    from ..graph.builder import build_net
    from ..trainer.checkpoint import load_checkpoint

    dev = resolve_device(args.device)
    step, params, _state, _buffers = load_checkpoint(args.checkpoint)
    embed = next(
        (v for k, v in params.items() if k.endswith("/tok")), None
    )
    if embed is None:
        print("checkpoint has no token embedding (not an LM job?)",
              file=sys.stderr)
        return 2
    vocab = embed.shape[0]
    cfg = load_model_config(args.model_conf)
    _ensure_shard(cfg, vocab)
    net = build_net(cfg, "kTest")

    params = {k: torch.from_numpy(np.array(v)).to(dev)
              for k, v in params.items()}
    prompt = [b % vocab for b in args.prompt.encode()]
    info: dict = {}
    t0 = time.perf_counter()
    toks = generate_from_net(
        net, params, prompt, args.n, args.temperature, args.seed,
        log=lambda s: print(s, file=sys.stderr), serving=cfg.serving,
        info=info,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    print(f"generate: path {info['path']}, device {dev}, {args.n} tokens "
          f"in {ms:.1f} ms", file=sys.stderr)
    if args.raw:
        print(" ".join(str(t) for t in toks))
    else:
        sys.stdout.buffer.write(bytes(t % 256 for t in toks))
        sys.stdout.buffer.write(b"\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
