"""Device resolution and float32 precision settings for the port.

Every entry point of ``singa_tpu_torch`` (``init_lm``,
``load_jax_params``, ``Engine``, the serve_bench tool) takes a
``device`` argument and passes it through :func:`resolve_device`:

- ``None`` means the GPU (``cuda``). Without one it raises: nothing
  falls back to the CPU silently, because a number measured on the CPU
  must never pass for a device number.
- ``"cpu"`` must be asked for explicitly (the CPU tests do).

Precision: the JAX package computes in full float32 (XLA's CPU and the
TPU's f32 path), so the port turns TF32 off for both cuBLAS matmuls and
cuDNN convolutions. A float32 matmul on the card then runs in full
float32 (``torch.get_float32_matmul_precision() == "highest"``).
cuDNN's autotuner stays off (``cudnn.benchmark``), so a convolution
picks the same algorithm in an eager step and in a captured graph.
cuDNN's deterministic mode stays off as well: its float32
weight-gradient kernel for AlexNet's convolutions (``wgrad_alg0_engine``)
adds with atomics, so two runs of the same step may differ in the last
bits, and the deterministic kernel cuDNN takes instead cost 0.48 ms of
AlexNet's 1.58 ms step on an H100, against 0.14 ms.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); anything else is
    taken as given, and a CUDA device is checked to exist. Sets full
    float32 everywhere: no TF32 in matmuls or convolutions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "singa_tpu_torch runs on the GPU by default and no CUDA device "
            "is available; pass device='cpu' to run on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.set_float32_matmul_precision("highest")
    return dev
