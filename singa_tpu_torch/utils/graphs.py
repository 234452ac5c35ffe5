"""The step as a CUDA graph: the port's counterpart of ``jax.jit`` for
one step (and of a ``lax.scan`` chunk: N replays, no host work between
them).

This module has no JAX module to copy: the JAX package compiles a step
with ``jax.jit`` and a chunk with ``lax.scan``, which PyTorch does not
have. Here a *body* is a Python callable with no arguments that reads
and writes only tensors at fixed addresses (the caller's static
buffers: params, updater slots, a step counter, stream positions, the
cached dataset or a static batch buffer, metric sums). :class:`Graphed`
runs it:

- on the CPU, or with graphs off: the body is called once per step;
- on the card: the first ``warm`` calls run the body eagerly on a side
  stream (they are real steps: cuBLAS and cuDNN set up their
  workspaces, the kernel libraries load); the next call captures the
  body into a ``torch.cuda.CUDAGraph`` on that stream, which executes
  nothing, then replays it; every later call replays it.

A capture failure raises; nothing turns graphed work into eager work.
The body must not synchronize with the host (no ``.item()``, ``int()``
of a tensor, ``.cpu()``, ``torch.tensor(..., device=cuda)``, or a
Python branch on device data); capture fails on those.

Launch counts: the kernel wrappers count launches in Python
(``flash_fwd.launches += 1``), which runs once, at capture. The capture
is undone (each count put back) and every replay adds the counts seen
at capture, so a count still says how many times the kernel ran.
"""

from __future__ import annotations

from typing import Callable

import torch


def launch_counters() -> list:
    """Every kernel wrapper that counts its launches."""
    from ..ops import attention as ta
    from ..ops import paged_attention as pa
    from ..ops import quantized_collective as qc

    return [ta.flash_fwd, ta.flash_bwd_dq, ta.flash_bwd_dkv,
            pa.paged_attention, pa.paged_attention_overlay, qc.quant_acc]


class Graphed:
    """``body`` replayed as a CUDA graph on ``device`` (a ``cuda``
    device and ``enabled``), else called. ``g(n)`` runs ``n`` steps."""

    def __init__(self, body: Callable[[], None], device, *,
                 enabled: bool = True, warm: int = 1):
        self.body = body
        self.device = torch.device(device)
        self.enabled = enabled and self.device.type == "cuda"
        self.warm = warm
        self.graph: torch.cuda.CUDAGraph | None = None
        #: counter wrapper -> launches its kernel made at capture
        self._delta: dict = {}
        self._stream = None
        #: eager body calls and graph replays so far
        self.eager_calls = 0
        self.replays = 0

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self, n: int = 1) -> None:
        if not self.enabled:
            for _ in range(n):
                self.body()
            self.eager_calls += n
            return
        while n and self.graph is None and self.eager_calls < self.warm:
            self._eager()
            n -= 1
        if n and self.graph is None:
            self._capture()
        for _ in range(n):
            self.graph.replay()
            for wrapper, d in self._delta.items():
                wrapper.launches += d
        self.replays += n

    def _side(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _eager(self) -> None:
        """One real step on the side stream the capture will use."""
        cur = torch.cuda.current_stream(self.device)
        side = self._side()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.body()
        cur.wait_stream(side)
        self.eager_calls += 1

    def _capture(self) -> None:
        counters = launch_counters()
        before = [w.launches for w in counters]
        graph = torch.cuda.CUDAGraph()
        side = self._side()
        side.wait_stream(torch.cuda.current_stream(self.device))
        try:
            # thread_local: the input feeders' threads keep copying on
            # their own streams while this thread captures
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                self.body()
        finally:
            after = [w.launches for w in counters]
            for w, b in zip(counters, before):
                w.launches = b
        self._delta = {w: a - b for w, a, b in zip(counters, after, before)
                       if a != b}
        self.graph = graph
