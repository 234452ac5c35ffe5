"""Serving tier: continuous-batching inference with a paged KV cache,
the PyTorch counterpart of ``singa_tpu/serve``.

  ``kv_pool``      block-pool KV allocation (a copy of the JAX package's
                   host-side bookkeeping): fixed-size per-layer pools +
                   per-sequence block tables.
  ``engine``       the compute plane: prefill / decode / verify over a
                   slot-batched state, attention through the CUDA
                   paged-attention kernel (``attend_impl="fused"``) or
                   the gather + ``cache_attend`` oracle.
  ``scheduler``    continuous batching: admission with backpressure
                   (through the prefix cache when it is on), chunked
                   prefill, decode or speculative verify ticks,
                   retirement on EOS/budget.
  ``speculate``    model-free drafters for the verify tick (a copy).
  ``conf_decode``  KV-cache decode over a conf-built Net (the
                   ``tools/generate.py`` path).
  ``fleet``        ``migrate``: a slot, cached blocks or a weight version
                   as one frame in the JAX package's format.
"""

from .engine import Admission, Engine, EngineConfig  # noqa: F401
from .kv_pool import BlockAllocator, KVPool, PrefixCache  # noqa: F401
from .scheduler import Request, Scheduler  # noqa: F401
from .speculate import NGramDrafter, NullDrafter, make_drafter  # noqa: F401
