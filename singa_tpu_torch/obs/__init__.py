"""Observability: the flight recorder (``recorder.py``), the PyTorch
counterpart of ``singa_tpu/obs``: a per-process structured event log of
the training and serving lifecycles, with span-mode phase timers, and
the ``profile@K`` trigger (``resilience/context.py``) bracketing steps
with ``torch.profiler``. ``python -m singa_tpu_torch.tools.trace`` merges
the per-process logs into one Chrome trace or an incident summary."""

from .recorder import FlightRecorder, config_hash, recorder_for_job

__all__ = ["FlightRecorder", "config_hash", "recorder_for_job"]
