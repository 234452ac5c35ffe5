"""Observability: the flight recorder (``recorder.py``), the PyTorch
counterpart of ``singa_tpu/obs``. The trace merge tool and the
profiler trigger are not ported (ROADMAP.md)."""

from .recorder import FlightRecorder

__all__ = ["FlightRecorder"]
