"""Observability utilities: metric averaging and phase timers."""

from .metrics import Performance
from .timers import Timers

__all__ = ["Performance", "Timers"]
