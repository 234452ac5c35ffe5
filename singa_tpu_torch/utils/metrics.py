"""Metric averaging (the reference's Performance class).

Counterpart of ``singa_tpu/utils/metrics.py``. Worker::Performance
accumulates each loss layer's metric blob every step and prints the
element-wise average every display interval, then resets
(src/worker/worker.cc:350-386). Metrics arrive here as scalar tensors;
they stay on their device and are pulled to the host in one transfer
at avg() time, so accumulation never waits for the device.
"""

from __future__ import annotations

import numpy as np
import torch


class Performance:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._sums: dict[str, dict[str, object]] = {}
        self._count = 0

    def update(self, metrics: dict[str, dict]) -> None:
        """Accumulate one step's {losslayer: {metric: scalar}}: one
        running device scalar per metric, so memory stays constant over
        arbitrarily long display intervals."""
        self._count += 1
        for lname, m in metrics.items():
            bucket = self._sums.setdefault(lname, {})
            for k, v in m.items():
                v = v.detach() if isinstance(v, torch.Tensor) else v
                bucket[k] = v if k not in bucket else bucket[k] + v

    def update_summed(self, summed: dict[str, dict], nsteps: int) -> None:
        """Accumulate ``nsteps`` steps whose metrics are already summed
        on the device (a multi-step chunk's sums): no per-step host
        transfer, the same averages. ``nsteps <= 0`` is a no-op: a
        zero-length window carries no steps."""
        if nsteps <= 0:
            return
        self.update(summed)
        self._count += nsteps - 1

    @property
    def count(self) -> int:
        return self._count

    def avg(self) -> dict[str, dict[str, float]]:
        """Element-wise averages since the last reset (worker.cc:367-376),
        pulled to the host in ONE transfer."""
        n = max(self._count, 1)
        names = [(l, k) for l, b in self._sums.items() for k in b]
        if not names:
            return {}
        vals = torch.stack([
            torch.as_tensor(self._sums[l][k], dtype=torch.float32).reshape(())
            .to(self._device(), torch.float32)
            for l, k in names
        ]).cpu().numpy()
        out: dict[str, dict[str, float]] = {}
        for (l, k), v in zip(names, np.asarray(vals)):
            out.setdefault(l, {})[k] = float(v) / n
        return out

    def _device(self):
        for bucket in self._sums.values():
            for v in bucket.values():
                if isinstance(v, torch.Tensor):
                    return v.device
        return torch.device("cpu")

    def to_string(self, avg: dict | None = None) -> str:
        """One-line display like Worker's "loss : 2.301, precision : 0.11".
        Pass an already-computed ``avg()`` dict to avoid a second
        transfer."""
        parts = []
        for lname, bucket in sorted((avg or self.avg()).items()):
            inner = ", ".join(f"{k} : {v:.6g}" for k, v in sorted(bucket.items()))
            parts.append(f"{lname} [{inner}]" if len(self._sums) > 1 else inner)
        return ", ".join(parts) if parts else "no metrics"
