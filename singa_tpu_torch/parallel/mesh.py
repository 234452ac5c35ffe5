"""The data-parallel mesh: rank -> torch device.

Counterpart of ``singa_tpu/parallel/mesh.py``, data axis only. The JAX
package maps the reference's worker groups onto a (data, model) device
mesh; the port's mesh is the data axis alone, a tuple that gives each
rank its device. A device may repeat: several ranks on one card run an
n-wide data axis on one GPU, as the JAX package's tests run one on
XLA's virtual host devices. A model, seq, expert or pipe width above 1
raises a ConfigError that names it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config.schema import ClusterConfig, ConfigError
from ..device import resolve_device

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[r]`` is rank r's device on the data axis."""

    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices)}


def _visible_gpus() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device(d) -> torch.device:
    """A torch device with its index filled in, so that two ranks on one
    card compare equal however they were named."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def build_mesh(ndata: int = 1, nmodel: int = 1, devices=None) -> Mesh:
    """A mesh of ``ndata`` ranks over the first ``ndata`` of ``devices``
    (default: the visible GPUs). ``nmodel`` above 1 raises: the model
    axis is not ported."""
    if nmodel > 1:
        raise ConfigError(
            f"model axis width {nmodel}: singa_tpu_torch ports the data "
            "axis only"
        )
    devices = _visible_gpus() if devices is None else list(devices)
    if ndata > len(devices):
        raise ConfigError(
            f"mesh wants {ndata}x{nmodel}={ndata * nmodel} devices, "
            f"only {len(devices)} visible"
        )
    return Mesh(tuple(_device(d) for d in devices[:ndata]))


def mesh_from_cluster(cluster: ClusterConfig | None, devices=None) -> Mesh:
    """The cluster's worker groups -> data-axis ranks over ``devices``
    (default: the visible GPUs). With no cluster, or no ``nworkers``,
    every device is a rank. A seq, expert, pipe or model width above 1
    raises, naming the axis."""
    if cluster is None or not cluster.nworkers:
        devices = _visible_gpus() if devices is None else list(devices)
        return build_mesh(len(devices), 1, devices)
    widths = cluster.axis_widths
    for axis in ("seq", "expert", "pipe"):
        if widths[axis] > 1:
            raise ConfigError(
                f"{axis} axis width {widths[axis]}: singa_tpu_torch ports "
                "the data axis only"
            )
    return build_mesh(widths["data"], widths["model"], devices)
