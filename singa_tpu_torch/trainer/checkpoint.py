"""Checkpoint/resume, and carrying params across from the JAX package.

Counterpart of ``singa_tpu/trainer/checkpoint.py``, in the same npz
format, so a checkpoint written by either package resumes in the
other:

  - ``__step__``: the resume step;
  - ``p|<param>``: params; ``s|<param>|<slot>``: updater slots;
  - ``b|<buffer>``: stateful-layer buffers; ``d|<phase>|<layer>``: each
    data stream's consumed position.

save_checkpoint writes atomically (tmp file + rename), so a crash
mid-write never corrupts the latest checkpoint. The JAX package's
sharded format is ``sharded_ckpt.py``.

:func:`params_from_numpy` turns the JAX package's param dict, exported
as numpy arrays, into the port's tensors with names and shapes checked;
with ``replicas`` it takes the replica engine's stacked ``(R, ...)``
arrays, replica r's params in row r.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """A checkpoint file is missing, unreadable, or corrupt."""


_STEP_KEY = "__step__"
_P = "p|"  # param arrays
_S = "s|"  # updater slot arrays, "s|<param>|<slot>"
_B = "b|"  # buffer arrays (stateful-layer state, e.g. BN running stats)
_D = "d|"  # data-stream positions, "d|<phase>|<layer>"


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def save_checkpoint(
    path: str,
    step: int,
    params: dict[str, torch.Tensor],
    state: dict[str, dict[str, torch.Tensor]] | None = None,
    buffers: dict[str, torch.Tensor] | None = None,
    streams: dict[str, int] | None = None,
) -> str:
    """Atomic .npz snapshot; returns the final path."""
    arrays: dict[str, np.ndarray] = {_STEP_KEY: np.int64(step)}
    for name, arr in params.items():
        arrays[_P + name] = _host(arr)
    for name, slots in (state or {}).items():
        for slot, arr in slots.items():
            arrays[f"{_S}{name}|{slot}"] = _host(arr)
    for name, arr in (buffers or {}).items():
        arrays[_B + name] = _host(arr)
    for name, pos in (streams or {}).items():
        arrays[_D + name] = np.int64(pos)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path) or ".", suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


@contextlib.contextmanager
def _open_checkpoint(path: str):
    """np.load with the CheckpointError policy."""
    try:
        with np.load(path) as z:
            yield z
    except CheckpointError:
        raise
    except FileNotFoundError:
        raise CheckpointError(f"checkpoint not found: {path!r}") from None
    except Exception as e:
        raise CheckpointError(
            f"corrupt or unreadable checkpoint {path!r}: "
            f"{type(e).__name__}: {e}"
        ) from e


def load_checkpoint(path: str):
    """-> (step, params, state, buffers) as numpy arrays. Raises
    CheckpointError on a missing or corrupt file."""
    with _open_checkpoint(path) as z:
        step = int(z[_STEP_KEY])
        params: dict[str, np.ndarray] = {}
        state: dict[str, dict[str, np.ndarray]] = {}
        buffers: dict[str, np.ndarray] = {}
        for key in z.files:
            if key.startswith(_P):
                params[key[len(_P):]] = z[key]
            elif key.startswith(_S):
                name, slot = key[len(_S):].rsplit("|", 1)
                state.setdefault(name, {})[slot] = z[key]
            elif key.startswith(_B):
                buffers[key[len(_B):]] = z[key]
    return step, params, state, buffers


def load_stream_positions(path: str) -> dict[str, int]:
    """-> {"<phase>|<layer>": consumed position} from the checkpoint."""
    with _open_checkpoint(path) as z:
        return {
            key[len(_D):]: int(z[key])
            for key in z.files
            if key.startswith(_D)
        }


def _like(arr: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(arr), dtype=ref.dtype).to(ref.device)


def restore_into(path, params, state, buffers=None):
    """Overlay a checkpoint onto freshly-initialized tensor dicts.

    Params present in the checkpoint replace their initialized values
    (kPretrained's zeros-then-fill contract); params absent from it keep
    their init. Shape mismatches are an error. -> (step, params, state,
    buffers), each tensor on its initialized counterpart's device."""
    step, ck_params, ck_state, ck_buffers = load_checkpoint(path)
    out_p = dict(params)
    for name, arr in ck_params.items():
        if name in out_p:
            if tuple(arr.shape) != tuple(out_p[name].shape):
                raise ValueError(
                    f"checkpoint {path!r}: param {name!r} shape "
                    f"{arr.shape} != model shape {tuple(out_p[name].shape)}"
                )
            out_p[name] = _like(arr, out_p[name])
    out_s = {n: dict(slots) for n, slots in state.items()}
    for name, slots in ck_state.items():
        if name in out_s:
            for slot, arr in slots.items():
                if slot in out_s[name]:
                    out_s[name][slot] = _like(arr, out_s[name][slot])
    out_b = dict(buffers or {})
    for name, arr in ck_buffers.items():
        if name in out_b:
            if tuple(arr.shape) != tuple(out_b[name].shape):
                raise ValueError(
                    f"checkpoint {path!r}: buffer {name!r} shape "
                    f"{arr.shape} != model shape {tuple(out_b[name].shape)}"
                )
            out_b[name] = _like(arr, out_b[name])
    return step, out_p, out_s, out_b


def params_from_numpy(net, arrays: dict, device=None,
                      replicas: int | None = None) -> dict:
    """The JAX package's param dict, exported as numpy, -> the port's
    float32 tensors on ``device`` (default: the CPU).

    The names must be exactly the net's owned params (shared params
    resolve through their owner) and every shape must match its spec,
    behind a leading axis of ``replicas`` when that is given (the
    replica engine's stacked params: ReplicaTrainer's ``params``)."""
    specs = {n: s for n, s in net.param_specs().items() if s.owner is None}
    missing = sorted(set(specs) - set(arrays))
    extra = sorted(set(arrays) - set(specs))
    if missing or extra:
        raise ValueError(
            f"params_from_numpy: missing {missing}, unexpected {extra}"
        )
    out = {}
    for name, spec in specs.items():
        arr = np.asarray(arrays[name], dtype=np.float32)
        want = tuple(spec.shape)
        if replicas is not None:
            want = (int(replicas),) + want
        if tuple(arr.shape) != want:
            raise ValueError(
                f"params_from_numpy: {name!r} has shape {arr.shape}, the "
                f"net declares {want}"
            )
        out[name] = torch.from_numpy(arr.copy()).to(device)
    return out
