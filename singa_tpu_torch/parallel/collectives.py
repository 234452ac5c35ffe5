"""Quantized gradient collectives (``grad_comm``): the trainer-side seam.

Counterpart of ``singa_tpu/parallel/collectives.py``. ``grad_comm {
mode: quantized }`` casts each bucket of gradients to a scaled
low-precision wire format (symmetric int8 with one max-abs scale per
bucket, or bf16) around the data-axis reduction and dequantizes after
it. With ``error_feedback`` (default on) each param carries a
persistent residual buffer (``__gradres__/<param>``) that is added back
into the next step's gradient before quantization; the new residual is
the fresh quantization error (EF-SGD). The residuals live in the
Trainer's buffers, so they checkpoint with the rest of its state under
the ``b|`` keys the JAX package uses.

``buckets: N`` groups the params into N buckets in reverse topological
order, the order backward produces their gradients; a bucket also sets
the granularity of the int8 scale (``buckets: 0`` or 1: one scale per
param). The JAX package chains the buckets with an
``optimization_barrier`` so that XLA issues their collectives in that
order; an eager program issues them in program order, so nothing here
stands for the barrier.

``kernels { grad_allreduce }`` picks how the quantized reduction
crosses the data axis: ``reference`` (:func:`reduce_gradients` on the
summed gradients, the oracle), ``quantized_ring`` or ``q8_hier`` (the
int8 ring of ``ops/quantized_collective.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.quantized_collective import (
    dequantize_int8,
    quantize_int8,
    symmetric_scale,
)

#: buffer namespace of the error-feedback residuals (never collides with
#: layer buffers, which are namespaced by layer name)
RESIDUAL_PREFIX = "__gradres__/"


def residual_key(name: str) -> str:
    """Buffer key of param ``name``'s error-feedback residual."""
    return RESIDUAL_PREFIX + name


def is_residual_key(key: str) -> bool:
    return key.startswith(RESIDUAL_PREFIX)


@dataclasses.dataclass(frozen=True)
class GradCommSpec:
    """The trainer-facing slice of the ``grad_comm`` block, with the
    ``kernels { grad_allreduce, interpret }`` knobs and the ``ring {}``
    geometry (named axes or the factored ``intra_degree``)."""

    mode: str = "exact"  # "exact" | "quantized"
    dtype: str = "int8"  # wire dtype for quantized mode: "int8" | "bf16"
    error_feedback: bool = True
    buckets: int = 0  # 0/1 = one bucket per param
    #: "reference", "quantized_ring" or "q8_hier"
    wire_impl: str = "reference"
    #: the JAX package's interpret knob: the port's hop always runs the
    #: quant_acc kernel, and interpret false only keeps the JAX package's
    #: refusal of geometry its compiled TPU kernel cannot tile
    interpret: bool = True
    #: q8_hier's named axes (``ring { intra_axis / inter_axis }``): the
    #: full-precision intra rings ride the first, the int8 inter ring
    #: the second; "" = the factored form
    intra_axis: str = ""
    inter_axis: str = ""
    #: q8_hier's group width K (``ring { intra_degree }``); 0 = none
    intra_degree: int = 0

    @property
    def quantized(self) -> bool:
        return self.mode == "quantized"

    @property
    def overlapped(self) -> bool:
        return self.buckets > 1

    @property
    def ring(self) -> bool:
        """Whether the reduction is the explicit int8 ring (flat or
        hierarchical) rather than the reference seam."""
        return self.wire_impl in ("quantized_ring", "q8_hier")

    @property
    def hier(self) -> bool:
        return self.wire_impl == "q8_hier"

    @property
    def wants_residuals(self) -> bool:
        """Whether the step carries error-feedback residual buffers."""
        return self.quantized and self.error_feedback

    @staticmethod
    def from_config(cfg, kernels=None, ring=None) -> "GradCommSpec | None":
        """-> GradCommSpec, or None when the block is absent or inert
        (mode exact, no buckets). A ring impl without an active quantized
        ``grad_comm`` block raises ConfigError, as in the JAX package."""
        impl = (
            kernels.grad_allreduce if kernels is not None else "reference"
        )
        interpret = bool(kernels.interpret) if kernels is not None else True
        if impl in ("quantized_ring", "q8_hier") and (
            cfg is None or cfg.mode != "quantized"
        ):
            from ..config.schema import ConfigError

            raise ConfigError(
                f"kernels {{ grad_allreduce: {impl} }} needs an "
                "active grad_comm { mode: quantized } block: the ring is "
                "the quantized collective's wire implementation"
            )
        if cfg is None:
            return None
        spec = GradCommSpec(
            mode=cfg.mode,
            dtype=cfg.dtype,
            error_feedback=bool(cfg.error_feedback),
            buckets=max(0, int(cfg.buckets)),
            wire_impl=impl,
            interpret=interpret,
            intra_axis=ring.intra_axis if ring is not None else "",
            inter_axis=ring.inter_axis if ring is not None else "",
            intra_degree=(
                max(0, int(ring.intra_degree)) if ring is not None else 0
            ),
        )
        if not spec.quantized and not spec.overlapped:
            return None
        return spec


def apply_grad_comm_tag(cfg, tag: str):
    """CLI shorthand -> ``cfg.grad_comm``: ``q8`` = quantized int8 +
    error feedback, ``bf16`` = quantized bf16, ``q8wire`` = q8 through the
    int8 ring (``kernels { grad_allreduce: quantized_ring }``), ``q8hier``
    = q8 through the hierarchical ring (``q8_hier`` + ``ring {
    intra_degree: 2 }`` when the conf declares no geometry), ``exact`` =
    an explicit (inert) exact block, "" = leave untouched."""
    if not tag:
        return cfg
    from ..config.schema import GradCommConfig, KernelsConfig, RingConfig

    gc = GradCommConfig()
    if tag == "exact":
        gc.mode = "exact"
    elif tag in ("q8", "q8wire", "q8hier"):
        gc.mode, gc.dtype = "quantized", "int8"
    elif tag == "bf16":
        gc.mode, gc.dtype = "quantized", "bf16"
    else:
        raise ValueError(
            f"unknown grad_comm tag {tag!r} (choose exact, q8, q8wire, "
            "q8hier, bf16)"
        )
    cfg.grad_comm = gc
    if tag in ("q8wire", "q8hier"):
        kern = cfg.kernels if cfg.kernels is not None else KernelsConfig()
        kern.grad_allreduce = (
            "q8_hier" if tag == "q8hier" else "quantized_ring"
        )
        cfg.kernels = kern
    if tag == "q8hier" and cfg.ring is None:
        ring = RingConfig()
        ring.intra_degree = 2
        cfg.ring = ring
    return cfg


def init_residuals(params: dict, spec: GradCommSpec | None) -> dict:
    """Fresh float32 zero residuals, one per param and of its shape, on
    its device, keyed by ``residual_key``. Empty when the spec carries
    none."""
    if spec is None or not spec.wants_residuals:
        return {}
    return {
        residual_key(n): torch.zeros(v.shape, dtype=torch.float32,
                                     device=v.device)
        for n, v in params.items()
    }


def reverse_topo_buckets(
    net, names: frozenset, nbuckets: int, specs: dict
) -> tuple[tuple[str, ...], ...]:
    """Partition ``names`` into reduction buckets in REVERSE topological
    layer order — the order the backward pass produces their gradients.

    ``nbuckets <= 1`` yields one bucket per param; otherwise at most
    ``nbuckets`` contiguous groups, greedily balanced by element count
    (``specs`` supplies the shapes). Every name appears exactly once.
    """
    ordered: list[str] = []
    seen: set[str] = set()
    for layer in reversed(net.layers):
        for n in layer.param_specs():
            if n in names and n not in seen:
                seen.add(n)
                ordered.append(n)
    # grads for params no layer declares (defensive): stable tail
    ordered.extend(sorted(names - seen))
    if nbuckets <= 1:
        return tuple((n,) for n in ordered)
    sizes = {
        n: max(1, math.prod(specs[n].shape)) if n in specs else 1
        for n in ordered
    }
    total = sum(sizes[n] for n in ordered)
    target = total / nbuckets
    out: list[tuple[str, ...]] = []
    cur: list[str] = []
    acc = 0
    for n in ordered:
        cur.append(n)
        acc += sizes[n]
        # close the bucket once it reaches its share — unless closing
        # would leave more names than remaining buckets can hold
        if acc >= target and len(out) < nbuckets - 1:
            out.append(tuple(cur))
            cur, acc = [], 0
    if cur:
        out.append(tuple(cur))
    return tuple(out)


def reduce_gradients(
    grads: dict,
    buffers: dict,
    spec: GradCommSpec,
    buckets: tuple[tuple[str, ...], ...],
) -> tuple[dict, dict]:
    """The reference seam on already-summed gradients: -> (update-ready
    grads, residual-buffer updates).

    Per bucket: add the error-feedback residuals back, cast to the wire
    dtype (int8 with the bucket's max-abs scale, or bf16), dequantize,
    and bank the fresh quantization error as the next residual. The JAX
    package applies its data-axis layout constraint to the wire tensor
    here; under the port's replicated update that constraint is the
    identity. ``mode: exact`` with buckets > 1 leaves the values as
    they are."""
    out: dict = {}
    new_res: dict = {}
    for bucket in buckets:
        gs = {n: grads[n] for n in bucket}
        if not spec.quantized:
            out.update(gs)
            continue
        es = {}
        for n, g in gs.items():
            r = buffers.get(residual_key(n)) if spec.error_feedback else None
            es[n] = g if r is None else g + r.to(g.dtype)
        scale = symmetric_scale(es.values()) if spec.dtype == "int8" else None
        for n, e in es.items():
            if spec.dtype == "int8":
                ghat = dequantize_int8(quantize_int8(e, scale),
                                       scale).to(e.dtype)
            else:  # bf16
                ghat = e.to(torch.bfloat16).to(e.dtype)
            if spec.error_feedback:
                new_res[residual_key(n)] = e.float() - ghat.float()
            out[n] = ghat
    return out, new_res
