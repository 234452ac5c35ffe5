"""NN ops: convolution, pooling, LRN, dropout, softmax loss.

Counterpart of ``singa_tpu/ops/nn.py``, which replaces the reference's
mshadow DNN vocabulary (include/mshadow/tensor_expr_ext.h:354-577) with
XLA lowerings; here convolution is cuDNN's (``F.conv2d``, TF32 off by
``device.resolve_device``) and the rest is ATen. All arrays are NCHW,
the reference's layout.

Where the reference's semantics differ from PyTorch's defaults:

- pooling is ceil mode with a window that may overhang the bottom and
  right edges (layer.cc:496-500). ``ceil_mode=True`` drops a last window
  that starts past the input, which the reference keeps (H 5, k 1, s 3
  gives 3 outputs there and 2 in PyTorch), so the input is padded
  explicitly and pooled VALID;
- average pooling divides every window by the full k², overhang
  included (layer.cc:517-519);
- max pooling's backward gives dy to every input position that equals
  its window's max (mshadow's unpool, tensor_expr_ext.h:482), where
  PyTorch's picks one winner.

Not ported: the JAX package's space-to-depth rewrite of strided stem
convs (``_s2d_profitable``/``_conv2d_space_to_depth``). It computes the
same convolution and exists to fill the TPU's 128-lane MXU for
three-channel inputs; cuDNN picks its own algorithm for such shapes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.rng import on_device


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    pad: int = 0,
) -> torch.Tensor:
    """2-D convolution over NCHW input (ConvolutionLayer::ComputeFeature,
    reference layer.cc:63-83): out = weight @ im2col(pad(x)) + bias.

    ``weight`` is (F, C*k*k), the reference's col-matrix layout, or (F,
    C, k, k): mshadow's unpack_patch2col orders rows (c, kh, kw)
    row-major, so the reshape is exactly OIHW."""
    if weight.dim() == 2:
        nf = weight.shape[0]
        c = x.shape[1]
        k = int(round((weight.shape[1] // c) ** 0.5))
        weight = weight.reshape(nf, c, k, k)
    # under compute_dtype the weights are bf16 and parser outputs float32:
    # align to the weight dtype, as the JAX package does
    x = x.to(weight.dtype)
    return F.conv2d(x, weight, bias, stride=stride, padding=pad)


def pooled_size(size: int, kernel: int, stride: int) -> int:
    """Reference pooling output size — ceil mode, window may overhang
    (src/worker/layer.cc:496-500): ceil((size - kernel)/stride) + 1."""
    return -((size - kernel) // -stride) + 1


def _pad_ceil(x: torch.Tensor, kernel: int, stride: int,
              value: float) -> torch.Tensor:
    """Pad bottom/right with ``value`` so that ceil-mode windows tile the
    input VALID."""
    h, w = x.shape[-2:]
    ph = (pooled_size(h, kernel, stride) - 1) * stride + kernel
    pw = (pooled_size(w, kernel, stride) - 1) * stride + kernel
    if ph == h and pw == w:
        return x
    return F.pad(x, (0, pw - w, 0, ph - h), value=value)


#: input elements at or below which max pooling's backward shares the
#: gradient among ties (the JAX package's threshold, where its
#: phase-decomposed VJP gives way to XLA's select_and_scatter)
_PHASE_POOL_MAX_ELEMS = int(32e6)


def max_pool2d(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """pool<red::maximum> (reference: layer.cc:514-516).

    At or below _PHASE_POOL_MAX_ELEMS input elements the backward gives
    dy to EVERY input position equal to its window's max, mshadow's
    unpool semantics, as the JAX package's custom VJP does. Above it,
    autograd's single winner, like the JAX package's autodiff path there:
    both pick the first maximal position of the window in row-major
    order (ATen's strict ``>`` scan; XLA's select_and_scatter with
    ``ge``)."""
    if x.numel() <= _PHASE_POOL_MAX_ELEMS:
        return _MaxPoolTies.apply(x, kernel, stride)
    return F.max_pool2d(_pad_ceil(x, kernel, stride, float("-inf")),
                        kernel, stride)


class _MaxPoolTies(torch.autograd.Function):
    """Max pool whose backward shares dy among tied maxima: for each of
    the k² window offsets, the strided view of the padded input that
    offset reads gets dy where it equals the window's max. Overlapping
    windows add up, like mshadow's unpool."""

    @staticmethod
    def forward(ctx, x, kernel, stride):
        xp = _pad_ceil(x, kernel, stride, float("-inf"))
        y = F.max_pool2d(xp, kernel, stride)
        ctx.save_for_backward(xp, y)
        ctx.geom = (kernel, stride, x.shape[-2], x.shape[-1])
        return y

    @staticmethod
    def backward(ctx, dy):
        xp, y = ctx.saved_tensors
        k, s, h, w = ctx.geom
        oh, ow = y.shape[-2:]
        dxp = torch.zeros_like(xp)
        for a in range(k):
            for b in range(k):
                win = (..., slice(a, a + s * (oh - 1) + 1, s),
                       slice(b, b + s * (ow - 1) + 1, s))
                dxp[win] += dy * (xp[win] == y)
        return dxp[..., :h, :w], None, None


def avg_pool2d(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """pool<red::sum> * 1/k² (reference: layer.cc:517-519): zero padding
    and a VALID pool, so an overhanging window too is divided by the full
    k². Linear, so autograd's backward is the reference's."""
    return F.avg_pool2d(_pad_ceil(x, kernel, stride, 0.0), kernel, stride)


def lrn(
    x: torch.Tensor,
    *,
    local_size: int = 5,
    alpha: float = 1.0,
    beta: float = 0.75,
    knorm: float = 1.0,
) -> torch.Tensor:
    """Cross-channel local response normalization (LRNLayer::
    ComputeFeature, reference layer.cc:356-365): norm = chpool_sum(x²,
    local_size) * alpha/local_size + knorm; out = x * norm^-beta. The
    channel window is centred with zero padding (mshadow chpool,
    tensor_expr_ext.h:553); the window sum is ``local_size`` shifted adds
    in the JAX package's order, and beta 0.75 and 0.5 take its rsqrt
    forms."""
    salpha = alpha / local_size
    half = local_size // 2
    sq = x * x
    padded = F.pad(sq, (0, 0, 0, 0, half, half))
    c = x.shape[1]
    window_sum = padded[:, 0:c]
    for i in range(1, local_size):
        window_sum = window_sum + padded[:, i:i + c]
    norm = window_sum * salpha + knorm
    if beta == 0.75:
        r = torch.rsqrt(norm)
        return x * (r * torch.sqrt(r))
    if beta == 0.5:
        return x * torch.rsqrt(norm)
    return x * torch.pow(norm, -beta)


def dropout(
    x: torch.Tensor, pdrop: float, training: bool,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Inverted-scale Bernoulli dropout (DropoutLayer::ComputeFeature,
    reference layer.cc:144-155): mask = (uniform < pkeep) / pkeep; out =
    x * mask. The uniform draw is made on x's device from
    ``generator``'s seed (``utils.rng.on_device``)."""
    if not training or pdrop <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a generator in training")
    pkeep = 1.0 - pdrop
    u = torch.rand(x.shape, generator=on_device(generator, x.device),
                   device=x.device)
    return x * ((u < pkeep).to(x.dtype) / pkeep)


def softmax_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    topk: int = 1,
    scale: float = 1.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Softmax + cross-entropy + top-k precision in one op
    (SoftmaxLossLayer, reference layer.cc:718-764): loss = scale *
    mean(-log p_true), precision = scale * mean(top-k hit). Autograd of
    the loss wrt the logits is the reference's hand-written gradient
    (prob - onehot) * scale / batchsize. The loss math runs in float32
    under bf16 compute."""
    labels = labels.long()
    logits = logits.float()
    logp = F.log_softmax(logits, dim=-1)
    true_logp = logp.gather(-1, labels[:, None])[:, 0]
    loss = -true_logp.mean() * scale
    # a stable sort ranks tied logits by index, as lax.top_k does
    top_idx = torch.sort(logits.detach(), dim=-1, descending=True,
                         stable=True).indices[:, :topk]
    hit = (top_idx == labels[:, None]).any(dim=-1)
    precision = hit.float().mean() * scale
    return loss, {"loss": loss, "precision": precision}
