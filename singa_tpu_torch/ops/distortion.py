"""Train-time image distortion: elastic deformation + random affine.

Counterpart of ``singa_tpu/ops/distortion.py``. The reference's
MnistImageLayer carries the knobs of Simard's elastic-distortion
pipeline — kernel/sigma/alpha (Gaussian-smoothed random displacement
fields), beta (rotation/shear degrees), gamma (rescale percent) — and
ships its implementation commented out (src/worker/layer.cc:408-440).
The JAX package implements it as batched ops; so does this module:

- the random fields come from a ``torch.Generator``; the displacement
  fields are drawn on the images' device (``utils.rng.on_device``),
  the per-sample affine draws on the generator itself;
- given the fields, sampling is deterministic: bilinear, with zero for
  a neighbour outside the canvas (``map_coordinates(order=1,
  mode="constant")``, the JAX package's sampler).

Like the JAX package's, it does not reproduce the reference's halved
shear for labels 1 and 7 (a hand-tuned hack in dead code).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..utils.rng import on_device


def gaussian_kernel1d(kernel: int, sigma: float) -> torch.Tensor:
    """Odd-length normalized Gaussian taps."""
    if kernel % 2 == 0:
        kernel += 1
    x = torch.arange(kernel, dtype=torch.float32) - kernel // 2
    k = torch.exp(-0.5 * (x / max(sigma, 1e-6)) ** 2)
    return k / torch.sum(k)


def _smooth(field: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur of a (B,H,W) field (reflect padding).
    The taps are symmetric, so correlation is the convolution."""
    pad = taps.shape[0] // 2
    w = taps.to(field.device).reshape(1, 1, -1)

    def conv1d(x):  # along the last axis
        xp = F.pad(x, (pad, pad), mode="reflect")
        rows = xp.reshape(-1, 1, xp.shape[-1])
        return F.conv1d(rows, w).reshape(x.shape)

    field = conv1d(field)
    return conv1d(field.transpose(-1, -2)).transpose(-1, -2)


def elastic_offsets(
    gen: torch.Generator, shape: tuple[int, int, int], kernel: int,
    sigma: float, alpha: float, device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel (dy, dx) displacement fields: uniform noise in [-1,1]
    blurred by a (kernel, sigma) Gaussian and scaled by alpha."""
    taps = gaussian_kernel1d(kernel, sigma)
    device = device or gen.device
    dgen = on_device(gen, device)

    def field():
        u = torch.rand(shape, generator=dgen, device=device)
        return _smooth(u * 2.0 - 1.0, taps)

    dy = field()
    dx = field()
    return dy * alpha, dx * alpha


def affine_matrices(
    gen: torch.Generator, n: int, beta: float, gamma: float
) -> torch.Tensor:
    """(n,2,2) random affine maps: rescale both axes by ±gamma percent,
    then either rotate by ±beta degrees or shear by ±beta/90 (coin flip
    per sample) — the reference's gamma_/beta_ semantics."""
    r = torch.rand((n, 4), generator=gen) * 2.0 - 1.0
    coin = torch.rand((n,), generator=gen) < 0.5
    sy = 1.0 + r[:, 0] * gamma / 100.0
    sx = 1.0 + r[:, 1] * gamma / 100.0
    theta = r[:, 2] * beta * math.pi / 180.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    rot = torch.stack(
        [torch.stack([cos, -sin], -1), torch.stack([sin, cos], -1)], -2
    )
    shear = r[:, 3] * beta / 90.0
    ones, zeros = torch.ones_like(shear), torch.zeros_like(shear)
    shr = torch.stack(
        [torch.stack([ones, shear], -1), torch.stack([zeros, ones], -1)], -2
    )
    warp = torch.where(coin[:, None, None], rot, shr)
    scale = torch.stack(
        [torch.stack([sy, zeros], -1), torch.stack([zeros, sx], -1)], -2
    )
    return warp @ scale


def _bilinear_zero(images: torch.Tensor, sy: torch.Tensor,
                   sx: torch.Tensor) -> torch.Tensor:
    """Sample (B,H,W) images at (B,H,W) coordinates: the four neighbours
    weighted bilinearly, a neighbour outside the canvas reading 0."""
    b, h, w = images.shape
    flat = images.reshape(b, h * w)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy1, wx1 = sy - y0, sx - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    y0, x0 = y0.long(), x0.long()
    out = torch.zeros_like(sy)
    for dy_, wy in ((0, wy0), (1, wy1)):
        for dx_, wx in ((0, wx0), (1, wx1)):
            yi, xi = y0 + dy_, x0 + dx_
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1)
            val = flat.gather(1, idx).reshape(sy.shape)
            out = out + torch.where(valid, val, torch.zeros_like(val)) * (
                wy * wx)
    return out


def distort(
    images: torch.Tensor,
    gen: torch.Generator,
    *,
    kernel: int = 0,
    sigma: float = 0.0,
    alpha: float = 0.0,
    beta: float = 0.0,
    gamma: float = 0.0,
) -> torch.Tensor:
    """Apply elastic + affine distortion to a (B,H,W) image batch.

    Coordinates warp around the image centre; sampling is bilinear with
    zero fill. Knobs at zero disable their stage, so any subset of
    {elastic, rotation/shear, rescale} composes."""
    b, h, w = images.shape
    dev = images.device
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0

    if beta or gamma:
        mats = affine_matrices(gen, b, beta, gamma).to(dev)
        rel = torch.stack([yy - cy, xx - cx])  # (2,H,W)
        src = torch.einsum("nij,jhw->nihw", mats, rel)
        sy = src[:, 0] + cy
        sx = src[:, 1] + cx
    else:
        sy = yy.expand(b, h, w)
        sx = xx.expand(b, h, w)

    if alpha and kernel:
        dy, dx = elastic_offsets(gen, (b, h, w), kernel, sigma, alpha, dev)
        sy = sy + dy
        sx = sx + dx

    return _bilinear_zero(images, sy, sx)
