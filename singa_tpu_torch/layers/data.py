"""Data and parser layers.

Counterpart of ``singa_tpu/layers/data.py``. A data layer is the
host/device boundary: at build time it opens its source to learn the
sample shape (like ShardDataLayer::Setup reading one record, reference
layer.cc:662-672), and at run time the trainer feeds its batches in;
its ``apply`` forwards that input: kShardData and kLMDBData, each
through the native codec first (``data/pipeline.py``).

Parser layers (kMnistImage, kRGBImage, kLabel) are elementwise math on
the device (the reference runs them on the prefetch thread,
base_layer.h:469-560). Their random draws (distortion, crop offset,
mirror flags) come from the layer's generator in training; without one
they take the eval path. kRGBImage's draws are small and made on the
host; a multi-step chunk draws them for every step ahead of time
(:meth:`RGBImageLayer.staged_row`) and hands the layer a
:class:`StagedDraw` of device tensors instead of a generator, which it
crops and mirrors by without reading them back (a captured graph
replays it with each step's own draws).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config.schema import ConfigError
from ..data.pipeline import load_lmdb_arrays, load_shard_arrays
from .base import Layer, Shape


class _ArrayDataLayer(Layer):
    """Shared data-layer shape: open the source at build time to learn the
    sample shape, hold the decoded arrays, forward the fed batch."""

    is_datalayer = True
    LOADER: staticmethod  # (path) -> (images, labels)

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        p = self.cfg.data_param
        if p is None or not p.path or not p.batchsize:
            raise ConfigError(
                f"layer {self.name!r}: data_param.path and batchsize required"
            )
        self.path = p.path
        self.batchsize = p.batchsize
        self.random_skip = p.random_skip
        self.images, self.labels = type(self).LOADER(self.path)
        self.sample_shape = tuple(self.images.shape[1:])
        return (self.batchsize, *self.sample_shape)

    def apply(self, params, inputs, *, training, generator=None):
        # inputs[0] is the externally-fed batch dict {"image","label"}
        return inputs[0]


class ShardDataLayer(_ArrayDataLayer):
    """kShardData (reference: layer.cc:646-673)."""

    TYPE = "kShardData"
    LOADER = staticmethod(load_shard_arrays)


class LMDBDataLayer(_ArrayDataLayer):
    """kLMDBData (reference: layer.cc:237-328): a Caffe LMDB, each Datum
    converted to the record layout (datum_to_image_record, the reference's
    ConvertDatumToSingleLabelImageRecord, layer.cc:306-328), so a sample
    is (C, H, W); kMnistImage takes the C=1 records. Cursor wraparound
    becomes the batch pipeline's modular indexing."""

    TYPE = "kLMDBData"
    LOADER = staticmethod(load_lmdb_arrays)


class MnistImageLayer(Layer):
    """kMnistImage (reference: layer.cc:381-473): pixels -> float
    (x / norm_a) - norm_b, with the JAX package's two extensions:

    - ``resize`` resizes bilinearly with antialiasing when it shrinks
      (``jax.image.resize(..., "linear")``; the reference's live code
      top-left-crops instead, layer.cc:441-448);
    - kernel/sigma/alpha/beta/gamma drive the elastic and affine
      distortion (``ops/distortion.py``) in training only."""

    TYPE = "kMnistImage"
    is_parserlayer = True
    uses_generator = True

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        p = self.cfg.mnist_param
        self.norm_a = p.norm_a if p else 1.0
        self.norm_b = p.norm_b if p else 0.0
        self.kernel = p.kernel if p else 0
        self.sigma = p.sigma if p else 0.0
        self.alpha = p.alpha if p else 0.0
        self.beta = p.beta if p else 0.0
        self.gamma = p.gamma if p else 0.0
        self.draws_on_device = bool(
            (self.alpha and self.kernel) or self.beta or self.gamma)
        src = src_shapes[0]  # the data layer's (batch, H, W) or (b,1,H,W)
        if len(src) < 3:
            raise ConfigError(f"layer {self.name!r}: expects image records")
        if len(src) == 4 and src[1] != 1:
            raise ConfigError(
                f"layer {self.name!r}: kMnistImage is single-channel; got "
                f"C={src[1]} records (use kRGBImage)"
            )
        size = src[-1]
        if src[-2] != size:
            raise ConfigError(
                f"layer {self.name!r}: MNIST images must be square")
        self.resize = (p.resize if p else 0) or size
        return (src[0], self.resize, self.resize)

    def apply(self, params, inputs, *, training, generator=None):
        x = inputs[0]["image"].float()
        if x.dim() == 4 and x.shape[1] == 1:
            # records with an explicit C=1 dim -> (N, H, W) as declared
            x = x[:, 0]
        if self.resize != x.shape[-1]:
            x = F.interpolate(
                x[:, None], size=(self.resize, self.resize),
                mode="bilinear", antialias=True, align_corners=False,
            )[:, 0]
        if (training and isinstance(generator, torch.Generator)
                and self.draws_on_device):
            from ..ops.distortion import distort

            x = distort(
                x, generator, kernel=self.kernel, sigma=self.sigma,
                alpha=self.alpha, beta=self.beta, gamma=self.gamma,
            )
        return x / self.norm_a - self.norm_b


class StagedDraw:
    """One step's kRGBImage draws as device tensors, in place of its
    generator: ``offsets`` (2,) int64 (row, column of the crop) and
    ``flip`` (n,) int64 mirror flags (non-zero = mirror)."""

    def __init__(self, offsets: torch.Tensor, flip: torch.Tensor):
        self.offsets = offsets
        self.flip = flip


class RGBImageLayer(Layer):
    """kRGBImage (reference: layer.cc:573-643): subtract the meanfile at
    full size, crop (one random offset for the batch in training, the
    centre in eval), mirror each sample with probability 1/2 in
    training, then scale. The offset and flags are drawn on the CPU
    generator, so the CPU and the card crop alike."""

    TYPE = "kRGBImage"
    is_parserlayer = True
    uses_generator = True

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        p = self.cfg.rgbimage_param
        self.scale = p.scale if p else 1.0
        self.cropsize = p.cropsize if p else 0
        self.mirror = p.mirror if p else False
        src = src_shapes[0]
        if len(src) != 4:
            raise ConfigError(
                f"layer {self.name!r}: expects (N,C,H,W) records")
        n, c, h, w = src
        #: the records' (N, C, H, W): what the draws are made for
        self.in_shape = (n, c, h, w)
        self.mean = None
        if p and p.meanfile:
            mean = np.load(p.meanfile)
            if tuple(mean.shape) != (c, h, w):
                raise ConfigError(
                    f"layer {self.name!r}: meanfile shape {mean.shape} != "
                    f"record shape {(c, h, w)}"
                )
            self.mean = torch.from_numpy(mean.astype(np.float32))
        if self.cropsize:
            return (n, c, self.cropsize, self.cropsize)
        return src

    def draw(self, generator: torch.Generator, n: int):
        """The training draws for a batch of ``n``, in the eager path's
        order: (crop row, crop column) as ints, or None without a crop;
        the (n,) bool mirror flags on the CPU, or None without mirror."""
        _, _, h, w = self.in_shape
        offsets = flip = None
        if self.cropsize:
            cs = self.cropsize
            offsets = tuple(
                int(torch.randint(0, size - cs + 1, (), generator=generator))
                for size in (h, w))
        if self.mirror:
            flip = torch.rand((n,), generator=generator) < 0.5
        return offsets, flip

    def staged_width(self) -> int:
        """Entries of one step's row of staged draws: the crop offsets
        and one mirror flag per sample of the batch."""
        return 2 + self.in_shape[0]

    def staged_row(self, generator: torch.Generator) -> list[int]:
        """One step's draws as a row of ints (``staged_width`` long), the
        draws of :meth:`draw` with the same generator."""
        n = self.in_shape[0]
        offsets, flip = self.draw(generator, n)
        row = list(offsets) if offsets else [0, 0]
        return row + (flip.long().tolist() if flip is not None else [0] * n)

    def apply(self, params, inputs, *, training, generator=None):
        x = inputs[0]["image"].float()
        if self.mean is not None:
            # full-size mean subtracted before the crop, like the
            # loader-side subtraction in data_source.cc:158-173
            self.mean = self.mean.to(x.device)
            x = x - self.mean
        n, c, h, w = x.shape
        staged = training and isinstance(generator, StagedDraw)
        draw = training and isinstance(generator, torch.Generator)
        offsets = flip = None
        if draw:
            offsets, flip = self.draw(generator, n)
        if self.cropsize:
            cs = self.cropsize
            if staged:
                # a gather at the step's device offsets: the same values
                # as the slice, with no host read
                ar = torch.arange(cs, device=x.device)
                x = x.index_select(2, generator.offsets[0] + ar)
                x = x.index_select(3, generator.offsets[1] + ar)
            else:
                hoff, woff = offsets or ((h - cs) // 2, (w - cs) // 2)
                x = x[:, :, hoff:hoff + cs, woff:woff + cs]
        if self.mirror and staged:
            flip = generator.flip != 0
        if self.mirror and (draw or staged):
            flip = flip.to(x.device)
            x = torch.where(flip[:, None, None, None], x.flip(-1), x)
        if self.scale:
            x = x * self.scale
        return x


class LabelLayer(Layer):
    """kLabel (reference: layer.cc:217-233)."""

    TYPE = "kLabel"
    is_parserlayer = True

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        return (src_shapes[0][0],)

    def apply(self, params, inputs, *, training, generator=None):
        return inputs[0]["label"].long()
