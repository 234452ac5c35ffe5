"""Neuron layers: Convolution, InnerProduct, ReLU, Tanh, Sigmoid,
Dropout, LRN, Pooling.

Counterpart of ``singa_tpu/layers/neuron.py`` (reference:
src/worker/layer.cc, include/worker/layer.h:28-198), with the same
param shapes and fan_in values (the SqrtFanIn inits read them) and the
same shape arithmetic: convolution floor mode, pooling ceil mode.
"""

from __future__ import annotations

from typing import Sequence

from ..config.schema import ConfigError
from ..ops import activations, nn
from .base import Layer, Shape, feature_dim, require_one_src


class ConvolutionLayer(Layer):
    """kConvolution (reference: layer.cc:17-123).

    Weight is stored in the reference's (num_filters, channels*k*k) col
    layout; ops.nn.conv2d reshapes it to OIHW. fan_in for init is
    col_height = channels*k*k (layer.cc:49)."""

    TYPE = "kConvolution"

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        p = self.cfg.convolution_param
        if p is None or not p.kernel:
            raise ConfigError(
                f"layer {self.name!r}: convolution_param.kernel required")
        src = require_one_src(self, src_shapes)
        if len(src) == 3:  # (N, H, W) -> implicit single channel
            channels, height, width = 1, src[1], src[2]
        elif len(src) == 4:
            channels, height, width = src[1], src[2], src[3]
        else:
            raise ConfigError(
                f"layer {self.name!r}: conv needs 3/4-D input, got {src}")
        self.kernel, self.stride, self.pad = p.kernel, p.stride, p.pad
        self.num_filters = p.num_filters
        conv_h = (height + 2 * self.pad - self.kernel) // self.stride + 1
        conv_w = (width + 2 * self.pad - self.kernel) // self.stride + 1
        col_height = channels * self.kernel * self.kernel
        self.wname = self._declare_param(
            0, "weight", (self.num_filters, col_height), fan_in=col_height,
            neuron_axis=0)  # kLayerPartition splits num_filters
        self.bias_term = p.bias_term
        if self.bias_term:
            self.bname = self._declare_param(1, "bias", (self.num_filters,),
                                             neuron_axis=0)
        return (src[0], self.num_filters, conv_h, conv_w)

    def apply(self, params, inputs, *, training, generator=None):
        x = inputs[0]
        if x.dim() == 3:
            x = x[:, None]  # add channel dim
        bias = params[self.bname] if self.bias_term else None
        return nn.conv2d(x, params[self.wname], bias, stride=self.stride,
                         pad=self.pad)

    def crosses(self) -> bool:
        return self.model_split()

    def apply_ranks(self, params, inputs, lanes, *, training):
        """kLayerPartition: each model rank convolves with its filters
        (its weight and bias shards); every lane joins the group's
        output channels by Concate in rank order (the parts through
        ``Lanes.exchange``) and cuts the pad off."""
        from ..parallel.axes import concate

        outs = [None] * len(params)
        for g in lanes.groups("model"):
            parts = lanes.exchange(g, [self.apply(
                params[j], inputs[j], training=training) for j in g])
            for j, whole in zip(g, parts):
                outs[j] = concate(whole, 1)[:, :self.num_filters]
        return outs


class InnerProductLayer(Layer):
    """kInnerProduct (reference: layer.cc:162-213). Flattens the input to
    (batch, vdim); weight (vdim, hdim) with the reference's quirky
    fan_in = vdim*hdim (layer.cc:178)."""

    TYPE = "kInnerProduct"

    def setup(self, src_shapes: Sequence[Shape], batchsize: int) -> Shape:
        p = self.cfg.inner_product_param
        if p is None or not p.num_output:
            raise ConfigError(
                f"layer {self.name!r}: inner_product_param.num_output "
                "required")
        src = require_one_src(self, src_shapes)
        vdim = feature_dim(src)
        self.vdim, self.hdim = vdim, p.num_output
        self.wname = self._declare_param(
            0, "weight", (vdim, self.hdim), fan_in=vdim * self.hdim,
            neuron_axis=1)  # kLayerPartition splits num_output
        self.bias_term = p.bias_term
        if self.bias_term:
            self.bname = self._declare_param(1, "bias", (self.hdim,),
                                             neuron_axis=0)
        return (src[0], self.hdim)

    def apply(self, params, inputs, *, training, generator=None):
        w = params[self.wname]
        # align to the weight dtype (bf16 under compute_dtype)
        x = inputs[0].reshape(inputs[0].shape[0], -1).to(w.dtype)
        out = x @ w
        if self.bias_term:
            out = out + params[self.bname]
        return out

    def crosses(self) -> bool:
        return self.model_split()

    def apply_ranks(self, params, inputs, lanes, *, training):
        """kLayerPartition: each model rank's weight and bias shards give
        its columns of the output; every lane joins the group's columns
        by Concate in rank order (``Lanes.exchange``), pad cut off."""
        from ..parallel.axes import concate

        outs = [None] * len(params)
        for g in lanes.groups("model"):
            parts = lanes.exchange(g, [self.apply(
                params[j], inputs[j], training=training) for j in g])
            for j, whole in zip(g, parts):
                outs[j] = concate(whole, -1)[..., :self.hdim]
        return outs


class ReLULayer(Layer):
    """kReLU (reference: layer.cc:543-569)."""

    TYPE = "kReLU"

    def setup(self, src_shapes, batchsize):
        self.negative_slope = (
            self.cfg.relu_param.negative_slope if self.cfg.relu_param else 0.0
        )
        return require_one_src(self, src_shapes)

    def apply(self, params, inputs, *, training, generator=None):
        return activations.relu(inputs[0], self.negative_slope)


class TanhLayer(Layer):
    """kTanh — always the LeCun scaled tanh, like the reference
    (layer.cc:694-701 uses op::stanh unconditionally)."""

    TYPE = "kTanh"

    def setup(self, src_shapes, batchsize):
        return require_one_src(self, src_shapes)

    def apply(self, params, inputs, *, training, generator=None):
        return activations.stanh(inputs[0])


class SigmoidLayer(Layer):
    """kSigmoid — the JAX package's extension for the RBM/autoencoder
    path (the reference ships op::sigmoid, cxxnet_op.h:14-23, but
    registers no layer for it)."""

    TYPE = "kSigmoid"

    def setup(self, src_shapes, batchsize):
        return require_one_src(self, src_shapes)

    def apply(self, params, inputs, *, training, generator=None):
        return activations.sigmoid(inputs[0])


class DropoutLayer(Layer):
    """kDropout (reference: layer.cc:126-160): the mask is drawn from the
    layer's generator."""

    TYPE = "kDropout"
    uses_generator = True
    draws_on_device = True

    def setup(self, src_shapes, batchsize):
        self.pdrop = (
            self.cfg.dropout_param.dropout_ratio
            if self.cfg.dropout_param
            else 0.5
        )
        return require_one_src(self, src_shapes)

    def apply(self, params, inputs, *, training, generator=None):
        if not training:
            return inputs[0]
        if generator is None:
            raise ValueError(
                f"dropout layer {self.name!r} needs a generator")
        return nn.dropout(inputs[0], self.pdrop, training, generator)


class LRNLayer(Layer):
    """kLRN (reference: layer.cc:331-378). ACROSS_CHANNELS only, like the
    reference implementation."""

    TYPE = "kLRN"

    def setup(self, src_shapes, batchsize):
        p = self.cfg.lrn_param
        self.local_size = p.local_size if p else 5
        if self.local_size % 2 != 1:
            raise ConfigError(
                f"layer {self.name!r}: LRN local_size must be odd")
        self.alpha = p.alpha if p else 1.0
        self.beta = p.beta if p else 0.75
        self.knorm = p.knorm if p else 1.0
        src = require_one_src(self, src_shapes)
        if len(src) != 4:
            raise ConfigError(f"layer {self.name!r}: LRN needs NCHW input")
        return src

    def apply(self, params, inputs, *, training, generator=None):
        return nn.lrn(inputs[0], local_size=self.local_size,
                      alpha=self.alpha, beta=self.beta, knorm=self.knorm)


class PoolingLayer(Layer):
    """kPooling (reference: layer.cc:476-540), MAX and AVE, ceil-mode
    shape arithmetic."""

    TYPE = "kPooling"

    def setup(self, src_shapes, batchsize):
        p = self.cfg.pooling_param
        if p is None or not p.kernel:
            raise ConfigError(
                f"layer {self.name!r}: pooling_param.kernel required")
        self.kernel, self.stride, self.pool = p.kernel, p.stride, p.pool
        src = require_one_src(self, src_shapes)
        if len(src) == 3:
            n, h, w = src
            c = 1
        elif len(src) == 4:
            n, c, h, w = src
        else:
            raise ConfigError(
                f"layer {self.name!r}: pooling needs 3/4-D input")
        ph = nn.pooled_size(h, self.kernel, self.stride)
        pw = nn.pooled_size(w, self.kernel, self.stride)
        return (n, c, ph, pw)

    def apply(self, params, inputs, *, training, generator=None):
        x = inputs[0]
        if x.dim() == 3:
            x = x[:, None]
        fn = nn.max_pool2d if self.pool == "MAX" else nn.avg_pool2d
        return fn(x, self.kernel, self.stride)
