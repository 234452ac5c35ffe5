"""ResNet job-config generator, from ``singa_tpu/models/resnet.py``.

A ResNet is a job conf in the layer vocabulary (kBatchNorm, kAdd,
kGlobalPooling; ``layers/norm.py``), not a code-level model: this
module emits the conf text, the same text as the JAX package's
generator for every argument (``examples/imagenet/resnet50.conf`` is
its depth-50 output), and the conf trains through the same Trainer as
every other job.

Architectures follow He et al. (arXiv:1512.03385): basic blocks for
depths 18/34, bottleneck (expansion 4) for 50/101/152, stride-2
downsampling at stage entry with type-B projection shortcuts.

Usage:
  python -m singa_tpu_torch.models.resnet --depth 50 --classes 1000 \
      --train-shard PATH --test-shard PATH --output resnet50.conf
"""

from __future__ import annotations

import argparse
import sys

_SPECS = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}
_WIDTHS = [64, 128, 256, 512]


def _conv(name, src, filters, kernel, stride, pad):
    return f"""  layer {{ name: "{name}" type: "kConvolution" srclayers: "{src}"
    convolution_param {{ num_filters: {filters} kernel: {kernel} stride: {stride} pad: {pad} bias_term: false }}
    param {{ name: "weight" init_method: "kGaussainSqrtFanIn" }} }}
"""


def _bn(name, src):
    return f"""  layer {{ name: "{name}" type: "kBatchNorm" srclayers: "{src}"
    batchnorm_param {{ momentum: 0.9 eps: 1e-5 }}
    param {{ name: "gamma" init_method: "kConstant" value: 1 }}
    param {{ name: "beta" init_method: "kConstant" value: 0 }} }}
"""


def _relu(name, src):
    return f'  layer {{ name: "{name}" type: "kReLU" srclayers: "{src}" }}\n'


def _cbr(prefix, src, filters, kernel, stride, pad, relu=True):
    """conv+bn(+relu) unit; returns (text, out_name)."""
    text = _conv(f"{prefix}_conv", src, filters, kernel, stride, pad)
    text += _bn(f"{prefix}_bn", f"{prefix}_conv")
    out = f"{prefix}_bn"
    if relu:
        text += _relu(f"{prefix}_relu", out)
        out = f"{prefix}_relu"
    return text, out


def _block(prefix, src, width, stride, kind, project):
    """One residual block; returns (text, out_name)."""
    text = ""
    if kind == "basic":
        t, a = _cbr(f"{prefix}_a", src, width, 3, stride, 1)
        text += t
        t, b = _cbr(f"{prefix}_b", a, width, 3, 1, 1, relu=False)
        text += t
        out_ch = width
    else:
        t, a = _cbr(f"{prefix}_a", src, width, 1, stride, 0)
        text += t
        t, b = _cbr(f"{prefix}_b", a, width, 3, 1, 1)
        text += t
        t, b = _cbr(f"{prefix}_c", b, width * 4, 1, 1, 0, relu=False)
        text += t
        out_ch = width * 4
    shortcut = src
    if project:
        t, shortcut = _cbr(
            f"{prefix}_proj", src, out_ch, 1, stride, 0, relu=False
        )
        text += t
    text += (
        f'  layer {{ name: "{prefix}_add" type: "kAdd" '
        f'srclayers: "{b}" srclayers: "{shortcut}" }}\n'
    )
    text += _relu(f"{prefix}_out", f"{prefix}_add")
    return text, f"{prefix}_out"


def resnet_conf(
    depth: int = 50,
    classes: int = 1000,
    batchsize: int = 256,
    size: int = 224,
    train_shard: str = "examples/imagenet/train_shard",
    test_shard: str = "examples/imagenet/test_shard",
    train_steps: int = 450_000,
    meanfile: str = "",
    compute_dtype: str = "bfloat16",
) -> str:
    """Emit the full job config text for a ResNet of the given depth."""
    if depth not in _SPECS:
        raise ValueError(f"depth must be one of {sorted(_SPECS)}")
    kind, stages = _SPECS[depth]
    mean = f' meanfile: "{meanfile}"' if meanfile else ""
    # the text is the JAX package's, its generator line included, so a
    # conf from either package is byte-for-byte the other's
    head = f"""# ResNet-{depth} ({kind} blocks {stages}) on {size}x{size} RGB records.
# Generated by singa_tpu.models.resnet — regenerate, don't hand-edit.
name: "resnet{depth}"
train_steps: {train_steps}
test_steps: 10
test_frequency: 5000
display_frequency: 100
checkpoint_frequency: 10000
compute_dtype: "{compute_dtype}"
updater {{
  type: "kSGD"
  base_learning_rate: 0.1
  momentum: 0.9
  weight_decay: 0.0001
  learning_rate_change_method: "kStep"
  learning_rate_change_frequency: 150000
  gamma: 0.1
  param_type: "Param"
}}
neuralnet {{
  layer {{ name: "data" type: "kShardData"
    data_param {{ path: "{train_shard}" batchsize: {batchsize} random_skip: 5000 }}
    exclude: "kTest" }}
  layer {{ name: "data" type: "kShardData"
    data_param {{ path: "{test_shard}" batchsize: {batchsize} }}
    exclude: "kTrain" }}
  layer {{ name: "rgb" type: "kRGBImage" srclayers: "data"
    rgbimage_param {{ cropsize: {size} mirror: true scale: 0.00392157{mean} }} }}
  layer {{ name: "label" type: "kLabel" srclayers: "data" }}
"""
    body = _conv("conv1", "rgb", 64, 7, 2, 3)
    body += _bn("bn1", "conv1")
    body += _relu("relu1", "bn1")
    body += (
        '  layer { name: "pool1" type: "kPooling" srclayers: "relu1"\n'
        '    pooling_param { pool: "MAX" kernel: 3 stride: 2 } }\n'
    )
    src = "pool1"
    for s, (nblocks, width) in enumerate(zip(stages, _WIDTHS)):
        for b in range(nblocks):
            stride = 2 if (s > 0 and b == 0) else 1
            # stage 0 block 0 changes channels (64 -> 64*expansion) even
            # at stride 1, so it projects too
            project = b == 0 and (s > 0 or kind == "bottleneck")
            text, src = _block(
                f"s{s + 1}b{b + 1}", src, width, stride, kind, project
            )
            body += text
    tail = f"""  layer {{ name: "gap" type: "kGlobalPooling" srclayers: "{src}" }}
  layer {{ name: "fc" type: "kInnerProduct" srclayers: "gap"
    inner_product_param {{ num_output: {classes} }}
    param {{ name: "weight" init_method: "kGaussain" std: 0.01 }}
    param {{ name: "bias" init_method: "kConstant" value: 0 }} }}
  layer {{ name: "loss" type: "kSoftmaxLoss" srclayers: "fc" srclayers: "label"
    softmaxloss_param {{ topk: 1 }} }}
}}
"""
    return head + body + tail


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="singa_tpu_torch.models.resnet")
    ap.add_argument("--depth", type=int, default=50,
                    choices=sorted(_SPECS))
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--batchsize", type=int, default=256)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--train-shard", default="examples/imagenet/train_shard")
    ap.add_argument("--test-shard", default="examples/imagenet/test_shard")
    ap.add_argument("--train-steps", type=int, default=450_000)
    ap.add_argument("--meanfile", default="")
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)
    text = resnet_conf(
        args.depth, args.classes, args.batchsize, args.size,
        args.train_shard, args.test_shard, args.train_steps, args.meanfile,
    )
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
        print(f"wrote {args.output}")
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
