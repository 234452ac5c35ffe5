"""The port's shape pass (``singa_tpu_torch/lint/shape_rules.py``, the
forward on ``torch.device("meta")``) against the JAX package's
(``jax.eval_shape``): the same diagnostics on the build-based cases of
tests/test_lint.py and on every shipped conf, each given tiny shards
of its sample shape at its data paths (both packages' write_records on
the same arrays), resnet50.conf and tinylm_moe.conf included. The pass
allocates no storage: a full-size forward runs on meta only.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.data import loader as j_loader
from singa_tpu.lint import Collector as JCollector
from singa_tpu.lint.shape_rules import shape_pass as j_shape
from singa_tpu.tools import lint as j_cli
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.lint import Collector
from singa_tpu_torch.lint.shape_rules import shape_pass as t_shape
from singa_tpu_torch.tools import lint as t_cli
from test_torch_launch import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
MODEL_CONFS = sorted(
    p for p in (REPO / "examples").glob("*/*.conf")
    if "cluster" not in p.name
)
WIDTHS = {"data": 1, "model": 2, "expert": 1, "seq": 1, "pipe": 1}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("lint_shape")


def write_both(root, name, arrays) -> str:
    """``arrays`` through both packages' write_records -> the path with
    ``{side}`` standing for jax / port."""
    for side, loader in (("jax", j_loader), ("port", t_loader)):
        path = root / f"{name}_{side}"
        if not path.exists():
            loader.write_records(str(path), *arrays)
    return str(root / f"{name}_{{side}}")


@pytest.fixture(scope="module")
def shard(data_dir):
    return write_both(data_dir, "mnist8",
                      t_loader.synthetic_arrays(32, classes=4, size=8))


def comparable(d) -> dict:
    """A diagnostic as both packages must agree on it: SHP002's message
    is the framework's own exception text (a torch RuntimeError where
    jax raises a TypeError), so it is held by code, severity and
    location."""
    d = dataclasses.asdict(d)
    if d["code"] == "SHP002":
        d.pop("msg")
    return d


def passes(text, widths=None):
    """Both shape passes on ``text`` (``{side}`` filled per package) ->
    (jax (built, diagnostics), port (built, diagnostics))."""
    out = []
    for side, parse, shape_pass, col in (
            ("jax", j_parse, j_shape, JCollector()),
            ("port", t_parse, t_shape, Collector())):
        cfg = parse(text.replace("{side}", side))
        built = shape_pass(cfg, "x.conf", col, widths)
        out.append((built, [comparable(d) for d in col.sorted()]))
    return out


SHARDED = """
name: "lint-built"
train_steps: 4
neuralnet {{
  layer {{ name: "data" type: "kShardData"
    data_param {{ path: "{shard}" batchsize: 8 }} }}
  layer {{ name: "mnist" type: "kMnistImage" srclayers: "data" }}
  layer {{ name: "label" type: "kLabel" srclayers: "data" }}
  layer {{ name: "fc1" type: "kInnerProduct" srclayers: "mnist"
    inner_product_param {{ num_output: {nout} }} {extra_fc1} }}
  layer {{ name: "loss" type: "kSoftmaxLoss"
    srclayers: "fc1" srclayers: "label" }}
}}
"""

PHASES = """
train_steps: 4
test_steps: 2
test_frequency: 2
neuralnet {{
  layer {{ name: "data" type: "kShardData"
          data_param {{ path: "{shard}" batchsize: 8 }} }}
  layer {{ name: "mnist" type: "kMnistImage" srclayers: "data" }}
  layer {{ name: "label" type: "kLabel" srclayers: "data" }}
  layer {{ name: "fc1" type: "kInnerProduct" srclayers: "mnist"
          inner_product_param {{ num_output: 8 }}
          partition_type: kLayerPartition }}
  layer {{ name: "fc_test" type: "kInnerProduct" srclayers: "mnist"
          inner_product_param {{ num_output: 7 }}
          partition_type: kLayerPartition exclude: kTrain }}
  layer {{ name: "loss" type: "kSoftmaxLoss"
          srclayers: "fc1" srclayers: "label" exclude: kTest }}
  layer {{ name: "loss_t" type: "kSoftmaxLoss"
          srclayers: "fc_test" srclayers: "label" exclude: kTrain }}
}}
"""

SHARE = SHARDED.replace(
    '  layer {{ name: "loss" type: "kSoftmaxLoss"\n    srclayers: "fc1"',
    '  layer {{ name: "fc2" type: "kInnerProduct" srclayers: "fc1"\n'
    '    inner_product_param {{ num_output: 4 }}\n'
    '    share_param: "fc1/weight" }}\n'
    '  layer {{ name: "loss" type: "kSoftmaxLoss"\n    srclayers: "fc2"')

#: the draws on meta: kMnistImage's elastic + affine distortion and
#: kDropout, each from the step's CPU generator
DRAWS = SHARDED.replace(
    'srclayers: "data" }}\n  layer {{ name: "label"',
    'srclayers: "data"\n    mnist_param {{ kernel: 3 sigma: 1 alpha: 2 '
    'beta: 5 gamma: 10 }} }}\n  layer {{ name: "label"').replace(
    '  layer {{ name: "loss" type: "kSoftmaxLoss"\n    srclayers: "fc1"',
    '  layer {{ name: "drop" type: "kDropout" srclayers: "fc1"\n'
    '    dropout_param {{ dropout_ratio: 0.5 }} }}\n'
    '  layer {{ name: "loss" type: "kSoftmaxLoss"\n    srclayers: "drop"')


@pytest.mark.parametrize("text, widths, codes", [
    (SHARDED.format(shard="{shard}", nout=4, extra_fc1=""), None, set()),
    (SHARDED.format(shard="{shard}", nout=4, extra_fc1="").replace(
        'srclayers: "fc1" srclayers: "label"', 'srclayers: "fc1"'),
     None, {"SHP001"}),
    (SHARDED.format(shard="{shard}", nout=7,
                    extra_fc1="partition_type: kLayerPartition"),
     WIDTHS, {"SHD001"}),
    (SHARDED.format(shard="{shard}", nout=8,
                    extra_fc1="partition_type: kLayerPartition"),
     WIDTHS, set()),
    (PHASES.format(shard="{shard}"), WIDTHS, {"SHD001"}),
    (SHARDED.replace(
        '"kInnerProduct" srclayers: "mnist"\n    inner_product_param '
        '{{ num_output: {nout} }}',
        '"kConvolution" srclayers: "mnist"\n    convolution_param '
        '{{ num_filters: 4 kernel: 3 stride: 0 }}').format(
            shard="{shard}", nout=4, extra_fc1=""), None, {"SHP001"}),
    (SHARE.format(shard="{shard}", nout=4, extra_fc1=""), None,
     {"PRM003", "SHP002"}),
    (SHARDED.format(shard="{shard}", nout=4,
                    extra_fc1='share_param: "nope/weight"'),
     None, {"PRM002"}),
    (DRAWS.format(shard="{shard}", nout=4, extra_fc1=""), None, set()),
], ids=["clean", "contract_break", "indivisible", "divisible",
        "phase_excluded", "stride0", "share_shape", "share_owner",
        "draws"])
def test_shape_pass_matches_jax(shard, text, widths, codes):
    (jb, jd), (tb, td) = passes(text.replace("{shard}", shard), widths)
    assert tb == jb == ("SHP001" not in codes)
    assert td == jd
    assert {d["code"] for d in td} == codes


def test_batch_check_runs_on_a_built_net(capsys, shard, tmp_path):
    """SHD003 on a net that builds, and no SHD001 heuristic on top."""
    cluster = tmp_path / "cluster.conf"
    cluster.write_text('nworkers: 2\nnprocs_per_group: 1\nworkspace: "ws"\n')
    got = []
    for side, mod in (("jax", j_cli), ("port", t_cli)):
        job = tmp_path / f"{side}.conf"
        job.write_text(SHARDED.format(
            shard=shard.replace("{side}", side), nout=4,
            extra_fc1="").replace("batchsize: 8", "batchsize: 7"))
        rc = mod.main([str(job), "--cluster", str(cluster), "--format",
                       "text"])
        got.append((rc, capsys.readouterr().out.replace(str(job), "j")))
    assert got[1] == got[0]
    assert got[1][0] == 0 and "SHD003" in got[1][1]
    assert "SHD001" not in got[1][1]


# ---------------------------------------------------------------------------
# every shipped conf, on tiny shards of its sample shape
# ---------------------------------------------------------------------------


def conf_arrays(path: str):
    """Two records of the sample shape the conf's data path stands
    for."""
    if "lm/" in path:
        return t_loader.synthetic_token_arrays(
            2, seq_len=8192 if "8k" in path else 128, vocab=256)
    if "cifar" in path:
        return t_loader.synthetic_arrays(2, channels=3, size=32)
    if "imagenet" in path:
        return t_loader.synthetic_arrays(2, channels=3, size=256)
    return t_loader.synthetic_arrays(2)


def with_shards(text: str, root) -> str:
    for path in sorted(set(re.findall(r'path: "([^"]*)"', text))):
        name = path.replace("/", "_")
        text = text.replace(f'path: "{path}"', 'path: "{}"'.format(
            write_both(root, name, conf_arrays(path))))
    for mean in set(re.findall(r'meanfile: "([^"]*)"', text)):
        dest = root / "mean.npy"
        np.save(dest, np.full((3, 32, 32), 120.0, np.float32))
        text = text.replace(mean, str(dest))
    return text


@pytest.mark.parametrize("conf", MODEL_CONFS,
                         ids=lambda p: f"{p.parent.name}/{p.stem}")
def test_shipped_conf_shape_pass_matches_jax(data_dir, conf):
    (jb, jd), (tb, td) = passes(with_shards(conf.read_text(), data_dir))
    assert tb == jb is True
    assert td == jd
    assert not [d for d in td if d["severity"] == "ERROR"]


class _Storage(TorchDispatchMode):
    """Every op's outputs: bytes of meta tensors, and the bytes and ops
    of those with storage."""

    def __init__(self):
        super().__init__()
        self.meta = self.real = 0
        self.real_ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor):
                n = t.numel() * t.element_size()
                if t.device.type == "meta":
                    self.meta += n
                else:
                    self.real += n
                    self.real_ops.add(str(func))
        return out


def test_shape_pass_allocates_no_storage(data_dir):
    """ResNet-50 at its batch of 256: every activation is a meta tensor
    (GBs of them); the only tensors with storage are kRGBImage's crop
    offsets and mirror flags, drawn on the CPU generator."""
    text = with_shards((REPO / "examples/imagenet/resnet50.conf")
                       .read_text(), data_dir)
    col = Collector()
    with _Storage() as seen:
        assert t_shape(t_parse(text.replace("{side}", "port")), "x.conf",
                       col)
    assert not [d for d in col.sorted() if d.severity == "ERROR"]
    assert seen.meta > 10 * 2 ** 30
    assert seen.real < 4096, (seen.real, seen.real_ops)
