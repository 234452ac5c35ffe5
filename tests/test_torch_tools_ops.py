"""The port's operator tools against the JAX package's on the CPU:
``graph`` (the same dot text), ``partition`` (byte-identical shards),
``draw`` (the same parsed curves from the two packages' training logs,
and a PNG, or a refusal naming PIL without it); and the independence of
``singa_tpu_torch/tools`` from JAX. The tools that start processes are
in tests/test_torch_tools_procs.py.
"""

import ast
import filecmp
import json
import os
import pathlib
import re

import jax
import numpy as np
import pytest

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.graph.builder import build_net as j_build_net
from singa_tpu.parallel import build_mesh as j_mesh
from singa_tpu.tools import draw as j_draw
from singa_tpu.tools import graph as j_graph
from singa_tpu.tools import partition as j_partition
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.tools import draw as t_draw
from singa_tpu_torch.tools import graph as t_graph
from singa_tpu_torch.tools import partition as t_partition
from singa_tpu_torch.trainer import Trainer, params_from_numpy
from test_torch_launch import REPO
from test_torch_launch import one_torch_thread  # noqa: F401

MLP_CONF = os.path.join(REPO, "examples", "mnist", "mlp.conf")

@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ops") / "shard")
    t_loader.write_records(path, *t_loader.synthetic_arrays(64, seed=7))
    return path


def test_net_json_to_dot_matches_jax(shard, tmp_path):
    """The JAX net JSON of examples/mnist/mlp.conf, through both tools'
    main: the same dot text."""
    net = j_build_net(j_parse(mlp_text(shard)), "kTrain")
    src = tmp_path / "kTrain.json"
    src.write_text(json.dumps(net.to_json()))
    for name, tool in (("jax", j_graph), ("port", t_graph)):
        assert tool.main(["--input", str(src), "--output",
                          str(tmp_path / f"{name}.dot")]) == 0
    dot = (tmp_path / "port.dot").read_text()
    assert dot == (tmp_path / "jax.dot").read_text()
    assert '"fc1" -> "tanh1";' in dot


@pytest.mark.parametrize("nworkers,group,replicate", [
    (4, 2, False), (4, 2, True), (3, 1, False)])
def test_partition_shards_byte_identical(tmp_path, nworkers, group,
                                         replicate):
    """Split, replicate, and truncate (61 records over 3 workers): the
    same shard files, byte for byte, and the same rid lists."""
    src = str(tmp_path / "src")
    t_loader.write_records(src, *t_loader.synthetic_arrays(61, seed=2))
    rids = tmp_path / "rid.txt"
    rids.write_text("".join(f"r{i}\n" for i in range(61)))
    for name, tool in (("jax", j_partition), ("port", t_partition)):
        os.makedirs(tmp_path / name)
        for extra, inp in (([], src), (["--rid-list"], str(rids))):
            argv = ["--input", inp, "--output-prefix",
                    str(tmp_path / name / "p"), "--nworkers", str(nworkers),
                    "--group-size", str(group)] + extra
            assert tool.main(argv + (["--replicate"] if replicate else [])) \
                == 0
    cmp = filecmp.dircmp(tmp_path / "jax", tmp_path / "port")
    assert cmp.left_only == cmp.right_only == [] and cmp.diff_files == []
    for w in range(nworkers):
        sub = filecmp.dircmp(tmp_path / "jax" / f"p-w{w}",
                             tmp_path / "port" / f"p-w{w}")
        assert sub.common and not sub.diff_files and not sub.left_only
        for f in sub.common_files:
            assert filecmp.cmp(tmp_path / "jax" / f"p-w{w}" / f,
                               tmp_path / "port" / f"p-w{w}" / f,
                               shallow=False)


def mlp_text(shard: str) -> str:
    """examples/mnist/mlp.conf at its published widths, on ``shard``,
    cut to a batch of 16 and 6 steps with a display every 2 and a test
    every 3."""
    with open(MLP_CONF) as f:
        text = f.read()
    text = re.sub(r'path: "[^"]*"', f'path: "{shard}"', text)
    text = re.sub(r"batchsize: \d+", "batchsize: 16", text)
    for key, val in (("train_steps", 6), ("test_steps", 1),
                     ("test_frequency", 3), ("display_frequency", 2)):
        text = re.sub(rf"{key}: \d+", f"{key}: {val}", text)
    return text


def test_parse_log_of_both_packages_logs(shard, tmp_path):
    """A run of examples/mnist/mlp.conf in each package from the same
    params: the port's log parses to the same metrics and steps as the
    JAX log's, losses within 1e-4; draw writes a PNG of it."""
    logs = {"jax": [], "port": []}
    jt = JTrainer(j_parse(mlp_text(shard)), seed=0,
                  mesh=j_mesh(1, 1, jax.devices()[:1]),
                  log=logs["jax"].append, prefetch=False)
    tt = Trainer(t_parse(mlp_text(shard)), seed=0, device="cpu",
                 log=logs["port"].append, prefetch=False)
    tt.params = params_from_numpy(
        tt.train_net, {n: np.asarray(v) for n, v in jt.params.items()})
    jt.run()
    tt.run()
    curves = {k: t_draw.parse_log("\n".join(v)) for k, v in logs.items()}
    assert j_draw.parse_log("\n".join(logs["port"])) == curves["port"]
    assert curves["port"].keys() == curves["jax"].keys() >= {"loss"}
    for metric, phases in curves["jax"].items():
        assert phases.keys() == curves["port"][metric].keys()
        for phase, series in phases.items():
            got = curves["port"][metric][phase]
            assert [s for s, _ in got] == [s for s, _ in series]
            if metric == "loss":
                np.testing.assert_allclose([v for _, v in got],
                                           [v for _, v in series],
                                           atol=1e-4)
    assert [s for s, _ in curves["port"]["loss"]["train"]] == [0, 2, 4]
    log = tmp_path / "train.log"
    log.write_text("\n".join(logs["port"]))
    png = tmp_path / "curves.png"
    assert t_draw.main(["--log", str(log), "--output", str(png)]) == 0
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_draw_refuses_without_pil_by_name(tmp_path, monkeypatch, capsys):
    import sys

    log = tmp_path / "train.log"
    log.write_text("step 2: train loss : 2.3, precision : 0.1\n")
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert t_draw.main(["--log", str(log), "--output",
                        str(tmp_path / "x.png")]) == 2
    assert "PIL" in capsys.readouterr().err


TOOLS = pathlib.Path(REPO) / "singa_tpu_torch" / "tools"


@pytest.mark.parametrize("path", sorted(TOOLS.glob("*.py")),
                         ids=lambda p: p.name)
def test_tools_import_no_jax(path):
    """No module of the port's tools imports jax or the JAX package."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
            assert not (node.level == 0 and (node.module or "").startswith(
                "singa_tpu.")), node.module
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "singa_tpu"), name


PORTED = ("trace", "telemetry_overhead", "collective_stall", "update_stall",
          "ckpt_stall", "input_stall", "attend_stall", "graph", "draw",
          "partition", "sweep", "elastic_launch", "cluster")


@pytest.mark.parametrize("name", PORTED)
def test_tool_help_and_flags_match_jax(name, capsys):
    """``--help`` of each ported tool exits 0 and lists every flag of the
    JAX tool of the same name (the port adds ``--device``)."""
    import importlib

    flags = {}
    for pkg in ("singa_tpu", "singa_tpu_torch"):
        mod = importlib.import_module(f"{pkg}.tools.{name}")
        with pytest.raises(SystemExit) as done:
            mod.main(["--help"])
        assert done.value.code == 0
        usage = capsys.readouterr().out.split("\n\n")[0]
        flags[pkg] = set(re.findall(r"(?<![\w-])(--?[a-z_][\w-]*)", usage))
    assert flags["singa_tpu"] <= flags["singa_tpu_torch"], name
    assert flags["singa_tpu_torch"] - flags["singa_tpu"] <= {
        "--device", "-device"}, name
