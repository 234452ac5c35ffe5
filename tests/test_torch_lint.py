"""The port's netlint CLI against the JAX package's: the same exit code
and the same diagnostics (code, severity, location, message, hint, fix)
on the golden fixtures, on every shipped conf with and without each
cluster conf of its directory, on the CLI surface (usage errors, rule
table, ``--ignore``, cluster topology, ELA001) and through the ``--fix``
/ ``--dry-run`` rewrites. The documented differences: KRN001 asks the
CUDA kernel's geometry (head_dim 64 or 128, any kv_block_len) whatever
``interpret`` says, and KRN002's CD arm does not name shard_map; their
cases are below. The shape pass and the
cost model are held in tests/test_torch_lint_shape.py and
tests/test_torch_lint_cost.py, the port's source rules in
tests/test_torch_lint_ast.py.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from singa_tpu.lint import Collector as JCollector
from singa_tpu.lint import lint_model_text as j_lint_model
from singa_tpu.tools import lint as j_cli
from singa_tpu_torch.lint import Collector, lint_model_text
from singa_tpu_torch.ops.paged_attention import fusable
from singa_tpu_torch.tools import lint as t_cli
from test_torch_launch import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "lint"
EXAMPLES = REPO / "examples"
MODEL_CONFS = sorted(
    p for p in EXAMPLES.glob("*/*.conf") if "cluster" not in p.name
)


def both(capsys, *argv, fmt="json"):
    """Both CLIs on ``argv`` -> {"jax": (rc, out), "port": (rc, out)};
    ``out`` is the parsed JSON document, or the text."""
    got = {}
    for name, mod in (("jax", j_cli), ("port", t_cli)):
        rc = mod.main(["--format", fmt, *map(str, argv)])
        out = capsys.readouterr().out
        got[name] = (rc, json.loads(out) if fmt == "json" else out)
    return got


def assert_same(got):
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("argv", [
    ["bad_cycle.conf"],
    ["bad_dangling.conf"],
    ["bad_enum.conf"],
    ["bad_phase.conf"],
    ["bad_partition.conf"],
    ["bad_partition.conf", "--cluster", "cluster_model2.conf"],
    ["bad_partition.conf", "--cluster", "cluster_model2.conf", "--strict"],
    ["cluster_model2.conf"],
    ["bad_dangling.conf", "--ignore", "NET001,SHP001"],
], ids=lambda a: "_".join(x.replace(".conf", "").strip("-") for x in a))
def test_fixture_matches_jax(capsys, argv):
    argv = [str(FIXTURES / a) if a.endswith(".conf") else a for a in argv]
    got = both(capsys, *argv)
    assert_same(got)
    assert got["port"][0] == (0 if "--ignore" in argv or (
        "bad_partition" in argv[0] and "--strict" not in argv)
        or "cluster_model2" in argv[0] else 1)


def test_fixtures_text_format_matches_jax(capsys):
    got = both(capsys, *sorted(FIXTURES.glob("*.conf")), fmt="text")
    assert_same(got)
    assert "NET002" in got["port"][1] and got["port"][0] == 1


@pytest.mark.parametrize("conf", MODEL_CONFS,
                         ids=lambda p: f"{p.parent.name}/{p.stem}")
def test_shipped_conf_matches_jax(capsys, conf):
    """Alone and with each cluster conf of its directory."""
    clusters = sorted(conf.parent.glob("cluster*.conf"))
    for extra in [[]] + [["--cluster", c] for c in clusters]:
        got = both(capsys, conf, *extra)
        assert_same(got)
        assert got["port"][0] == 0, (extra, got["port"])


def test_examples_dir_matches_jax(capsys):
    assert_same(both(capsys, EXAMPLES))


# ---------------------------------------------------------------------------
# the CLI surface
# ---------------------------------------------------------------------------


def test_rule_table_is_the_jax_catalogue_with_the_port_source_rules(
        capsys):
    rows = {}
    for name, mod in (("jax", j_cli), ("port", t_cli)):
        assert mod.main(["--list-rules"]) == 0
        rows[name] = dict(
            (line[:8].strip(), line[9:])
            for line in capsys.readouterr().out.splitlines()[1:])
    jax_rows = {c: r for c, r in rows["jax"].items()
                if not c.startswith("JAX")}
    port_rows = {c: r for c, r in rows["port"].items()
                 if not c.startswith("PRT")}
    assert set(port_rows) == set(jax_rows)
    # the rows that name the backend describe the port's
    differ = {c for c in jax_rows if port_rows[c] != jax_rows[c]}
    assert differ == {"KRN001", "SHP002"}, differ
    assert {c for c in rows["port"] if c.startswith("PRT")} == {
        "PRT000", "PRT001", "PRT002", "PRT003"}


@pytest.mark.parametrize("argv", [[], ["does/not/exist.conf"]],
                         ids=["no_args", "missing_path"])
def test_usage_errors_exit_2(capsys, argv):
    for mod in (j_cli, t_cli):
        assert mod.main(argv) == 2
    capsys.readouterr()


@pytest.mark.parametrize("text, twice", [
    ('nworkers: 6\nnprocs_per_group: 6\nnseq_per_group: 4\n', False),
    ('nworkers: 2\nnprocs_per_group: 6\nnseq_per_group: 4\n', False),
    ('nworkers: 2\nnprocs_per_group: 6\n', False),
    ('nworkers: 6\nnprocs_per_group: 6\nnseq_per_group: 4\n', True),
], ids=["clu001", "clu001_clu002", "clu002", "in_paths_and_cluster"])
def test_cluster_topology_matches_jax(capsys, tmp_path, text, twice):
    p = tmp_path / "cluster.conf"
    p.write_text(text + 'workspace: "ws"\n')
    got = both(capsys, p, *(["--cluster", p] if twice else []))
    assert_same(got)
    assert got["port"][0] == 1


def test_graph_error_keeps_sharding_checks(capsys, tmp_path):
    job = tmp_path / "job.conf"
    job.write_text(
        'train_steps: 2\nneuralnet {\n'
        '  layer { name: "data" type: "kShardData"\n'
        '          data_param { path: "nope" batchsize: 7 } }\n'
        '  layer { name: "mnist" type: "kMnistImage" srclayers: "dataa" }\n'
        '}\n')
    cluster = tmp_path / "cluster.conf"
    cluster.write_text('nworkers: 2\nnprocs_per_group: 1\nworkspace: "ws"\n')
    got = both(capsys, job, "--cluster", cluster)
    assert_same(got)
    codes = {d["code"] for d in got["port"][1]["diagnostics"]}
    assert {"NET001", "SHD003"} <= codes


def _elastic_job(tmp_path, spec, shape, fmt="singa-tpu-sharded-v1"):
    ck = tmp_path / "step_8.ckpt"
    ck.mkdir()
    (ck / "manifest.json").write_text(json.dumps({
        "format": fmt, "step": 8, "nprocs": 4,
        "arrays": {
            f"p|w{i}": {"shape": list(shape), "dtype": "float32",
                        "spec": spec}
            for i in range(3)
        },
    }))
    job = tmp_path / "job.conf"
    job.write_text(
        f'name: "elastic"\ntrain_steps: 2\ncheckpoint: "{ck}"\n'
        'neuralnet {\n  layer { name: "data" type: "kShardData"\n'
        '    data_param { path: "nope" batchsize: 8 } }\n}\n')
    cluster = tmp_path / "cluster.conf"
    cluster.write_text('nworkers: 2\nnprocs_per_group: 1\nworkspace: "ws"\n')
    return job, cluster


@pytest.mark.parametrize("spec, shape, fmt, fires", [
    (["rows", None], (8, 8), "singa-tpu-sharded-v1", True),
    (["data", None], (1, 8), "singa-tpu-sharded-v1", True),
    (["data", None], (8, 8), "singa-tpu-sharded-v1", False),
    (["rows", None], (8, 8), "someone-elses-checkpoint-v9", False),
], ids=["foreign_axis", "more_shards", "hostable", "foreign_format"])
def test_ela001_matches_jax(capsys, tmp_path, spec, shape, fmt, fires):
    job, cluster = _elastic_job(tmp_path, spec, shape, fmt)
    got = both(capsys, job, "--cluster", cluster)
    assert_same(got)
    ela = [d for d in got["port"][1]["diagnostics"] if d["code"] == "ELA001"]
    assert bool(ela) == fires
    if fires:
        assert "+2 more entries" in ela[0]["msg"]
    # without --cluster there is no target mesh: silent in both
    got = both(capsys, job)
    assert_same(got)
    assert "ELA001" not in {d["code"] for d in got["port"][1]["diagnostics"]}


BROKEN = """name: "fix"
train_steps: 4
zero_updae: false
updater {{ base_learning_rate: 0.1 type: {typ} }}
neuralnet {{
  layer {{ name: "data" type: "kShardData"
          data_param {{ path: "nope" batchsize: 8 }} }}
}}
"""


@pytest.mark.parametrize("dry_run", [False, True], ids=["fix", "dry_run"])
def test_fix_round_trip_matches_jax(capsys, tmp_path, dry_run):
    """--fix rewrites a typo'd field and a typo'd quoted enum in place
    (or, with --dry-run, prints the diff); both CLIs print the same and
    leave the same file."""
    broken = BROKEN.format(typ='"kSGDD"')
    got = {}
    for name, mod in (("jax", j_cli), ("port", t_cli)):
        d = tmp_path / name
        d.mkdir()
        conf = d / "job.conf"
        conf.write_text(broken)
        os.chdir(d)
        try:
            rc = mod.main(["job.conf", "--fix"]
                          + (["--dry-run"] if dry_run else []))
        finally:
            os.chdir(REPO)
        got[name] = (rc, capsys.readouterr().out, conf.read_text())
    assert got["port"] == got["jax"]
    rc, out, text = got["port"]
    assert rc == 1
    if dry_run:
        assert "would apply 2 fix(es)" in out and text == broken
        assert "+zero_update: false" in out
    else:
        assert "applied 2 fix(es)" in out
        assert text == BROKEN.format(typ='"kSGD"').replace(
            "zero_updae", "zero_update")
        assert t_cli.main([str(tmp_path / "port" / "job.conf")]) == 0
        capsys.readouterr()


def test_cli_imports_neither_jax_nor_the_jax_package(tmp_path):
    """A fresh interpreter runs the CLI over the examples and its own
    package and ends with neither ``jax`` nor ``singa_tpu`` imported."""
    code = (
        "import sys\n"
        "from singa_tpu_torch.tools import lint\n"
        "rc = lint.main(['examples', '--self', '--format', 'json'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'singa_tpu'))\n"
        "print('RC', rc, 'BAD', bad)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    last = r.stdout.strip().splitlines()[-1]
    assert last == "RC 0 BAD []", r.stdout[-2000:] + r.stderr[-2000:]
    doc = json.loads(r.stdout[:r.stdout.rindex("RC")])
    assert doc["counts"]["ERROR"] == 0


# ---------------------------------------------------------------------------
# KRN001: the documented difference (the CUDA kernel's geometry)
# ---------------------------------------------------------------------------


SERVE_CONF = """
name: "krn"
neuralnet {{
  layer {{ name: "emb" type: "kEmbedding"
    embedding_param {{ vocab_size: 64 embedding_dim: {dim} max_len: 64 }} }}
  layer {{ name: "att" type: "kAttention" srclayers: "emb"
    attention_param {{ num_heads: 2 }} }}
}}
serving {{ slots: 4 kv_block_len: {block} }}
kernels {{ paged_attention: fused interpret: {interpret} }}
"""


def _krn(dim, block, interpret):
    text = SERVE_CONF.format(dim=dim, block=block, interpret=interpret)
    out = []
    for lint, col in ((j_lint_model, JCollector()),
                      (lint_model_text, Collector())):
        lint(text, "k.conf", col)
        out.append([d for d in col.sorted() if d.code == "KRN001"])
    return out


@pytest.mark.parametrize("dim, block, interpret, jax_fires, port_fires", [
    (128, 16, "false", True, False),   # head_dim 64: the CUDA kernel's
    (128, 16, "true", False, False),
    (192, 16, "false", True, True),    # head_dim 96: neither kernel's
    (192, 16, "true", False, True),    # the Engine ignores interpret
    (256, 12, "false", True, False),   # block 12: TPU tile only
], ids=["hd64", "hd64_interp", "hd96", "hd96_interp", "block12"])
def test_krn001_asks_the_cuda_kernel(dim, block, interpret, jax_fires,
                                     port_fires):
    j, t = _krn(dim, block, interpret)
    assert bool(j) == jax_fires and bool(t) == port_fires
    if port_fires:
        (d,) = t
        # the Engine's own reason text (serve/engine.py raises it on cuda)
        reason = fusable(block, dim // 2)
        assert reason is not None and reason in d.msg
        assert d.severity == "ERROR" and "64, 128" in d.fix_hint


def test_krn002_cd_arm_names_no_shard_map(capsys, tmp_path):
    """The ring rules match the JAX linter's; the CD arm's message says
    why without naming shard_map."""
    job = tmp_path / "cd.conf"
    job.write_text(
        'name: "cd"\ntrain_steps: 2\nalg: kContrastiveDivergence\n'
        'grad_comm { mode: quantized dtype: int8 }\n'
        'kernels { grad_allreduce: quantized_ring }\n'
        'neuralnet {\n  layer { name: "data" type: "kShardData"\n'
        '    data_param { path: "nope" batchsize: 8 } }\n}\n')
    got = both(capsys, job)
    j, t = (got[k][1]["diagnostics"] for k in ("jax", "port"))
    assert got["port"][0] == got["jax"][0] == 1
    assert [(d["code"], d["loc"]) for d in t] == [
        (d["code"], d["loc"]) for d in j]
    differ = [(a["msg"], b["msg"]) for a, b in zip(j, t)
              if a["msg"] != b["msg"]]
    assert len(differ) == 1 and "shard_map" in differ[0][0]
    assert "shard_map" not in differ[0][1] and "per-rank backward" in (
        differ[0][1])
