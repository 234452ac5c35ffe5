"""The port's cost model (``singa_tpu_torch/lint/cost_model.py``) against
the JAX package's, field by field, and against the port's own counts:
the Trainer's optimizer bytes and modeled wire bytes, the bytes one step
adds to ``ppermute.sent_bytes`` on CPU ranks (per level under q8_hier),
and the bytes of the serving Engine's K/V pool tensors. A model that
drifts from the program is a lint bug, so every bar is exact equality.
The rule arms (MEM001, COST001, ROL001, SRV002, FLT002) give the JAX
package's diagnostics; ``--explain-cost`` renders the same table but its
inter-slice row, which names the conf's field where the JAX one says
DCN.
"""

import dataclasses

import pytest
import torch

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.data import loader as j_loader
from singa_tpu.lint import Collector as JCollector
from singa_tpu.lint import cost_model as j_cost
from singa_tpu.lint.net_rules import lint_cluster_text as j_cluster
from singa_tpu.tools import lint as j_cli
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.lint import Collector
from singa_tpu_torch.lint import cost_model as t_cost
from singa_tpu_torch.lint.net_rules import lint_cluster_text as t_cluster
from singa_tpu_torch.models.transformer import init_lm
from singa_tpu_torch.ops import quantized_collective as tq
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.serve import Engine, EngineConfig
from singa_tpu_torch.serve.fleet.host import lm_config_from_conf
from singa_tpu_torch.tools import lint as t_cli
from singa_tpu_torch.trainer import Trainer
from test_cost_model import FLT_CONF, SRV_CONF
from test_grad_comm import MLP_CONF
from test_quantized_collective import MLP12_CONF, Q8B_HIER, Q8B_RING
from test_torch_launch import one_torch_thread  # noqa: F401

Q8_REF = "grad_comm { mode: quantized dtype: int8 }"

#: case -> (conf, data width, zero_update, extra conf text)
CASES = {
    "mlp": (MLP_CONF, 2, False, ""),
    "mlp_zero": (MLP_CONF, 2, True, ""),
    "q8_reference": (MLP_CONF, 2, False, Q8_REF),
    "q8_ring": (MLP_CONF, 2, False, Q8B_RING),
    "q8_ring_zero": (MLP_CONF, 2, True, Q8B_RING),
    "q8_hier": (MLP12_CONF, 4, False, Q8B_HIER),
}


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """The same synthetic arrays through both packages' write_records."""
    d = tmp_path_factory.mktemp("lint_cost")
    arrays = t_loader.synthetic_arrays(96, seed=4)
    j_loader.write_records(str(d / "jax"), *arrays)
    t_loader.write_records(str(d / "port"), *arrays)
    return {"jax": str(d / "jax"), "port": str(d / "port")}


def conf_text(case, shard):
    conf, _, zero, extra = CASES[case]
    return conf.format(shard=shard, zero="true" if zero else "false",
                       train_steps=4, checkpoint_frequency=0,
                       checkpoint_format="npz", extra=extra)


def reports(case, shards):
    n = CASES[case][1]
    j = j_cost.build_cost_model(
        j_parse(conf_text(case, shards["jax"])), {"data": n}, "t.conf")
    t = t_cost.build_cost_model(
        t_parse(conf_text(case, shards["port"])), {"data": n}, "t.conf")
    return j, t


@pytest.mark.parametrize("case", list(CASES))
def test_cost_report_matches_jax_and_the_trainer(shards, case):
    """The report equals the JAX package's field by field. opt_bytes is
    the Trainer's measured optimizer state; param_bytes its float32
    masters; the ring rows the bytes one step sends at the port's
    ppermute, per rank (per level under q8_hier), and the Trainer's
    modeled bytes."""
    n = CASES[case][1]
    j, report = reports(case, shards)
    assert j is not None and report is not None
    assert dataclasses.asdict(report) == dataclasses.asdict(j)
    assert (report.hbm_bytes, report.collective_bytes) == (
        j.hbm_bytes, j.collective_bytes)
    cfg = t_parse(conf_text(case, shards["port"]))
    tr = Trainer(cfg, None, mesh=build_mesh(n, 1, ["cpu"] * n), seed=3,
                 log=lambda s: None)
    assert report.opt_bytes == tr.opt_state_bytes_per_device()
    assert report.param_bytes == sum(
        v.numel() * v.element_size() for v in tr.params.values())
    tq.ppermute.sent_bytes.clear()
    tr.train_one_batch(0)
    sent = dict(tq.ppermute.sent_bytes)
    rows = dict(report.collectives)
    ring = {k: b for k, b in rows.items() if k.startswith("grad ring")}
    if case == "q8_hier":
        levels = tr.wire_bytes_model()
        intra = rows["grad ring intra-slice (f32 wire)"]
        inter = rows["grad ring inter-slice (int8 wire)"]
        assert sent == {(lv, r): b for r in range(n)
                        for lv, b in (("intra", intra), ("inter", inter))}
        assert (intra, inter) == (levels["intra"], levels["inter"])
        assert intra + inter == tr.modeled_wire_bytes_per_step()
    elif ring:
        (wire,) = ring.values()
        assert sent == {("data", r): wire for r in range(n)} and wire > 0
        assert wire == tr.modeled_wire_bytes_per_step()
    else:
        assert sent == {}
        if case == "q8_reference":
            assert rows["grad all-reduce (f32 wire)"] == (
                tr.modeled_wire_bytes_per_step())


# ---------------------------------------------------------------------------
# the serving KV pool: the model against the Engine's pool tensors
# ---------------------------------------------------------------------------


LM_SERVE = """
name: "lm-serve"
neuralnet {{
  layer {{ name: "emb" type: "kEmbedding"
    embedding_param {{ vocab_size: 64 embedding_dim: 32 max_len: 64 }} }}
  layer {{ name: "a0" type: "kAttention" srclayers: "emb"
    attention_param {{ num_heads: 2 }} }}
  layer {{ name: "a1" type: "kAttention" srclayers: "a0"
    attention_param {{ num_heads: 2 }} }}
}}
serving {{ slots: 3 kv_block_len: 8 kv_blocks: {kv_blocks} }}
"""


def pool_bytes(eng) -> int:
    return sum(t.numel() * t.element_size() for rank in eng._pools
               for kv in rank.values() for t in kv)


@pytest.mark.parametrize("kv_blocks, extra", [
    (0, 0), (11, 0), (11, 1),
], ids=["dense_equivalent", "declared", "planted_one_more_block"])
def test_kv_bytes_equal_the_engine_pool(kv_blocks, extra):
    """kv_bytes equals the bytes of the K/V pools an Engine built from
    the conf's serving block allocates; an Engine given one block more
    than the conf says misses it (the planted fault)."""
    text = LM_SERVE.format(kv_blocks=kv_blocks)
    cfg = t_parse(text)
    kv = t_cost.kv_pool_bytes(cfg, {}, [])
    assert kv == j_cost.kv_pool_bytes(j_parse(text), {}, []) > 0
    lm = lm_config_from_conf(cfg)
    serving = EngineConfig.from_conf(cfg.serving, cfg.kernels)
    if extra:
        serving = dataclasses.replace(serving,
                                      kv_blocks=serving.kv_blocks + extra)
    eng = Engine(init_lm(torch.Generator().manual_seed(0), lm, "cpu"), lm,
                 serving, device="cpu", graphs=False)
    assert (pool_bytes(eng) == kv) == (not extra)


# ---------------------------------------------------------------------------
# the rule arms, against the JAX package's
# ---------------------------------------------------------------------------


CLUSTER2 = 'workspace: "ws"\nnworkers: 2\n'


def diags(col):
    return [dataclasses.asdict(d) for d in col.sorted()]


@pytest.mark.parametrize("budget, comm_fraction, rollout, codes", [
    (40_000, None, False, {"MEM001"}),   # the slots alone exceed it
    (1 << 30, None, False, set()),
    (0, 0.001, False, {"COST001"}),      # a squeezed comm fraction
    (0, 0.0, False, set()),              # COST001 disabled
    ("half", None, True, {"ROL001"}),    # the staged tree overflows
], ids=["mem001", "roomy", "cost001", "cost001_off", "rol001"])
def test_cost_rules_match_jax(shards, budget, comm_fraction, rollout,
                              codes):
    extra = ('fleet { rollout { checkpoint: "ck.npz" version: 2 } }'
             if rollout else "")
    got = []
    for side, parse, cost, cluster, col in (
            ("jax", j_parse, j_cost, j_cluster, JCollector()),
            ("port", t_parse, t_cost, t_cluster, Collector())):
        cfg = parse(MLP_CONF.format(
            shard=shards[side], zero="false", train_steps=4,
            checkpoint_frequency=0, checkpoint_format="npz", extra=extra))
        b = budget
        if b == "half":
            r = cost.build_cost_model(cfg, {"data": 2}, "t.conf")
            b = r.hbm_bytes + r.param_bytes // 2
        cl, widths = cluster(CLUSTER2 + (f"device_hbm_bytes: {b}\n"
                                         if b else ""), "c.conf",
                             type(col)())
        kw = {} if comm_fraction is None else {
            "comm_fraction": comm_fraction}
        report = cost.cost_rules(cfg, cl, widths, "t.conf", col, **kw)
        got.append((diags(col), dataclasses.asdict(report)))
    assert got[1] == got[0]
    assert {d["code"] for d in got[1][0]} == codes


@pytest.mark.parametrize("kv_blocks, budget, n", [
    (5, 0, 1), (33, 0, 0), (5, 10_000, 2), (5, 1 << 30, 1),
], ids=["undersized", "exact", "pool_over_budget", "roomy"])
def test_srv002_matches_jax(kv_blocks, budget, n):
    text = SRV_CONF.format(kv_blocks=kv_blocks)
    got = []
    for parse, cost, cluster, col in (
            (j_parse, j_cost, j_cluster, JCollector()),
            (t_parse, t_cost, t_cluster, Collector())):
        cl = cluster(CLUSTER2 + f"device_hbm_bytes: {budget}\n", "c.conf",
                     type(col)())[0] if budget else None
        cost.serving_cost_rules(parse(text), cl, {}, "t.conf", col)
        got.append(diags(col))
    assert got[1] == got[0]
    assert len(got[1]) == n and all(d["code"] == "SRV002" for d in got[1])


@pytest.mark.parametrize("ticks, unified", [
    (1, False), (1000, False), (0, False), (1, True),
], ids=["both_short", "clear", "no_load", "unified"])
def test_flt002_matches_jax(ticks, unified):
    text = FLT_CONF.format(ticks=ticks)
    if unified:
        text = text.replace("role: prefill", "role: unified").replace(
            "role: decode", "role: unified")
    got = []
    for parse, cost, col in ((j_parse, j_cost, JCollector()),
                             (t_parse, t_cost, Collector())):
        cost.fleet_cost_rules(parse(text), None, "t.conf", col)
        got.append(diags(col))
    assert got[1] == got[0]
    assert len(got[1]) == (2 if ticks == 1 else 0)


def test_explain_cost_matches_jax_but_the_inter_slice_row(
        shards, tmp_path, capsys):
    cl = tmp_path / "cluster.conf"
    cl.write_text('workspace: "ws"\nnworkers: 4\n'
                  "inter_slice_bandwidth: 25000000000\n")
    out = {}
    for side, mod in (("jax", j_cli), ("port", t_cli)):
        conf = tmp_path / f"{side}.conf"
        conf.write_text(conf_text("q8_hier", shards[side]))
        assert mod.main([str(conf), "--cluster", str(cl),
                         "--explain-cost"]) == 0
        out[side] = capsys.readouterr().out.replace(str(conf), "job.conf")
    j_lines, t_lines = out["jax"].splitlines(), out["port"].splitlines()
    assert len(j_lines) == len(t_lines)
    differ = [(a, b) for a, b in zip(j_lines, t_lines) if a != b]
    assert len(differ) == 1, differ
    j_row, t_row = differ[0]
    assert "DCN" in j_row and j_row.replace(
        "DCN", "inter_slice_bandwidth") == t_row
    assert "grad ring inter-slice (int8 wire)" in out["port"]
