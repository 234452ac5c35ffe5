"""kLayerPartition on kConvolution, kBatchNorm and kRBM (each declares a
neuron axis): ``ConvolutionLayer.apply_ranks`` (each model rank's
filters, Concate on the channel dim), ``BatchNormLayer.
apply_stateful_lanes`` (each rank's channels, the moments over the data
ranks) and the RBM's hidden units inside the CD step's Gibbs chain
(``RBMLayer.cd_grads_ranks`` inside ``CDTrainer._step_core``).

tests/test_torch_norm.py's conv + kBatchNorm net with kLayerPartition
on data 2 x model 2 is held to the JAX Trainer on the same mesh: losses
within 1e-4 over 4 steps, the running stats within 1e-5.
examples/mnist/rbm.conf, narrowed as tests/test_torch_rbm.py narrows it
(its third RBM at 24 hidden units: the JAX package cannot pad an uneven
RBM split), with kLayerPartition on data 2 x model 2 through the CD
engine, is held to the JAX CDTrainer on the same mesh with both
packages' Bernoulli draws taken from one table of uniforms: every RBM's
reconstruction error within 1e-5 over 4 steps and the params within
1e-5. A planted fault (the conv's Concate in reversed rank order) must
move the conv net past the bar 100 times.

The ranks that hold the same rows draw alike: ResNet-18 at size 32
(kRGBImage's random mirrors) with kLayerPartition on data 2 x model 2
equals data 2 at the same global batch within 1e-5 over 3 steps (each
lane's draws keyed by its data index; keyed by its rank, a model
group's ranks mirrored their rows apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.trainer import make_trainer as j_make_trainer
from singa_tpu_torch.config import parse_cluster_config as t_cluster
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.layers import neuron as t_neuron
from singa_tpu_torch.layers import rbm as t_rbm
from singa_tpu_torch.parallel import build_mesh
from singa_tpu_torch.models.resnet import resnet_conf
from singa_tpu_torch.trainer import Trainer, make_trainer, params_from_numpy
from test_torch_axes_bn_seam import DM, STATS_TOL, bn_losses, bn_runs
from test_torch_axes_seam import RES_TOL, res_gap, residuals
from test_torch_axes_seq import LOSS_TOL, close, one_torch_thread  # noqa
from test_torch_moe_routing import jax_mesh, width_of
from test_torch_norm import bn_text, shards  # noqa: F401 (fixture)
from test_torch_rbm import RBM_CONF, confs, step_metrics, table

RBM_TOL = 1e-5


def tp(text: str) -> str:
    return text.replace("neuralnet {",
                        "neuralnet {\n  partition_type: kLayerPartition", 1)


def test_conv_and_batchnorm_split_over_model_match_jax(shards):
    jl, jb, tr = bn_runs(shards, tp(bn_text(shards)))
    assert tr._layout["conv/weight"] == (0, "model")
    assert tr._layout["bn/gamma"] == (0, "model")
    close(bn_losses(tr), jl, LOSS_TOL)
    for k, v in jb.items():
        if k in tr.buffers:
            close(tr.buffers[k], v, STATS_TOL)


def _reversed_filters(self, params, inputs, lanes, *, training):
    """The planted fault: the conv's filter shards joined in reversed
    rank order."""
    outs = [None] * len(params)
    for g in lanes.groups("model"):
        out = torch.cat([self.apply(params[j], inputs[j], training=training)
                         for j in g][::-1], 1)[:, :self.num_filters]
        for j in g:
            outs[j] = out
    return outs


def test_reversed_concate_exceeds_the_bar(shards, monkeypatch):
    monkeypatch.setattr(t_neuron.ConvolutionLayer, "apply_ranks",
                        _reversed_filters)
    jl, _, tr = bn_runs(shards, tp(bn_text(shards)))
    diff = float(np.max(np.abs(np.asarray(bn_losses(tr)) - jl)))
    assert diff > 100 * LOSS_TOL, diff


@pytest.fixture
def injected(monkeypatch):
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p: jnp.asarray(table(p.shape)) < p)
    monkeypatch.setattr(
        t_rbm, "bernoulli",
        lambda gen, p: torch.from_numpy(table(p.shape)).to(p.device) < p)


def rbm_runs(shards, widths: dict, part: bool, comm: str = ""):
    """rbm.conf (narrowed, with the ``grad_comm`` block ``comm``) on a
    mesh of ``widths`` in both packages from the same params, 4 steps ->
    ([(JAX, port) metrics], JAX, port)."""
    jc, tc = confs(RBM_CONF, {"train": shards["train"],
                              "test": shards["test"]})
    for cfg, parse in ((jc, j_parse), (tc, t_parse)):
        if comm:
            cfg.grad_comm = parse(comm).grad_comm
        if part:
            cfg.neuralnet.partition_type = "kLayerPartition"
        for layer in cfg.neuralnet.layer:
            if layer.rbm_param is not None and \
                    layer.rbm_param.num_hidden == 25:
                layer.rbm_param.num_hidden = 24
    jt = j_make_trainer(jc, mesh=jax_mesh(widths), seed=0,
                        log=lambda s: None, prefetch=False)
    params = {n: np.asarray(v) for n, v in jt.params.items()}
    tt = make_trainer(tc, mesh=build_mesh(widths["data"],
                                          widths.get("model", 1),
                                          ["cpu"] * width_of(widths)),
                      seed=0, log=lambda s: None)
    assert type(tt).__name__ == "CDTrainer"
    tt.params = params_from_numpy(tt.train_net, params)
    return [(step_metrics(jt, s), step_metrics(tt, s))
            for s in range(4)], jt, tt


def test_rbm_split_over_model_matches_the_jax_cd_trainer(shards, injected):
    steps, jt, tt = rbm_runs(shards, DM, True)
    assert tt._layout["rbm1/weight"] == (1, "model")
    for want, got in steps:
        assert got.keys() == want.keys()
        for k in want:
            close(got[k], want[k], RBM_TOL)
    for n, v in jt.params.items():
        close(tt._unpad_one(n, tt.params[n]), np.asarray(v), RBM_TOL)


def _per_rank_chains(cd_grads_ranks):
    """The planted fault: each of 2 data ranks runs its own chain on its
    half of the batch (draws of the half's shapes), the grads and
    metrics averaged."""
    def run(self, ps, v0, generator):
        halves = [cd_grads_ranks(self, ps, h, generator)
                  for h in v0.chunk(2)]
        return ({n: [(a + b) / 2 for a, b in zip(*(g[n] for g, _ in halves))]
                 for n in halves[0][0]},
                {k: (halves[0][1][k] + halves[1][1][k]) / 2
                 for k in halves[0][1]})
    return run


@pytest.mark.parametrize("fault", [False, True], ids=["global", "per_rank"])
def test_rbm_on_data_2_runs_the_jax_global_chain(shards, injected,
                                                  monkeypatch, fault):
    """The CD engine on a data-only mesh runs the JAX program's one chain
    over the global batch, within RBM_TOL of the JAX CDTrainer on data
    2; a chain per rank (the port's step before it) exceeds the bar 100
    times."""
    if fault:
        monkeypatch.setattr(t_rbm.RBMLayer, "cd_grads_ranks",
                            _per_rank_chains(t_rbm.RBMLayer.cd_grads_ranks))
    steps, _, _ = rbm_runs(shards, {"data": 2}, False)
    diff = max(abs(got[k] - want[k]) for want, got in steps for k in want)
    assert (diff > 100 * RBM_TOL) if fault else (diff <= RBM_TOL), diff


@pytest.mark.parametrize("widths,part", [({"data": 2}, False), (DM, True)],
                         ids=["data", "model"])
def test_rbm_through_the_quantized_seam_matches_jax(shards, injected,
                                                    widths, part):
    """``grad_comm { mode: quantized }`` int8 on the CD engine: the CD
    grads through the seam, as the JAX CDTrainer takes them, within
    RBM_TOL over 4 steps, the residuals after them within
    test_torch_axes_seam.py's RES_TOL of the JAX residuals (a skipped
    seam banks none, a gap of 1.0)."""
    steps, jt, tt = rbm_runs(shards, widths, part,
                             'grad_comm { mode: quantized dtype: "int8" }')
    assert tt.comm_mode == jt.comm_mode == "quantized"
    for want, got in steps:
        for k in want:
            close(got[k], want[k], RBM_TOL)
    want = residuals(jt)
    assert set(want) == {f"__gradres__/{n}" for n in tt.params}
    assert res_gap(residuals(tt), want) <= RES_TOL


def test_a_model_groups_ranks_draw_alike(tmp_path):
    sh = {k: str(tmp_path / k) for k in ("train", "test")}
    t_loader.write_records(sh["train"], *t_loader.structured_rgb(32))
    t_loader.write_records(sh["test"], *t_loader.structured_rgb(
        16, noise_seed=1))
    text = tp(resnet_conf(18, classes=10, batchsize=8, size=32,
                          train_shard=sh["train"], test_shard=sh["test"],
                          compute_dtype="float32"))
    runs = []
    for cl in ("nworkers: 2", "nworkers: 4\nnprocs_per_group: 2"):
        tr = Trainer(t_parse(text), t_cluster(f'{cl}\nworkspace: '
                                              f'"{tmp_path}/ws"'),
                     seed=0, log=lambda s: None, device="cpu")
        runs.append(bn_losses(tr, 3))
    assert tr._layout["conv1/weight"] == (0, "model")
    close(runs[1], runs[0], RBM_TOL)
