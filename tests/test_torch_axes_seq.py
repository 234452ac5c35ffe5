"""The port's seq axis (singa_tpu_torch/parallel/ring.py and the seq forms
of kEmbedding, kAttention and kLMLoss) against the JAX package.

``ring_attention`` is held to the JAX ``ring_attention`` (shard_map over
the suite's virtual CPU devices) on (seq 4) and (data 2, seq 4): outputs
and gradients within 1e-5. The ring conf trains on data 2 x seq 4 CPU
ranks and is held to the JAX Trainer's single-device dense run of the
same conf and params within 1e-4 over 4 steps; the positional rows are
drawn wide (std 0.5) so that a rank embedding LOCAL positions, or a
loss dropping each shard's boundary target, moves the loss far past
that bar (both are planted below and must exceed it).

This file also holds the LM conf the other ``test_torch_axes_*`` files
train (d 32, vocab 64, S 16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.config import parse_model_config as j_parse
from singa_tpu.parallel import build_mesh as j_mesh
from singa_tpu.parallel.ring import build_sp_mesh, ring_attention as j_ring
from singa_tpu.trainer import Trainer as JTrainer
from singa_tpu_torch.config import parse_cluster_config as t_cluster
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.layers import sequence as t_seq
from singa_tpu_torch.parallel import ring as t_ring
from singa_tpu_torch.parallel.ring import ring_attention
from singa_tpu_torch.trainer import Trainer, params_from_numpy

OP_TOL = 1e-5
LOSS_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread (the suite's xdist workers
    contend for the cores otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ffn(i: str, loc: str, up: int) -> str:
    return f"""
  layer {{ {loc}name: "{i}ln2" type: "kLayerNorm" srclayers: "{i}res1"
    param {{ name: "scale" init_method: "kConstant" value: 1 }}
    param {{ name: "bias" init_method: "kConstant" value: 0 }} }}
  layer {{ {loc}name: "{i}up" type: "kDense" srclayers: "{i}ln2"
    dense_param {{ num_output: {up} activation: "gelu" }}
    param {{ name: "weight" init_method: "kUniformSqrtFanIn" }}
    param {{ name: "bias" init_method: "kUniform" low: -0.2 high: 0.2 }} }}
  layer {{ {loc}name: "{i}down" type: "kDense" srclayers: "{i}up"
    dense_param {{ num_output: 32 }}
    param {{ name: "weight" init_method: "kUniformSqrtFanIn" }}
    param {{ name: "bias" init_method: "kUniform" low: -0.2 high: 0.2 }} }}
  layer {{ {loc}name: "{i}res2" type: "kAdd" srclayers: "{i}res1"
    srclayers: "{i}down" }}
"""


def _moe(i: str, dispatch: str, cf: float) -> str:
    return f"""
  layer {{ name: "{i}ln2" type: "kLayerNorm" srclayers: "{i}res1"
    param {{ name: "scale" init_method: "kConstant" value: 1 }}
    param {{ name: "bias" init_method: "kConstant" value: 0 }} }}
  layer {{ name: "{i}moe" type: "kMoE" srclayers: "{i}ln2"
    moe_param {{ num_experts: 4 d_ff: 64 aux_loss_weight: 0.01
                 capacity_factor: {cf} dispatch: "{dispatch}" }}
    param {{ name: "gate" init_method: "kGaussain" std: 0.5 }}
    param {{ name: "up" init_method: "kUniformSqrtFanIn" }}
    param {{ name: "down" init_method: "kUniformSqrtFanIn" }} }}
  layer {{ name: "{i}res2" type: "kAdd" srclayers: "{i}res1"
    srclayers: "{i}moe" }}
"""


def _block(i: str, src: str, mode: str, ffn: str, loc: str = "") -> str:
    return f"""
  layer {{ {loc}name: "{i}ln1" type: "kLayerNorm" srclayers: "{src}"
    param {{ name: "scale" init_method: "kConstant" value: 1 }}
    param {{ name: "bias" init_method: "kConstant" value: 0 }} }}
  layer {{ {loc}name: "{i}attn" type: "kAttention" srclayers: "{i}ln1"
    attention_param {{ num_heads: 2 mode: "{mode}" }}
    param {{ name: "qkv" init_method: "kUniformSqrtFanIn" }}
    param {{ name: "out" init_method: "kUniformSqrtFanIn" }} }}
  layer {{ {loc}name: "{i}res1" type: "kAdd" srclayers: "{src}"
    srclayers: "{i}attn" }}
{ffn}"""


def lm_text(shard: str, *, mode: str = "dense", moe: str = "",
            cf: float = 4.0, up: int = 64, part: bool = False,
            stages: bool = False, nmicro: int = 0, batch: int = 8,
            extra: str = "") -> str:
    """The test LM (d 32, 2 heads, vocab 64, float32, lr 0.05): one
    block, its FFN a kMoE with ``moe`` dispatch when given; with
    ``stages`` two blocks placed at locationid 0 and 1."""
    if stages:
        body = "".join(
            _block(f"b{s}_", src, mode, _ffn(f"b{s}_", loc, up), loc)
            for s, src, loc in ((0, "embed", "locationid: 0 "),
                                (1, "b0_res2", "locationid: 1 ")))
        last = "b1_res2"
    else:
        ffn = _moe("", moe, cf) if moe else _ffn("", "", up)
        body = _block("", "embed", mode, ffn)
        last = "res2"
    micro = f"pipeline_microbatches: {nmicro}" if nmicro else ""
    return f"""
name: "axes-test"
train_steps: 4
{micro}
{extra}
updater {{ type: kSGD momentum: 0.9 base_learning_rate: 0.05
           param_type: "Param" }}
neuralnet {{
  {"partition_type: kLayerPartition" if part else ""}
  layer {{ name: "data" type: "kSequenceData"
    data_param {{ path: "{shard}" batchsize: {batch} }} }}
  layer {{ name: "embed" type: "kEmbedding" srclayers: "data"
    embedding_param {{ vocab_size: 64 embedding_dim: 32 }}
    param {{ name: "tok" init_method: "kGaussain" std: 0.5 }}
    param {{ name: "pos" init_method: "kGaussain" std: 0.5 }} }}
{body}
  layer {{ name: "ln_f" type: "kLayerNorm" srclayers: "{last}"
    param {{ name: "scale" init_method: "kConstant" value: 1 }}
    param {{ name: "bias" init_method: "kConstant" value: 0 }} }}
  layer {{ name: "head" type: "kDense" srclayers: "ln_f"
    dense_param {{ num_output: 64 bias_term: false }}
    param {{ name: "weight" init_method: "kGaussain" std: 0.3 }} }}
  layer {{ name: "loss" type: "kLMLoss" srclayers: "head" srclayers: "data" }}
}}
"""


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("axes") / "tok")
    t_loader.write_records(
        path, *t_loader.synthetic_token_arrays(64, seq_len=16, vocab=64))
    return path


def cluster(text: str, tmp_path=None):
    ws = tmp_path if tmp_path is not None else "ws"
    return t_cluster(f'{text}\nworkspace: "{ws}"\n')


def jax_run(text: str, steps: int = 4, mesh=None):
    """The JAX Trainer on one device (or ``mesh``) -> (losses, its
    params as numpy)."""
    jt = JTrainer(j_parse(text), None,
                  mesh=mesh or j_mesh(1, 1, jax.devices()[:1]), seed=0,
                  log=lambda s: None, prefetch=False)
    params = {n: np.asarray(v) for n, v in jt.params.items()}
    return losses_of(jt, steps), params


def losses_of(tr, steps: int) -> list:
    out = []
    for s in range(steps):
        tr.train_one_batch(s)
        (m,) = tr.perf.avg().values()
        out.append(float(m["loss"]))
        tr.perf.reset()
    return out


def port_trainer(text: str, cl, params: dict, **kw) -> Trainer:
    tr = Trainer(t_parse(text), cl, seed=0, log=lambda s: None,
                 device="cpu", prefetch=False, device_cache=False, **kw)
    tr.params = params_from_numpy(tr.train_net, params)
    return tr


def close(a, b, tol) -> float:
    diff = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
    assert diff <= tol, (a, b)
    return diff


# ---------------------------------------------------------------------------
# ring_attention against the JAX shard_map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndata,nseq", [(1, 4), (2, 4)])
def test_ring_attention_matches_jax(ndata, nseq):
    rng = np.random.default_rng(ndata)
    q, k, v, w = (rng.standard_normal((4, 2, 32, 16)).astype(np.float32)
                  for _ in range(4))
    mesh = build_sp_mesh(ndata, nseq, jax.devices()[:ndata * nseq])

    def jloss(q, k, v):
        out = j_ring(q, k, v, mesh, causal=True)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    tq, tk, tv = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    tout = ring_attention(tq, tk, tv, ndata=ndata, nseq=nseq, causal=True)
    (tout * torch.tensor(w)).sum().backward()
    close(tout.detach(), jout, OP_TOL)
    for tg, jg in zip((tq.grad, tk.grad, tv.grad), jgrads):
        close(tg, jg, OP_TOL)


# ---------------------------------------------------------------------------
# the ring conf on data 2 x seq 4
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ring_ref(shard):
    """The JAX Trainer's single-device dense run of the ring conf."""
    return jax_run(lm_text(shard, mode="dense"))


SP = "nworkers: 8\nnprocs_per_group: 4\nnseq_per_group: 4"


def test_ring_conf_matches_jax_dense_single_device(shard, ring_ref):
    jl, params = ring_ref
    tr = port_trainer(lm_text(shard, mode="ring"), cluster(SP), params)
    assert tr.mesh.shape == {"data": 2, "pipe": 1, "expert": 1, "seq": 4,
                             "model": 1}
    assert tr.dispatch_mode == "eager"
    close(losses_of(tr, 4), jl, LOSS_TOL)


def _local_positions(self, params, inputs, lanes, *, training):
    return [self.apply(p, x, training=training)
            for p, x in zip(params, inputs)]


def _shard_local_loss(self, params, inputs, lanes, *, training):
    outs = [self.apply(p, x, training=training)
            for p, x in zip(params, inputs)]
    for g in lanes.groups("seq"):
        loss = sum(outs[j][0] for j in g) / len(g)
        for j in g:
            outs[j] = (loss, {"loss": loss, "precision": loss})
    return outs


@pytest.mark.parametrize("fault", [
    (t_seq.EmbeddingLayer, "apply_ranks", _local_positions),
    (t_seq.LMLossLayer, "apply_ranks", _shard_local_loss),
    (t_ring, "_visitor", lambda my, i, n: (my - i + 1) % n),
], ids=["local_positions", "seq_local_loss", "visitor_one_off"])
def test_ring_conf_bar_catches_a_local_shard(shard, ring_ref, monkeypatch,
                                             fault):
    """A rank embedding its shard at local positions, each shard's loss
    dropping its boundary target and averaging per shard, or each K/V
    block masked as if it came from one rank further on, moves the
    losses past the bar."""
    jl, params = ring_ref
    monkeypatch.setattr(*fault)
    tr = port_trainer(lm_text(shard, mode="ring"), cluster(SP), params)
    diff = float(np.max(np.abs(np.asarray(losses_of(tr, 2))
                               - np.asarray(jl[:2]))))
    assert diff > 100 * LOSS_TOL, diff


def test_flash_mode_on_a_seq_axis_attends_the_gathered_blocks(shard,
                                                              ring_ref):
    """A non-ring mode on a seq axis attends the seq group's K/V
    gathered: the global attention the JAX program computes."""
    jl, params = ring_ref
    tr = port_trainer(lm_text(shard, mode="flash"), cluster(SP), params)
    close(losses_of(tr, 4), jl, LOSS_TOL)
