"""The port's sampling CLI (singa_tpu_torch/tools/generate.py) against the
JAX package's (singa_tpu/tools/generate.py) on one npz checkpoint, and
the Trainer accepting a conf that selects the serving tier's fused
paged-attention kernel.

The net is test_torch_conf_decode's narrowed tinylm.conf with its
spread numpy params. Both CLIs read the same checkpoint file (written
once by the port's save_checkpoint and once by the JAX package's) and
must write the same bytes to stdout, greedy, in byte and in ``-raw``
form. Temperature streams come from each framework's own RNG: the
port's is checked for determinism under ``-seed`` and for staying in
the vocab, not against JAX.
"""

import sys

import numpy as np
import pytest

from singa_tpu.tools import generate as j_generate
from singa_tpu.trainer.checkpoint import save_checkpoint as j_save
from singa_tpu_torch.config import parse_model_config as t_parse
from singa_tpu_torch.data import loader as t_loader
from singa_tpu_torch.serve import EngineConfig
from singa_tpu_torch.tools import generate as t_generate
from singa_tpu_torch.trainer import Trainer
from singa_tpu_torch.trainer.checkpoint import load_checkpoint
from singa_tpu_torch.trainer.checkpoint import save_checkpoint as t_save
from test_torch_conf_decode import SEQ, narrow_tinylm, spread_params
from test_torch_zero import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """(conf path, {"port": npz, "jax": npz}) holding one param set."""
    root = tmp_path_factory.mktemp("gen")
    shard = str(root / "shard")
    t_loader.write_records(
        shard, *t_loader.synthetic_token_arrays(4, seq_len=SEQ, vocab=256))
    conf = root / "job.conf"
    conf.write_text(narrow_tinylm(shard))
    from singa_tpu_torch.graph.builder import build_net

    arrays = spread_params(build_net(t_parse(conf.read_text()),
                                     "kTest").param_specs())
    cks = {"port": str(root / "port.npz"), "jax": str(root / "jax.npz")}
    t_save(cks["port"], 7, {k: v.copy() for k, v in arrays.items()})
    j_save(cks["jax"], 7, arrays)
    return str(conf), cks


def run_cli(main, capfdbinary, args) -> bytes:
    capfdbinary.readouterr()
    assert main(args) == 0
    sys.stdout.flush()
    return capfdbinary.readouterr().out


@pytest.mark.parametrize("which", ["port", "jax"])
def test_cli_writes_the_jax_clis_bytes(job, capfdbinary, which):
    """One checkpoint (the port's npz or the JAX package's), greedy: the
    two CLIs' stdout bytes are equal, raw ids and decoded bytes; the
    prompt is long enough to take two prefill chunks."""
    conf, cks = job
    args = ["-model_conf", conf, "-checkpoint", cks[which],
            "-prompt", "the quick brown fox jumps over", "-n", "20"]
    for extra in ([], ["-raw"]):
        want = run_cli(j_generate.main, capfdbinary, args + extra)
        got = run_cli(t_generate.main, capfdbinary,
                      args + extra + ["-device", "cpu"])
        assert got == want
        assert len(want) > 20


def test_temperature_is_deterministic_under_seed_and_in_vocab(job,
                                                              capfdbinary):
    conf, cks = job
    args = ["-model_conf", conf, "-checkpoint", cks["port"], "-prompt",
            "abc", "-n", "24", "-temperature", "0.9", "-raw", "-device",
            "cpu"]
    a = run_cli(t_generate.main, capfdbinary, args + ["-seed", "5"])
    b = run_cli(t_generate.main, capfdbinary, args + ["-seed", "5"])
    c = run_cli(t_generate.main, capfdbinary, args + ["-seed", "6"])
    toks = [int(t) for t in a.split()]
    assert a == b and a != c
    assert len(toks) == 3 + 24 and all(0 <= t < 256 for t in toks)


def test_trainer_accepts_the_fused_paged_kernel_knob(job, tmp_path):
    """``kernels { paged_attention: fused }`` is the serving engine's
    knob: the Trainer trains such a conf (2 steps), its npz save
    round-trips and its params decode on the KV-cache path; the conf's
    engine config picks the kernel."""
    conf, _ = job
    txt = open(conf).read() + "\nkernels { paged_attention: fused }\n"
    cfg = t_parse(txt.replace("train_steps: 2000", "train_steps: 2"))
    tr = Trainer(cfg, seed=0, log=lambda s: None, device="cpu")
    tr.run()
    assert np.isfinite(tr.perf.avg()["loss"]["loss"])
    assert EngineConfig.from_conf(cfg.serving,
                                  cfg.kernels).attend_impl == "fused"
    path = str(tmp_path / "ck.npz")
    t_save(path, 2, tr.params, tr.state)
    assert load_checkpoint(path)[0] == 2
    info = {}
    from singa_tpu_torch.graph.builder import build_net

    toks = t_generate.generate_from_net(
        build_net(cfg, "kTest"), tr.params, [1, 2, 3], 4, 0.0, 0,
        info=info)
    assert info["path"] == "kv_cache" and len(toks) == 7
