"""The port's fleet across OS processes, through the launch line: two
processes run ``python -m singa_tpu_torch.main -model_conf fleet.conf
-device cpu -procsID k`` (rank 0 the prefill host, rank 1 the decode
host) and the test plays the front door over the shared Mailbox. Then a
mixed pair: rank 0 is ``python -m singa_tpu.main``, rank 1 the port's,
both serving one npz ``checkpoint:`` (each package's seed init draws
from its own RNG, so a shared save is how two packages serve one set of
weights).

Tolerance: every stream is identical to the in-process unified
engine's, token for token, and finishes on the decode host.
"""

import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import torch

from singa_tpu.models.transformer import init_lm as j_init_lm
from singa_tpu.serve import Engine as JEngine
from singa_tpu.serve import EngineConfig as JEngineConfig
from singa_tpu.serve import Request as JRequest
from singa_tpu.serve import Scheduler as JScheduler
from singa_tpu.serve.fleet.host import lm_config_from_conf as j_lm_config
from singa_tpu.trainer.checkpoint import save_checkpoint as j_save
from singa_tpu_torch.config import parse_model_config
from singa_tpu_torch.models.transformer import init_lm
from singa_tpu_torch.serve import Engine, EngineConfig, Request, Scheduler
from singa_tpu_torch.serve.fleet import Mailbox
from singa_tpu_torch.serve.fleet.host import lm_config_from_conf
from singa_tpu_torch.serve.fleet.router import encode_request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLEET_CONF = """
name: "fleet-test"
neuralnet {
  layer { name: "embed" type: "kEmbedding"
    embedding_param { vocab_size: 32 embedding_dim: 32 max_len: 32 } }
  layer { name: "attn" type: "kAttention" srclayers: "embed"
    attention_param { num_heads: 2 } }
  layer { name: "attn2" type: "kAttention" srclayers: "attn"
    attention_param { num_heads: 2 } }
}
serving { slots: 2 kv_block_len: 8 max_prefill_chunk: 4 }
fleet { role: "auto" prefill_hosts: 1 }
"""
EC = dict(slots=2, kv_block_len=8, max_prefill_chunk=4)


def workload(n=3, seed=6):
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(0, 32, size=(int(rs.randint(3, 9)),))
               .astype(np.int32) for _ in range(n)]
    return prompts, [int(rs.randint(4, 10)) for _ in range(n)]


def write_confs(tmp_path, extra=""):
    ws = tmp_path / "ws"
    model_conf = tmp_path / "fleet.conf"
    cluster_conf = tmp_path / "cluster.conf"
    model_conf.write_text(FLEET_CONF + extra)
    cluster_conf.write_text(
        f'nworkers: 2\nnprocs_per_group: 1\nworkspace: "{ws}"\n')
    return ws, model_conf, cluster_conf


def launch(modules, model_conf, cluster_conf):
    """One host process per rank: ``modules[k]`` is the package whose
    main runs rank k (the port's on the CPU)."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    env.pop("XLA_FLAGS", None)
    procs = []
    for k, mod in enumerate(modules):
        cmd = [sys.executable, "-m", f"{mod}.main",
               "-model_conf", str(model_conf),
               "-cluster_conf", str(cluster_conf), "-procsID", str(k)]
        if mod == "singa_tpu_torch":
            cmd += ["-device", "cpu"]
        procs.append(subprocess.Popen(
            cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    return procs


def front_door(ws, procs, prompts, budgets, timeout=240):
    """Send the requests to host0, collect every result, shut both
    hosts down; -> {rid: result}, each host's output."""
    outs = []
    try:
        mb = Mailbox(str(ws / "fleet"))
        mb.register("frontdoor")
        for i, (p, m) in enumerate(zip(prompts, budgets)):
            mb.send("host0", "request",
                    encode_request(Request(rid=i, prompt=p,
                                           max_new_tokens=m)),
                    src="frontdoor")
        results = {}
        deadline = time.monotonic() + timeout
        while len(results) < len(prompts):
            dead = [p for p in procs if p.poll() is not None]
            assert not dead, dead[0].stdout.read().decode()[-3000:]
            assert time.monotonic() < deadline, (
                "fleet processes did not deliver results",
                [p.poll() for p in procs])
            for msg in mb.recv("frontdoor"):
                if msg.kind == "result":
                    d = json.loads(msg.payload.decode())
                    results[d["rid"]] = d
            time.sleep(0.02)
        for name in ("host0", "host1"):
            mb.send(name, "shutdown", b"", src="frontdoor")
        for p in procs:
            out = p.communicate(timeout=120)[0].decode()
            outs.append(out)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return results, outs


def test_two_port_processes_over_the_mailbox(tmp_path):
    ws, model_conf, cluster_conf = write_confs(tmp_path)
    cfg = lm_config_from_conf(parse_model_config(FLEET_CONF))
    params = init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    prompts, budgets = workload()
    sched = Scheduler(Engine(params, cfg, EngineConfig(**EC),
                             device="cpu"))
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=m))
    sched.serve()
    want = {r.rid: list(r.tokens) for r in sched.finished}
    procs = launch(["singa_tpu_torch"] * 2, model_conf, cluster_conf)
    results, outs = front_door(ws, procs, prompts, budgets)
    assert {i: r["tokens"] for i, r in results.items()} == want
    assert {r["host"] for r in results.values()} == {"host1"}
    assert "role prefill, device cpu" in outs[0]
    assert "role decode, device cpu" in outs[1]


def test_jax_prefill_and_port_decode_processes_share_an_npz(tmp_path):
    """Rank 0 runs ``singa_tpu.main``, rank 1 ``singa_tpu_torch.main``;
    both overlay one npz of the JAX package's weights. Every sequence
    crosses packages and processes, and the streams equal the JAX
    unified engine's on those weights."""
    jcfg = j_lm_config(parse_model_config(FLEET_CONF))
    jp = j_init_lm(jax.random.PRNGKey(5), jcfg)
    npz = str(tmp_path / "step_1.npz")
    j_save(npz, 1, jp)
    ws, model_conf, cluster_conf = write_confs(
        tmp_path, extra=f'checkpoint: "{npz}"\n')
    prompts, budgets = workload(seed=8)
    sched = JScheduler(JEngine(jp, jcfg, JEngineConfig(**EC)))
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        sched.submit(JRequest(rid=i, prompt=p, max_new_tokens=m))
    sched.serve()
    want = {r.rid: list(r.tokens) for r in sched.finished}
    procs = launch(["singa_tpu", "singa_tpu_torch"], model_conf,
                   cluster_conf)
    results, outs = front_door(ws, procs, prompts, budgets)
    assert {i: r["tokens"] for i, r in results.items()} == want
    assert {r["host"] for r in results.values()} == {"host1"}
    assert "restored" in outs[1] and "device cpu" in outs[1]
