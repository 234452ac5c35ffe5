"""One fleet, two packages: a JAX ``FleetHost`` and a port ``FleetHost``
over one Mailbox root in one process, on one set of weights (the JAX
package's ``init_lm``, handed to the port through ``load_jax_params``).

  - both role directions (JAX prefill -> port decode, port prefill ->
    JAX decode): greedy streams equal both packages' unified engines;
  - a ``cache_fetch``/``cache_ship`` across packages, both directions:
    the fetched prefix serves a hit and the stream equals a cold one;
  - a JAX ``RolloutController`` flips a port host and a port controller
    flips a JAX host: promoted, and new streams are the next weights';
  - ``encode_request``, the status JSON and the mailbox files are the
    same bytes in both packages;
  - a temperature slot's frame is still refused across packages.

Tolerance: greedy streams are identical, token for token (the bar the
JAX package holds its fused kernel to).
"""

import json
import os

import jax
import numpy as np
import pytest

from singa_tpu.models.transformer import TransformerConfig as JConfig
from singa_tpu.models.transformer import init_lm as j_init_lm
from singa_tpu.serve import Engine as JEngine
from singa_tpu.serve import EngineConfig as JEngineConfig
from singa_tpu.serve import Request as JRequest
from singa_tpu.serve import Scheduler as JScheduler
from singa_tpu.serve.fleet import FleetHost as JFleetHost
from singa_tpu.serve.fleet import Mailbox as JMailbox
from singa_tpu.serve.fleet import migrate as j_migrate
from singa_tpu.serve.fleet import router as j_router
from singa_tpu.serve.rollout import RolloutController as JRollout
from singa_tpu_torch.models.transformer import TransformerConfig as TConfig
from singa_tpu_torch.models.transformer import load_jax_params
from singa_tpu_torch.serve import Engine as TEngine
from singa_tpu_torch.serve import EngineConfig as TEngineConfig
from singa_tpu_torch.serve import Request as TRequest
from singa_tpu_torch.serve import Scheduler as TScheduler
from singa_tpu_torch.serve.fleet import FleetHost as TFleetHost
from singa_tpu_torch.serve.fleet import LocalTransport as TLocal
from singa_tpu_torch.serve.fleet import Mailbox as TMailbox
from singa_tpu_torch.serve.fleet import Router as TRouter
from singa_tpu_torch.serve.fleet import router as t_router
from singa_tpu_torch.serve.rollout import RolloutController as TRollout

DIMS = dict(vocab=32, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_len=32)
EC = dict(slots=2, kv_block_len=8, max_prefill_chunk=4)
PREFIX_EC = dict(slots=2, kv_block_len=8, max_prefill_chunk=8,
                 prefix_cache=True)


@pytest.fixture(scope="module")
def weights():
    """One weight set, both packages' form: (JAX tree, port tree)."""
    jp = j_init_lm(jax.random.PRNGKey(0), JConfig(**DIMS))
    return jp, load_jax_params({k: np.asarray(v) for k, v in jp.items()},
                               "cpu")


def workload(n=4, seed=0):
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(0, DIMS["vocab"], size=(int(rs.randint(3, 9)),))
               .astype(np.int32) for _ in range(n)]
    return prompts, [int(rs.randint(4, 10)) for _ in range(n)]


def unified_streams(pkg, params, prompts, budgets, ec=EC):
    """One unified engine of package ``pkg`` ("jax" or "torch")."""
    if pkg == "jax":
        sched = JScheduler(JEngine(params, JConfig(**DIMS),
                                   JEngineConfig(**ec)))
        req = JRequest
    else:
        sched = TScheduler(TEngine(params, TConfig(**DIMS),
                                   TEngineConfig(**ec), device="cpu"))
        req = TRequest
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        sched.submit(req(rid=i, prompt=p, max_new_tokens=m))
    sched.serve()
    return {r.rid: list(r.tokens) for r in sched.finished}


def host(pkg, name, role, weights, transport, peers, ec=EC, **kw):
    """A FleetHost of package ``pkg`` on the shared weights."""
    jp, tp = weights
    if pkg == "jax":
        return JFleetHost(name, role, JEngine(jp, JConfig(**DIMS),
                                              JEngineConfig(**ec)),
                          transport, peers=peers, **kw)
    return TFleetHost(name, role, TEngine(tp, TConfig(**DIMS),
                                          TEngineConfig(**ec),
                                          device="cpu"),
                      transport, peers=peers, **kw)


def drive(hosts, n_done, max_rounds=3000):
    idle = 0
    for _ in range(max_rounds):
        for h in hosts:
            h.tick()
        done = sum(1 for h in hosts for r in h.sched.finished if r.rid >= 0)
        if done >= n_done:
            return
        idle = idle + 1 if not any(h.busy for h in hosts) else 0
        assert idle < 5, "fleet stalled with requests unfinished"
    raise AssertionError("fleet did not finish in the round budget")


def streams(hosts, rid_min=0):
    return {r.rid: list(r.tokens) for h in hosts for r in h.sched.finished
            if r.rid >= rid_min}


def mailboxes(root):
    return {"jax": JMailbox(str(root)), "torch": TMailbox(str(root))}


@pytest.mark.parametrize("prefill,decode", [("jax", "torch"),
                                            ("torch", "jax")])
def test_split_roles_across_packages_equal_both_unified_engines(
        weights, tmp_path, prefill, decode):
    """Prefill on one package, decode on the other, over one Mailbox
    root: every sequence migrates across packages (a greedy frame in
    the JAX format), and the streams equal both unified engines'."""
    prompts, budgets = workload(n=4, seed=1)
    want = unified_streams("jax", weights[0], prompts, budgets)
    assert unified_streams("torch", weights[1], prompts, budgets) == want
    boxes = mailboxes(tmp_path)
    pre = host(prefill, "p0", "prefill", weights, boxes[prefill],
               {"d0": "decode"})
    dec = host(decode, "d0", "decode", weights, boxes[decode],
               {"p0": "prefill"})
    router = TRouter(TMailbox(str(tmp_path)))
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        assert router.submit(TRequest(rid=i, prompt=p,
                                      max_new_tokens=m)) == "p0"
    drive([pre, dec], len(prompts))
    assert streams([pre, dec]) == want
    assert pre.migrate_out == dec.migrate_in == len(prompts)
    assert dec.sched.prefill_chunks == 0 and pre.sched.decode_ticks == 0


@pytest.mark.parametrize("holder,fetcher", [("jax", "torch"),
                                            ("torch", "jax")])
def test_cache_fetch_and_ship_across_packages(weights, tmp_path, holder,
                                              fetcher):
    """The holder serves a prompt and publishes its digests; the other
    package's host fetches the blocks (cache_fetch -> cache_ship),
    installs them and hits: the stream equals a cold engine's."""
    prompt = (np.arange(22, dtype=np.int32) * 5) % DIMS["vocab"]
    n = 6
    boxes = mailboxes(tmp_path)
    h1 = host(holder, "h1", "unified", weights, boxes[holder],
              {"h0": "unified"}, ec=PREFIX_EC)
    h0 = host(fetcher, "h0", "unified", weights, boxes[fetcher],
              {"h1": "unified"}, ec=PREFIX_EC)
    req = {"jax": JRequest, "torch": TRequest}
    h1.submit(req[holder](rid=0, prompt=prompt, max_new_tokens=n))
    drive([h0, h1], 1)
    h0.submit(req[fetcher](rid=1, prompt=prompt, max_new_tokens=n))
    drive([h0, h1], 2)
    assert h0.cache_fetches == 1 and h0.cache_fetch_timeouts == 0
    assert h0.cache_ships_in == 1 and h1.cache_ships_out == 1
    assert h0.ship_blocks_in == 2 == h1.ship_blocks_out
    assert h0.sched.prefix_hits == 1
    cold = unified_streams(fetcher, weights[0 if fetcher == "jax" else 1],
                           [prompt], [n], ec=EC)[0]
    got = next(r for r in h0.sched.finished if r.rid == 1)
    assert list(got.tokens) == cold


class _Pump:
    def __init__(self, hosts):
        self.hosts = hosts

    def __call__(self):
        for h in self.hosts:
            h.tick()


@pytest.mark.parametrize("controller", ["jax", "torch"])
def test_rollout_controller_flips_the_other_package(weights, tmp_path,
                                                    controller):
    """A two-host unified fleet, one host of each package; the rollout
    controller of ``controller``'s package ships v1 (one weight frame
    format), canaries the OTHER package's host with probe parity, and
    promotes both. New streams equal the v1 unified engines'."""
    jp1 = j_init_lm(jax.random.PRNGKey(1), JConfig(**DIMS))
    tp1 = load_jax_params({k: np.asarray(v) for k, v in jp1.items()},
                          "cpu")
    boxes = mailboxes(tmp_path)
    other = "torch" if controller == "jax" else "jax"
    canary = host(other, "u0", "unified", weights, boxes[other],
                  {"u1": "unified"})
    mate = host(controller, "u1", "unified", weights, boxes[controller],
                {"u0": "unified"})
    peers = {"u0": "unified", "u1": "unified"}
    kw = dict(version=1, probes=2, probe_tokens=4, stage_timeout_s=20.0,
              tick=_Pump([canary, mate]))
    if controller == "jax":
        ctl = JRollout(boxes["jax"], peers, params=jp1, cfg=JConfig(**DIMS),
                       serving=JEngineConfig(**EC), **kw)
    else:
        ctl = TRollout(boxes["torch"], peers, params=tp1,
                       cfg=TConfig(**DIMS), serving=TEngineConfig(**EC),
                       device="cpu", **kw)
    res = ctl.run()
    assert res["verdict"] == "promoted", res
    assert res["canary"] == "u0" and sorted(res["flipped"]) == ["u0", "u1"]
    assert canary.engine.params_version == mate.engine.params_version == 1
    prompts, budgets = workload(n=3, seed=9)
    want = unified_streams("jax", jp1, prompts, budgets)
    assert unified_streams("torch", tp1, prompts, budgets) == want
    req = {"jax": JRequest, "torch": TRequest}
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        h = (canary, mate)[i % 2]
        h.submit(req["jax" if isinstance(h, JFleetHost) else "torch"](
            rid=100 + i, prompt=p, max_new_tokens=m))
    drive([canary, mate], len(prompts))
    got = {r - 100: t for r, t in streams([canary, mate], 100).items()}
    assert got == want


def test_request_status_and_mailbox_bytes_equal(weights, tmp_path):
    """The request body, a host's status JSON and a mailbox message
    file are the same bytes from either package."""
    prompt = np.arange(7, dtype=np.int32)
    kw = dict(rid=3, prompt=prompt, max_new_tokens=5, temperature=0.5,
              seed=9, eos=2)
    jr, tr = JRequest(**kw), TRequest(**kw)
    jr.enqueue_mono = tr.enqueue_mono = 123.25
    assert t_router.encode_request(tr) == j_router.encode_request(jr)
    back = t_router.decode_request(j_router.encode_request(jr))
    assert (back.rid, back.prompt.tolist(), back.eos) == (
        3, prompt.tolist(), 2)
    # status JSON of two fresh hosts of the same geometry
    statuses = []
    for pkg in ("jax", "torch"):
        t = TLocal()
        h = host(pkg, "u0", "unified", weights, t, {}, ec=PREFIX_EC)
        statuses.append(json.dumps(h.status()).encode())
    assert statuses[0] == statuses[1]
    # mailbox files: the same name past the clock, the same bytes
    files = {}
    for pkg, box in mailboxes(tmp_path / "mb").items():
        box.register(pkg)
        box.send(pkg, "request", b"payload", src="frontdoor")
        box.publish(pkg, {"host": pkg, "free_slots": 2})
        (name,) = os.listdir(tmp_path / "mb" / pkg / "inbox")
        with open(tmp_path / "mb" / pkg / "inbox" / name, "rb") as f:
            msg = f.read()
        with open(tmp_path / "mb" / "status" / f"{pkg}.json", "rb") as f:
            status = f.read().replace(pkg.encode(), b"H")
        files[pkg] = (name.split("_", 1)[1], msg, status)
    assert files["jax"] == files["torch"]


def test_temperature_frame_refused_across_packages(weights):
    """A port prefill host exports a temperature slot: its frame carries
    the port's tag, and the JAX package's decoder refuses it (it cannot
    continue a torch.Generator's stream); the greedy slot's frame
    decodes there."""
    t = TLocal()
    pre = host("torch", "p0", "prefill", weights, t, {"d0": "decode"})
    t.register("d0")
    t.publish("d0", {"host": "d0", "role": "decode", "free_slots": 2})
    p = np.arange(5, dtype=np.int32)
    pre.submit(TRequest(rid=0, prompt=p, max_new_tokens=4))
    pre.submit(TRequest(rid=1, prompt=p, max_new_tokens=4,
                        temperature=0.8, seed=3))
    for _ in range(20):
        pre.tick()
        if pre.migrate_out == 2:
            break
    frames = {m.payload for m in t.recv("d0") if m.kind == "migrate"}
    assert len(frames) == 2
    decoded, refused = [], 0
    for f in frames:
        try:
            decoded.append(j_migrate.deserialize(f).rid)
        except ValueError:
            refused += 1
    assert decoded == [0] and refused == 1
