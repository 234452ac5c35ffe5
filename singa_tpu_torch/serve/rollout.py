"""Live weight rollout: versioned hot-swap into a RUNNING fleet with
canary, parity-gated promotion, and automatic rollback; the PyTorch
counterpart of ``singa_tpu/serve/rollout.py``, the same control frames
and weight frames (a JAX controller rolls a port host and the other way
round).

The reference cluster could only change weights by restarting every
process; a serving fleet cannot afford that — streams are in flight.
This controller ships a next-version param tree into hosts that keep
serving the CURRENT version the whole time:

  stage     one ``weight_ship`` bulk frame per host (fleet/migrate.py
            weights codec: CRC-guarded npz). The host stages the tree
            ALONGSIDE its live params (engine.stage_params: dual-
            resident, 2x param memory); serving is untouched. The
            flip copies the staged bytes into the live tensors, so the
            captured decode and prefill graphs serve the new weights.
            A torn frame is rejected by the CRC and nacked — the
            controller retries, then QUARANTINES the version. The
            live weights never stop answering.
  canary    ONE host (``rollout { canary }``; default the first
            decode-capable peer) flips first. The flip is applied in
            the host's message handler, BETWEEN scheduler ticks — the
            atomic tick boundary: no stream decodes under two versions
            within a tick. Flipping purges the prefix cache (cached KV
            is a function of the weights that wrote it) and pins the
            previous version for rollback.
  parity    the controller replays deterministic probe traffic through
            the canary's REAL serving path and compares the finished
            streams against a reference engine running the SAME staged
            weights. Any mismatch -> automatic fleet-wide ROLLBACK to
            the pinned current version and a loud ``rollout_abort``
            event. Zero streams drop or hang either way.
  promote   parity passed: the remaining hosts roll one by one (stage,
            flip — prefill hosts included). The fleet is legitimately
            MIXED-VERSION during this window; version tags on every
            migrate / cache_fetch / cache_ship frame make skew safe —
            a cross-version frame degrades to cold prefill, it never
            poisons a pool (fleet/host.py skew guards).

Every run terminates in one documented verdict:

  promoted     all hosts on the new version
  rollback     canary parity mismatch; every flipped host restored
  quarantined  a host's weight_ship tore ``ship_retries + 1`` times;
               the version is abandoned, flipped hosts rolled back,
               serving uninterrupted on current
  paused       a host died mid-stage (stage-ack timeout — the
               swap_die@K drill): the rollout stops where it is.
               Already-flipped hosts STAY flipped — the skew guards
               are exactly what makes the frozen mixed fleet safe —
               and the dead host's streams fail over on the existing
               tombstone path.

``run_rollout_from_conf`` drives all of it from the ``fleet {
rollout {} }`` conf block against a fleet of OS processes (the CI
drill); the class API drives in-process drills (tests/test_rollout.py)
and serve_bench's ``--rollout`` gate.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..comm.wire import WireError
from .engine import Engine
from .fleet import migrate
from .fleet.host import PROBE_RID_BASE
from .fleet.router import DECODE_CAPABLE
from .scheduler import Request, Scheduler

#: deterministic probe-prompt seed — reserved so a drill's probes are
#: reproducible across runs and processes
PROBE_SEED = 0x5EED


def probe_prompts(cfg, n: int, probe_tokens: int) -> list[np.ndarray]:
    """``n`` deterministic probe prompts that fit the serving window
    with ``probe_tokens`` of decode budget to spare."""
    length = max(1, min(6, cfg.max_len - probe_tokens - 1))
    rng = np.random.default_rng(PROBE_SEED)
    return [
        rng.integers(1, cfg.vocab, size=length).astype(np.int32)
        for _ in range(n)
    ]


class RolloutController:
    """One rollout attempt of one version over one fleet.

    ``tick`` is the pump the controller calls while awaiting acks:
    in-process drills pass a callable that ticks every live host (the
    controller and fleet share a thread); OS-process fleets pass None
    and the default sleep lets the peers' serve loops run.
    """

    def __init__(self, transport, peers: dict[str, str], *, params,
                 version: int, cfg, serving, canary: str = "",
                 probes: int = 4, probe_tokens: int = 8,
                 stage_timeout_s: float = 30.0, ship_retries: int = 2,
                 name: str = "rollout", recorder=None,
                 force_parity_fail: bool = False, tick=None,
                 device=None, log=lambda s: None):
        if not peers:
            raise ValueError("rollout needs at least one fleet host")
        self.transport = transport
        self.peers = dict(peers)
        self.params = params
        self.version = int(version)
        self.cfg = cfg
        self.serving = serving
        self.canary = canary or next(
            (n for n, r in self.peers.items() if r in DECODE_CAPABLE),
            next(iter(self.peers)),
        )
        if self.canary not in self.peers:
            raise ValueError(
                f"rollout canary {self.canary!r} is not a fleet host "
                f"(peers: {sorted(self.peers)})"
            )
        self.n_probes = max(1, int(probes))
        self.probe_tokens = max(1, int(probe_tokens))
        self.stage_timeout_s = float(stage_timeout_s)
        self.ship_retries = max(0, int(ship_retries))
        self.name = name
        self.recorder = recorder
        #: test hook: perturb ONE expected probe token so the parity
        #: gate trips and the automatic-rollback path runs end to end
        self.force_parity_fail = force_parity_fail
        #: the reference engine's device (None = cuda)
        self.device = device
        self._tick = tick if tick is not None else (
            lambda: time.sleep(0.005)
        )
        self.log = log
        #: hosts currently serving the new version (rollback set)
        self.flipped: list[str] = []
        self.rollbacks = 0
        self.torn_ships = 0
        self._inbox: list[dict] = []
        transport.register(name)

    # -- plumbing -------------------------------------------------------

    def _event(self, kind: str, **payload) -> None:
        if self.recorder is not None:
            self.recorder.event(kind, **payload)

    def _send(self, host: str, kind: str, payload: bytes) -> bool:
        try:
            self.transport.send(host, kind, payload, src=self.name)
            return True
        except WireError as e:
            self.log(f"rollout: send to {host!r} failed: {e}")
            return False

    def _await(self, cmd: str, host: str, timeout_s: float | None = None
               ) -> dict | None:
        """Pump the fleet until ``host`` acks ``cmd`` (or the deadline
        passes -> None). Unrelated frames buffer for later awaits."""
        deadline = time.monotonic() + (
            self.stage_timeout_s if timeout_s is None else timeout_s
        )
        while True:
            for i, body in enumerate(self._inbox):
                if body.get("cmd") == cmd and body.get("host") == host:
                    return self._inbox.pop(i)
            for msg in self.transport.recv(self.name):
                if msg.kind != "rollout":
                    continue
                try:
                    self._inbox.append(
                        json.loads(msg.payload.decode("utf-8"))
                    )
                except ValueError:
                    continue
            for i, body in enumerate(self._inbox):
                if body.get("cmd") == cmd and body.get("host") == host:
                    return self._inbox.pop(i)
            if time.monotonic() >= deadline:
                return None
            self._tick()

    # -- the reference streams ------------------------------------------

    def _probe_plan(self) -> list[tuple[int, np.ndarray, int]]:
        prompts = probe_prompts(self.cfg, self.n_probes,
                                self.probe_tokens)
        return [
            (PROBE_RID_BASE - i, p, PROBE_SEED + i)
            for i, p in enumerate(prompts)
        ]

    def _expected_streams(self) -> dict[int, list[int]]:
        """What the staged weights SHOULD say: the controller runs the
        identical probes through its own reference engine on the new
        params. Greedy decode, same geometry, same seeds — the canary's
        post-flip streams must match bitwise."""
        params = {
            k: v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.array(v))
            for k, v in self.params.items()
        }
        eng = Engine(params, self.cfg, self.serving, device=self.device)
        sched = Scheduler(eng)
        for rid, prompt, seed in self._probe_plan():
            sched.submit(Request(
                rid=rid, prompt=prompt,
                max_new_tokens=self.probe_tokens, temperature=0.0,
                seed=seed,
            ))
        while sched.busy:
            sched.tick()
        out = {
            req.rid: [int(t) for t in req.tokens]
            for req in sched.finished
        }
        if self.force_parity_fail and out:
            rid = min(out)
            out[rid] = list(out[rid])
            out[rid][0] = (out[rid][0] + 1) % self.cfg.vocab
        return out

    # -- the lifecycle --------------------------------------------------

    def _stage(self, host: str) -> str:
        """Ship + stage onto one host. -> "staged" | "torn" | "paused"."""
        frame = migrate.serialize_weights(self.version, self.params)
        for attempt in range(1 + self.ship_retries):
            self._event(
                "weight_ship", dir="out", host=host,
                version=self.version, bytes=len(frame),
                attempt=attempt + 1,
            )
            if not self._send(host, "weight_ship", frame):
                return "paused"
            ack = self._await("stage_ack", host)
            if ack is None:
                # no ack inside the window: the host died mid-stage
                # (the swap_die drill) or the wire is gone — either
                # way the rollout PAUSES; the fleet keeps serving
                return "paused"
            if ack.get("ok"):
                return "staged"
            self.torn_ships += 1
            self.log(f"rollout: {host!r} rejected weight_ship "
                     f"v{self.version} (attempt {attempt + 1}/"
                     f"{1 + self.ship_retries}): "
                     f"{ack.get('error', '?')}")
        return "torn"

    def _flip(self, host: str) -> bool:
        if not self._send(
            host, "rollout",
            json.dumps({"cmd": "flip"}).encode("utf-8"),
        ):
            return False
        ack = self._await("flip_ack", host)
        if ack is None or not ack.get("ok"):
            return False
        self.flipped.append(host)
        return True

    def _rollback_all(self) -> None:
        """Restore every flipped host to the pinned current version."""
        for host in list(self.flipped):
            if self._send(
                host, "rollout",
                json.dumps({"cmd": "rollback"}).encode("utf-8"),
            ):
                self._await("rollback_ack", host)
            self.rollbacks += 1
        self.flipped = []

    def _probe_canary(self) -> tuple[bool, str]:
        """Replay probe traffic through the canary's real serving path
        and compare against the reference. -> (parity_ok, detail)."""
        plan = self._probe_plan()
        body = {
            "cmd": "probe",
            "prompts": [[int(t) for t in p] for _, p, _ in plan],
            "max_new": self.probe_tokens,
            "temperature": 0.0,
            "seeds": [s for _, _, s in plan],
        }
        if not self._send(
            self.canary, "rollout", json.dumps(body).encode("utf-8"),
        ):
            return False, "canary unreachable"
        done = self._await(
            "probe_done", self.canary,
            timeout_s=max(self.stage_timeout_s, 60.0),
        )
        if done is None or not done.get("ok"):
            return False, "probe_failed" if done else "probe_timeout"
        got = {
            int(r): [int(t) for t in toks]
            for r, toks in (done.get("streams") or {}).items()
        }
        expected = self._expected_streams()
        for rid, want in expected.items():
            if got.get(rid) != want:
                return False, (
                    f"stream {rid}: got {got.get(rid)} want {want}"
                )
        return True, f"{len(expected)} probe streams bitwise-identical"

    def run(self) -> dict:
        """The whole lifecycle. -> {"verdict", "version", "canary",
        "flipped", "rollbacks", "torn_ships", "detail"}."""
        order = [self.canary] + [
            n for n in self.peers if n != self.canary
        ]
        self.log(f"rollout v{self.version}: canary {self.canary!r}, "
                 f"order {order}")
        detail = ""
        verdict = "promoted"
        for k, host in enumerate(order):
            staged = self._stage(host)
            if staged == "paused":
                detail = f"no stage_ack from {host!r}"
                self._event(
                    "rollout_abort", reason="paused", host=host,
                    version=self.version, flipped=len(self.flipped),
                )
                verdict = "paused"
                break
            if staged == "torn":
                # retries exhausted: quarantine the version — flipped
                # hosts roll back, the fleet serves current throughout
                detail = (f"weight_ship to {host!r} torn "
                          f"{1 + self.ship_retries}x")
                self._rollback_all()
                self._event(
                    "rollout_abort", reason="torn", host=host,
                    version=self.version, rollbacks=self.rollbacks,
                )
                verdict = "quarantined"
                break
            if not self._flip(host):
                detail = f"no flip_ack from {host!r}"
                self._event(
                    "rollout_abort", reason="paused", host=host,
                    version=self.version, flipped=len(self.flipped),
                )
                verdict = "paused"
                break
            if k == 0:
                ok, detail = self._probe_canary()
                self._event(
                    "rollout_canary", host=host, version=self.version,
                    parity=ok, probes=self.n_probes,
                )
                if not ok:
                    self.log(f"rollout v{self.version}: CANARY PARITY "
                             f"MISMATCH on {host!r} — rolling back: "
                             f"{detail}")
                    self._rollback_all()
                    self._event(
                        "rollout_abort", reason="parity", host=host,
                        version=self.version, rollbacks=self.rollbacks,
                        detail=detail[:200],
                    )
                    verdict = "rollback"
                    break
                self.log(f"rollout v{self.version}: canary parity OK "
                         f"({detail})")
        result = {
            "verdict": verdict,
            "version": self.version,
            "canary": self.canary,
            "flipped": list(self.flipped),
            "rollbacks": self.rollbacks,
            "torn_ships": self.torn_ships,
            "detail": detail,
        }
        self._event(
            "rollout_done", verdict=verdict, version=self.version,
            canary=self.canary, flipped=len(self.flipped),
            rollbacks=self.rollbacks, torn_ships=self.torn_ships,
        )
        self.log(f"rollout v{self.version}: verdict {verdict}"
                 + (f" ({detail})" if detail else ""))
        return result


def run_rollout_from_conf(model_cfg, cluster_cfg, *,
                          force_parity_fail: bool = False,
                          device=None, log=print) -> dict:
    """Drive one rollout against a RUNNING conf-launched fleet (the CI
    drill's controller process): load the next-version weights named
    by ``fleet { rollout { checkpoint } }`` through the reshard-on-load
    path, then canary / parity / promote over the conf's transport.
    The reference engine for the parity probes runs on ``device``
    (None = cuda)."""
    from ..config.schema import RolloutConfig
    from ..models.transformer import init_lm
    from ..obs.recorder import FlightRecorder
    from ..resilience.reshard import load_serving_params
    from .engine import EngineConfig
    from .fleet.host import (
        _build_transport,
        fleet_topology,
        lm_config_from_conf,
    )

    fleet = model_cfg.fleet
    ro = fleet.rollout if fleet.rollout is not None else RolloutConfig()
    if not ro.checkpoint:
        raise ValueError(
            "fleet rollout needs a checkpoint (the next-version "
            "weights); netlint ROL001 flags this statically"
        )
    cfg = lm_config_from_conf(model_cfg)
    params = init_lm(torch.Generator().manual_seed(0), cfg, device)
    params, info = load_serving_params(ro.checkpoint, params)
    version = int(ro.version) or int(info["step"]) + 1 or 1
    serving = EngineConfig.from_conf(
        model_cfg.serving, getattr(model_cfg, "kernels", None)
    )
    n_hosts = len(fleet.peers) or (
        cluster_cfg.nworkers if cluster_cfg is not None
        and cluster_cfg.nworkers else 1
    )
    topo = fleet_topology(fleet, n_hosts)
    workspace = (
        cluster_cfg.workspace if cluster_cfg is not None else "."
    )
    root = fleet.mailbox or f"{workspace}/fleet"
    recorder = FlightRecorder(
        f"{workspace}/events", rank=len(topo), run_id="fleet",
    )
    transport = _build_transport(fleet, root, recorder, None, log=log)
    ctl = RolloutController(
        transport, dict(topo),
        params=params, version=version, cfg=cfg, serving=serving,
        canary=ro.canary, probes=ro.parity_probes,
        probe_tokens=ro.probe_tokens,
        stage_timeout_s=ro.stage_timeout_s,
        ship_retries=ro.ship_retries, recorder=recorder,
        force_parity_fail=force_parity_fail, device=device, log=log,
    )
    log(f"rollout v{version}: weights from {info['path']!r} "
        f"(step {info['step']}, {info['format']}) over "
        f"{len(topo)}-host fleet at {root}")
    try:
        return ctl.run()
    finally:
        close = getattr(transport, "close", None)
        if close is not None:
            close()
        recorder.close()
