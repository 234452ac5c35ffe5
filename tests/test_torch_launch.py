"""The port's multi-process bootstrap (singa_tpu_torch/parallel/launch.py)
and the coordination it carries (resilience/coord.py): the hostfile
against the JAX package's reader, the no-op cases and the range error of
``init_distributed``, and two OS processes over gloo on the CPU, each
started here with its own ``-procsID``-style rank: process count and
index, the preemption barrier's OR, and a peer that never joins.

It also holds the launcher the other multi-process files use
(``run_processes``): a free port from binding port 0, a hostfile whose
line 0 hosts the rendezvous, child output to files (a chatty child
blocking on a full pipe would stall its peer at the next collective),
one timeout a wait, the peers killed in a ``finally``, and one retry
with a fresh port when the rendezvous port was taken in between.
"""

import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from singa_tpu.parallel import launch as j_launch
from singa_tpu_torch.parallel import launch as t_launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: each child on one intra-op thread: the suite's workers share the cores
CHILD_ENV = {"OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
WAIT_S = 120


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test, as tests/test_torch_zero.py's files
    run (their tensors are small; the suite's workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_hostfile(path, n: int) -> str:
    """n lines on this host, line 0 with a free port for the rendezvous."""
    with open(path, "w") as f:
        f.write(f"127.0.0.1:{free_port()}  # rank 0 hosts the rendezvous\n"
                + "127.0.0.1\n" * (n - 1))
    return str(path)


def run_processes(tmp_path, argv, n: int = 2, *, name: str = "proc",
                  timeout: float = WAIT_S) -> list[tuple[int, str]]:
    """Start ``n`` processes, ``argv(k, hostfile)`` the command of
    process k, and wait for all -> [(exit code, its output)]. A job
    whose rendezvous port was taken before process 0 bound it is run
    once more on a fresh port."""
    for attempt in range(2):
        hostfile = write_hostfile(tmp_path / f"{name}_hostfile", n)
        env = {**os.environ, **CHILD_ENV}
        procs, logs = [], []
        try:
            for k in range(n):
                log = open(tmp_path / f"{name}{k}.log", "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    argv(k, hostfile), cwd=REPO, env=env, stdout=log,
                    stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()  # never orphan a peer blocked in a collective
                    p.wait()
            out = []
            for p, log in zip(procs, logs):
                log.seek(0)
                out.append((p.returncode, log.read()))
                log.close()
        taken = any("address already in use" in text.lower()
                    for _, text in out)
        if not (taken and attempt == 0):
            return out
    return out


def child(script: str, *args) -> list[str]:
    """A Python child running ``script`` with ``args`` as its argv."""
    return [sys.executable, "-c", script, *map(str, args)]


# ---------------------------------------------------------------------------
# the hostfile and the no-op cases, against the JAX package
# ---------------------------------------------------------------------------


HOSTFILES = {
    "plain": "10.0.0.1\n10.0.0.2\n",
    "comments_and_blanks": ("# the job's hosts\n\n10.0.0.1:7000  # head\n"
                            "   \n10.0.0.2 # worker\n#10.0.0.3\n"),
    "port_on_a_later_line": "hostA\nhostB:8123\n",
    "empty": "# nothing\n\n",
}


@pytest.mark.parametrize("name", sorted(HOSTFILES))
def test_hostfile_and_coordinator_match_jax(tmp_path, name):
    path = tmp_path / "hf"
    path.write_text(HOSTFILES[name])
    hosts = t_launch.read_hostfile(str(path))
    assert hosts == j_launch.read_hostfile(str(path))
    if not hosts:
        for fn in (t_launch.coordinator_address,
                   j_launch.coordinator_address):
            with pytest.raises(ValueError, match="empty hostfile"):
                fn(hosts)
        return
    for port in (t_launch.DEFAULT_PORT, 1234):
        assert (t_launch.coordinator_address(hosts, port)
                == j_launch.coordinator_address(hosts, port))
    assert t_launch.DEFAULT_PORT == j_launch.DEFAULT_PORT


def test_init_distributed_no_ops_and_range_error(tmp_path, monkeypatch):
    """No hostfile and no torchrun environment, a world of 1 in that
    environment, or a one-line hostfile: no process group, False. A
    procs_id outside the hostfile raises the JAX package's ValueError."""
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert t_launch.init_distributed(0, None, device="cpu") is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert t_launch.init_distributed(None, None, device="cpu") is False
    one = tmp_path / "one"
    one.write_text("127.0.0.1:1\n")
    assert t_launch.init_distributed(0, str(one), device="cpu") is False
    two = tmp_path / "two"
    two.write_text("127.0.0.1:1\n127.0.0.1\n")
    for bad in (2, -1, None):
        with pytest.raises(ValueError) as want:
            j_launch.init_distributed(bad, str(two))
        with pytest.raises(ValueError) as got:
            t_launch.init_distributed(bad, str(two), device="cpu")
        assert str(got.value) == str(want.value)
    assert not torch.distributed.is_initialized()
    assert t_launch.choose_backend(["a", "a"], 1, "cpu") == (
        "gloo", torch.device("cpu"))


# ---------------------------------------------------------------------------
# two processes over gloo
# ---------------------------------------------------------------------------


COORD = """
import os, sys
from singa_tpu_torch.parallel import launch
from singa_tpu_torch.resilience import coord
k, hostfile, env = int(sys.argv[1]), sys.argv[2], sys.argv[3] == "env"
assert coord.process_count() == 1 and coord.process_index() == 0
assert coord.preemption_barrier(True) is True
if env:
    # the torchrun form: the rendezvous from the environment
    addr, port = launch.read_hostfile(hostfile)[0].split(":")
    os.environ.update(MASTER_ADDR=addr, MASTER_PORT=port, WORLD_SIZE="2",
                      RANK=str(k))
    assert launch.init_distributed(device="cpu", timeout=60)
else:
    assert launch.init_distributed(k, hostfile, device="cpu", timeout=60)
print("count", coord.process_count(), "index", coord.process_index(),
      "backend", launch.backend())
print("or", coord.preemption_barrier(k == 1),
      "none", coord.preemption_barrier(False), flush=True)
from singa_tpu_torch.config import ConfigError
from singa_tpu_torch.parallel import build_mesh
mesh = build_mesh(4, 1, ["cpu"] * 4)
print("mesh", mesh.width, list(mesh.local_ranks), len(mesh.devices))
try:
    build_mesh(3, 1, ["cpu"] * 3)
except ConfigError as e:
    print("refused", e, flush=True)
launch.shutdown()
"""


@pytest.mark.parametrize("form", ["hostfile", "env"])
def test_two_processes_count_index_and_the_preemption_barrier(tmp_path,
                                                              form):
    """Each process sees a world of 2 and its own index over gloo; the
    barrier ORs one True and one False to True on both, and False with
    none set. A mesh of 4 ranks gives each process 2, process-major; a
    width the process count does not divide is refused, naming both.
    The group starts from the hostfile and ``-procsID``-style ranks, or
    from torchrun's environment (MASTER_ADDR, WORLD_SIZE, RANK)."""
    out = run_processes(tmp_path, lambda k, hf: child(COORD, k, hf, form))
    for k, (rc, text) in enumerate(out):
        assert rc == 0, text
        assert f"count 2 index {k} backend gloo" in text, text
        assert "or True none False" in text, text
        assert f"process {k} of 2: backend gloo, device cpu" in text
        assert f"mesh 4 {[2 * k, 2 * k + 1]} 2" in text, text
        assert ("refused data axis width 3 is not divisible by the "
                "process count 2") in text, text


NEVER_JOINED = """
import sys, time
from singa_tpu_torch.parallel import launch
t0 = time.monotonic()
try:
    launch.init_distributed(0, sys.argv[1], device="cpu", timeout=3)
except launch.RendezvousError as e:
    print("named", type(e).__name__, round(time.monotonic() - t0, 1), e)
"""


def test_a_peer_that_never_joins_fails_the_rendezvous_in_its_timeout(
        tmp_path):
    """Process 0 of a 2-line hostfile alone: the rendezvous raises
    RendezvousError after its 3 s timeout, naming the process and the
    address, and the process exits; it does not hang."""
    hostfile = write_hostfile(tmp_path / "hf", 2)
    t0 = time.monotonic()
    got = subprocess.run(child(NEVER_JOINED, hostfile), cwd=REPO,
                         env={**os.environ, **CHILD_ENV},
                         capture_output=True, text=True, timeout=60)
    elapsed = time.monotonic() - t0
    assert got.returncode == 0, got.stderr
    assert "named RendezvousError" in got.stdout, got.stdout + got.stderr
    assert "process 0 of 2" in got.stdout and "within 3 s" in got.stdout
    waited = float(got.stdout.split()[2])
    assert 2.5 <= waited <= 20 and elapsed < 40, (waited, elapsed)
