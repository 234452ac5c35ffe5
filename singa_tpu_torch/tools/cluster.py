"""Cluster launch & admin: the reference's run.sh / node.sh, for the
PyTorch port (the counterpart of ``singa_tpu/tools/cluster.py``: the
same verbs, flags and pid-file discipline).

The reference launches multi-host jobs by ssh-ing ``build/singa
-procsID=$count -hostfile ...`` onto each hostfile line with lock files
for liveness (examples/mnist/run.sh:19-37), and administers the fleet
with node.sh verbs (ps/ls/scp/ssh/exec over the hostfile). This module
is that operator surface for singa_tpu_torch:

    python -m singa_tpu_torch.tools.cluster start -n 2 -hostfile hf \
        -model_conf job.conf [-cluster_conf c.conf] [-workspace ws] \
        [-device cpu]
    python -m singa_tpu_torch.tools.cluster stop -hostfile hf
    python -m singa_tpu_torch.tools.cluster ps|ssh -hostfile hf
    python -m singa_tpu_torch.tools.cluster ls|exec -hostfile hf -arg <path|cmd>
    python -m singa_tpu_torch.tools.cluster scp -hostfile hf -arg <path>

``start`` runs ``python -m singa_tpu_torch.main -procsID=k -hostfile
...`` on hostfile line k: process k joins the torch.distributed group
whose address the hostfile's first line carries
(parallel/launch.py), the collective replacement for the reference's
Router PING/PONG barrier. Local addresses (localhost / 127.x / this
hostname) launch as child processes; anything else goes over ssh with
the reference's non-interactive options. Liveness uses pid files in
<workspace>/procs (the run.sh lock-file discipline: created at spawn,
removed by ``stop``; ``ps`` reports stale ones). ``-device`` is
forwarded to every process (default: each process's GPU).
"""

from __future__ import annotations

import argparse
import os
import re
import shlex
import signal
import socket
import subprocess
import sys

from ..parallel.launch import read_hostfile

SSH_OPTS = [
    "-oStrictHostKeyChecking=no",
    "-oUserKnownHostsFile=/dev/null",
    "-oLogLevel=quiet",
]


def _is_local(host: str) -> bool:
    name = host.split(":", 1)[0]
    return name in ("localhost", "127.0.0.1", socket.gethostname()) or (
        name.startswith("127.")
    )


def _ssh(host: str, cmd: str, background: bool = False):
    argv = ["ssh", *SSH_OPTS, host.split(":", 1)[0], cmd]
    if background:
        return subprocess.Popen(argv)
    return subprocess.run(argv, capture_output=True, text=True)


def _proc_dir(workspace: str) -> str:
    d = os.path.join(workspace, "procs")
    os.makedirs(d, exist_ok=True)
    return d


def start(args) -> int:
    hosts = read_hostfile(args.hostfile)
    n = args.n or len(hosts)
    if n > len(hosts):
        print(
            f"start: asked for {n} procs but hostfile has {len(hosts)} "
            "lines", file=sys.stderr,
        )
        return 2
    pdir = _proc_dir(args.workspace)
    hostfile = os.path.abspath(args.hostfile)
    if n < len(hosts):
        # children must rendezvous as an n-process job: hand them a
        # truncated hostfile, or init_distributed would block forever
        # waiting for ranks that never launch
        hostfile = os.path.join(pdir, "hostfile")
        with open(hostfile, "w") as f:
            f.write("\n".join(hosts[:n]) + "\n")
    # children must import singa_tpu_torch regardless of the operator's cwd:
    # put the package's parent directory on their PYTHONPATH (a pip
    # install wouldn't need this; the in-repo layout does)
    pkg_parent = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = pkg_parent + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [
        sys.executable, "-m", "singa_tpu_torch.main",
        "-model_conf", os.path.abspath(args.model_conf),
        "-hostfile", hostfile,
    ]
    if args.cluster_conf:
        cmd += ["-cluster_conf", os.path.abspath(args.cluster_conf)]
    if args.device:
        cmd += ["-device", args.device]
    launches: list[tuple[int, str, subprocess.Popen]] = []
    for rank in range(n):
        host = hosts[rank]
        rank_cmd = cmd + ["-procsID", str(rank)]
        log = os.path.join(pdir, f"rank{rank}.log")
        pidfile = os.path.join(pdir, f"rank{rank}.pid")
        if _is_local(host):
            with open(log, "w") as lf:
                p = subprocess.Popen(
                    rank_cmd, stdout=lf, stderr=subprocess.STDOUT,
                    cwd=os.getcwd(), env=env,
                )
            with open(pidfile, "w") as pf:
                pf.write(str(p.pid))
            print(f"rank {rank} on {host}: pid {p.pid} (log {log})")
        else:
            # the reference's ssh fan-out (run.sh:19-37); the remote
            # writes its own pid file next to its log. pid files /
            # logs assume the workspace is a SHARED filesystem (NFS) —
            # without one, `stop` falls back to pkill over ssh.
            remote = (
                f"mkdir -p {shlex.quote(pdir)} && "
                f"cd {shlex.quote(os.getcwd())} && "
                f"PYTHONPATH={shlex.quote(pkg_parent)}:$PYTHONPATH "
                f"nohup {shlex.join(rank_cmd)} > {shlex.quote(log)} 2>&1 "
                f"& echo $! > {shlex.quote(pidfile)}"
            )
            launches.append((rank, host, _ssh(host, remote, background=True)))
            print(f"rank {rank} on {host}: launching over ssh (log {log})")
    # the ssh commands background the trainer and exit immediately, so a
    # short wait surfaces unreachable hosts/bad keys instead of leaving
    # the local ranks hanging at the rendezvous with no clue why
    rc = 0
    for rank, host, p in launches:
        try:
            if p.wait(timeout=20) != 0:
                print(
                    f"rank {rank} on {host}: ssh launch FAILED "
                    f"(rc={p.returncode}) — remaining ranks will block at "
                    "the rendezvous until this rank starts",
                    file=sys.stderr,
                )
                rc = 1
        except subprocess.TimeoutExpired:
            print(f"rank {rank} on {host}: ssh still connecting...")
    return rc


def _pids(workspace: str) -> dict[int, tuple[str, int]]:
    pdir = _proc_dir(workspace)
    out = {}
    for f in sorted(os.listdir(pdir)):
        if f.startswith("rank") and f.endswith(".pid"):
            rank = int(f[4:-4])
            with open(os.path.join(pdir, f)) as pf:
                out[rank] = (os.path.join(pdir, f), int(pf.read().strip()))
    return out


def _alive(pid: int) -> bool:
    """True for a RUNNING process. Zombies count as dead: start() holds
    the local children's Popen handles without waiting, so an exited
    child stays a zombie until this process exits — os.kill(pid, 0)
    succeeds on it, and treating that as alive made `stop`/wait loops
    burn their full deadlines on already-finished ranks."""
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, PermissionError):
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            # state = first field after the parenthesized comm (which
            # may itself contain spaces/parens — split on the LAST ')')
            if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                return False
    except (OSError, IndexError):  # no /proc: keep the kill(0) answer
        pass
    return True


def _is_singa_main(pid: int) -> bool:
    """Guard against recycled PIDs in stale pid files: only SIGTERM a
    process whose cmdline is actually a singa_tpu_torch.main run. Where the
    check is impossible (no /proc — e.g. macOS), fall back to trusting
    the pid file rather than refusing to stop live children."""
    if not os.path.isdir("/proc"):
        return True
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return b"singa_tpu_torch" in f.read()
    except OSError:  # pid's /proc entry gone
        return False


def _stop_scope_pattern(args) -> str:
    """pkill -f pattern scoped to THIS job's children, not every
    singa_tpu_torch.main on the host: children carry -model_conf and
    -hostfile as absolute paths on their cmdlines (see start())."""
    tokens = []
    if args.model_conf:
        tokens.append(re.escape(os.path.abspath(args.model_conf)))
    # either the operator's hostfile or the truncated copy start() wrote
    # into the workspace
    tokens.append(re.escape(os.path.abspath(args.hostfile)))
    tokens.append(re.escape(os.path.join(_proc_dir(args.workspace), "hostfile")))
    return f"singa_tpu_torch[.]main.*({'|'.join(tokens)})"


def stop(args) -> int:
    hosts = read_hostfile(args.hostfile)
    pids = _pids(args.workspace)
    for rank, (pidfile, pid) in sorted(pids.items()):
        host = hosts[rank] if rank < len(hosts) else "localhost"
        if _is_local(host):
            if _alive(pid) and _is_singa_main(pid):
                os.kill(pid, signal.SIGTERM)
                print(f"rank {rank}: SIGTERM pid {pid}")
            elif _alive(pid):
                print(
                    f"rank {rank}: pid {pid} is not a singa_tpu_torch.main "
                    "process (recycled pid?) — leaving it alone"
                )
            else:
                print(f"rank {rank}: pid {pid} already gone")
        else:
            _ssh(host, f"kill {pid} 2>/dev/null || true")
            print(f"rank {rank} on {host}: kill {pid} over ssh")
        os.unlink(pidfile)
    # remote ranks whose pid files live on the remote disk (workspace
    # not shared) have no local record — sweep them the run.sh way
    # ("killall -q singa", run.sh:42-45)
    recorded = set(pids)
    pat = _stop_scope_pattern(args)
    for rank, host in enumerate(hosts):
        if rank not in recorded and not _is_local(host):
            # shlex.quote, not manual single quotes: re.escape protects
            # the regex but a workspace/conf path containing a quote
            # would break the remote shell string (and the alternation
            # would silently match nothing)
            _ssh(host, f"pkill -f {shlex.quote(pat)} 2>/dev/null || true")
            print(f"{host}: pkill -f {shlex.quote(pat)} (no local pid record)")
    return 0


def ps(args) -> int:
    hosts = read_hostfile(args.hostfile)
    pids = _pids(args.workspace)
    if pids:
        for rank, (_, pid) in sorted(pids.items()):
            host = hosts[rank] if rank < len(hosts) else "localhost"
            state = "alive" if _is_local(host) and _alive(pid) else (
                "remote" if not _is_local(host) else "DEAD (stale pidfile)"
            )
            print(f"rank {rank} on {host}: pid {pid} {state}")
        return 0
    for host in hosts:  # no workspace records: fleet-wide pgrep
        if _is_local(host):
            r = subprocess.run(
                ["pgrep", "-af", "singa_tpu_torch.main"],
                capture_output=True, text=True,
            )
            print(f"{host}:\n{r.stdout}", end="")
        else:
            r = _ssh(host, "pgrep -af singa_tpu_torch.main || true")
            print(f"{host}:\n{r.stdout}", end="")
    return 0


def fleet_exec(args) -> int:
    """node.sh's generic verb: run a command on every host. Nonzero when
    any host failed, so &&-chained launch scripts fail fast."""
    rc = 0
    for host in read_hostfile(args.hostfile):
        if _is_local(host):
            r = subprocess.run(
                args.arg, shell=True, capture_output=True, text=True
            )
        else:
            r = _ssh(host, args.arg)
        rc = rc or r.returncode
        print(f"--- {host} (rc={r.returncode})\n{r.stdout}{r.stderr}", end="")
    return rc


def fleet_ls(args) -> int:
    args.arg = f"ls -l {shlex.quote(args.arg)}"
    return fleet_exec(args)


def fleet_ssh(args) -> int:
    """Connectivity check (node.sh `ssh` verb)."""
    ok = True
    for host in read_hostfile(args.hostfile):
        if _is_local(host):
            print(f"{host}: local")
            continue
        r = _ssh(host, "exit")
        state = "ok" if r.returncode == 0 else f"FAILED rc={r.returncode}"
        ok = ok and r.returncode == 0
        print(f"{host}: {state}")
    return 0 if ok else 1


def fleet_scp(args) -> int:
    """Push a path to every remote host at the SAME absolute path
    (node.sh `scp` verb) — a relative destination would resolve against
    the remote home while `start` cd's into this cwd."""
    path = os.path.abspath(args.arg)
    rc = 0
    for host in read_hostfile(args.hostfile):
        if _is_local(host):
            print(f"{host}: local, skipping")
            continue
        r = subprocess.run(
            ["scp", *SSH_OPTS, "-r", path,
             f"{host.split(':', 1)[0]}:{path}"],
            capture_output=True, text=True,
        )
        rc = rc or r.returncode
        print(f"{host}: rc={r.returncode} {r.stderr}".rstrip())
    return rc


VERBS = {
    "start": start,
    "stop": stop,
    "ps": ps,
    "ls": fleet_ls,
    "ssh": fleet_ssh,
    "scp": fleet_scp,
    "exec": fleet_exec,
}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="singa_tpu_torch.tools.cluster",
                                 description=__doc__)
    ap.add_argument("verb", choices=sorted(VERBS))
    ap.add_argument("-hostfile", required=True)
    ap.add_argument("-n", type=int, default=0,
                    help="process count (start; default: every host)")
    ap.add_argument("-model_conf", default=None)
    ap.add_argument("-cluster_conf", default=None)
    ap.add_argument("-workspace", default="ws",
                    help="pid files + logs land in <workspace>/procs")
    ap.add_argument("-arg", default="",
                    help="path (ls/scp) or command (exec)")
    ap.add_argument("-device", default=None,
                    help="forwarded to every process (start; default: "
                    "the GPU, 'cpu' must be asked for)")
    args = ap.parse_args(argv)
    if args.verb == "start" and not args.model_conf:
        ap.error("start requires -model_conf")
    return VERBS[args.verb](args)


if __name__ == "__main__":
    sys.exit(main())
