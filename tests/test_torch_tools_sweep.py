"""The port's ``sweep`` on the CPU: two points, each in a child process
on an ``nworkers``-rank data mesh, with the JAX tool's row keys and its
deterministic fields.
"""

from singa_tpu.tools import sweep as j_sweep
from singa_tpu_torch.tools import sweep as t_sweep
from test_torch_launch import one_torch_thread  # noqa: F401
from test_torch_tools_procs import JOB, children, shard  # noqa: F401


def test_sweep_two_points_jax_row_keys(shard, tmp_path, children):
    conf = tmp_path / "job.conf"
    conf.write_text(JOB.format(steps=6, ckpt=0, shard=shard))
    got = t_sweep.run_sweep(str(conf), [1, 2], steps=6, virtual=True,
                            device="cpu")
    want = j_sweep.run_sweep(str(conf), [1, 2], steps=6, virtual=True)
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [r["nworkers"] for r in got] == [1, 2]
    assert got[0]["efficiency"] == 1.0
    assert all(r["samples_per_sec"] > 0 for r in got)
    for g, w in zip(got, want):
        for k in ("batch", "feeder", "update_mode", "comm_mode",
                  "comm_dtype", "opt_state_bytes_per_device"):
            assert g[k] == w[k], k
