"""The port's ``collective_stall`` against the JAX package's tool on the
CPU: the same JSON keys and the same per-mode wire bytes (the JAX tool
counts its ring's bytes in the step's jaxpr, the port at its exchanges:
both must equal the model), and ``measure_comm_ms``. ``attend_stall`` is
in tests/test_torch_tools_attend.py.
"""

import math

import pytest

from singa_tpu.tools import collective_stall as j_coll
from singa_tpu_torch.tools import collective_stall as t_coll
from test_torch_launch import one_torch_thread  # noqa: F401
from test_torch_tools_stall import both


@pytest.fixture
def jaxpr_names(monkeypatch):
    """The JAX tool counts its ring's bytes in the step's jaxpr through
    ``jax.core.ClosedJaxpr``/``Jaxpr``, which this JAX release moved to
    ``jax.extend.core``: name them where the tool looks, in this test
    only."""
    import jax.core
    import jax.extend.core as ext

    for name in ("ClosedJaxpr", "Jaxpr"):
        monkeypatch.setattr(jax.core, name, getattr(ext, name),
                            raising=False)


@pytest.mark.parametrize("argv", [
    [],
    ["--ndata", "4", "--head", "12"],
], ids=["ndata2", "ndata4_hier"])
def test_collective_stall_wire_bytes_match_jax(argv, capsys, jaxpr_names):
    argv = ["--steps", "2", "--warmup", "1", "--trials", "1",
            "--batch", "64", "--hidden", "32", "--records", "256"] + argv
    j, t = both(j_coll, t_coll, argv, capsys)
    for k in ("wire_bytes", "hier_wire_bytes", "wire_bytes_ratio",
              "wire_model_matches_jaxpr", "hier_model_matches_jaxpr",
              "hier_intra_degree", "ndata", "buckets", "dtype"):
        assert t[k] == j[k], k
    assert t["wire_model_matches_jaxpr"] and t["hier_model_matches_jaxpr"]
    assert list(t["comm_ms"]) == list(j["comm_ms"])


def test_measure_comm_ms_positive(tmp_path):
    from singa_tpu_torch.data.loader import synthetic_arrays, write_records

    shard = str(tmp_path / "shard")
    write_records(shard, *synthetic_arrays(128, seed=0))
    for mode in ("q8_overlap", "q8_ring"):
        tr, _, _ = t_coll._make_runner(shard, 64, 32, 1, mode, "int8", 4, 2,
                                       False, device="cpu")
        ms = t_coll.measure_comm_ms(tr, i1=1, i2=4, trials=2)
        assert math.isfinite(ms) and ms > 0, mode
