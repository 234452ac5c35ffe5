"""The port's ``attend_stall`` against the JAX package's tool on the CPU:
the same JSON keys, the same attention-bytes model of the fused kernel
(the reference side an explicit count of the plain attend's bytes), and
the same greedy streams on the same weights at the JAX tool's default
geometry.
"""

import argparse

import jax
import numpy as np
import pytest

from singa_tpu.models.transformer import init_lm as j_init_lm
from singa_tpu.tools import attend_stall as j_attend
from singa_tpu_torch.models.transformer import load_jax_params
from singa_tpu_torch.tools import attend_stall as t_attend
from test_torch_launch import one_torch_thread  # noqa: F401
from test_torch_tools_stall import both


@pytest.fixture(scope="module")
def lm():
    """The JAX tool's default geometry and weights, for both packages."""
    args = t_attend.build_argparser().parse_args(["--device", "cpu"])
    cfg_t = t_attend.model_config(args)
    from singa_tpu.models.transformer import TransformerConfig

    cfg_j = TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, max_len=args.max_len)
    pj = j_init_lm(jax.random.PRNGKey(args.seed), cfg_j)
    pt = load_jax_params({k: np.asarray(v) for k, v in pj.items()}, "cpu")
    return args, cfg_j, pj, cfg_t, pt


def test_attend_stall_streams_equal_jax(lm):
    """Greedy streams of the full serving workload: the port's fused and
    reference engines and the JAX tool's reference engine agree token
    for token on the same weights."""
    args, cfg_j, pj, cfg_t, pt = lm
    want = j_attend._streams(pj, cfg_j, args, "reference")
    for impl in ("reference", "fused"):
        got = t_attend.streams(pt, cfg_t, args, impl, "cpu")
        assert got == {rid: list(map(int, toks))
                       for rid, toks in want.items()}, impl


def test_attend_stall_bytes_match_jax(lm):
    args, cfg_j, pj, cfg_t, pt = lm
    jargs = argparse.Namespace(**vars(args))
    want = j_attend.measure_attend_bytes(pj, cfg_j, jargs)
    got = t_attend.measure_attend_bytes(pt, cfg_t, args, "cpu")
    assert list(got) == list(want)
    for k in ("fused_bytes", "live_blocks", "cache_fill"):
        assert got[k] == want[k], k
    assert got["fused_xla_bytes"] is None
    # the plain path's count: the live blocks read, two dense views
    # written and read back, Q and O
    s, h, d, bl = 8, 2, 128, 16
    mb = args.max_len // bl
    view = 2 * s * h * mb * bl * d
    assert got["ref_bytes"] == 4 * (2 * got["live_blocks"] * h * bl * d
                                    + 2 * view + 2 * s * h * d)
    assert got["bytes_ratio"] >= args.bytes_threshold


def test_attend_stall_json_keys_match_jax(capsys):
    argv = ["--trials", "1", "--ticks", "2", "--requests", "3",
            "--max_new", "6"]
    j, t = both(j_attend, t_attend, argv + ["--no_gate"], capsys)
    assert t["token_mismatches"] == 0
    for k in ("fused_bytes", "live_blocks", "cache_fill", "ticks"):
        assert t[k] == j[k], k
