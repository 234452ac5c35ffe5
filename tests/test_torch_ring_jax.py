"""The port's quantized ring on four ranks against the JAX ring under
shard_map (the flat ring and q8_hier, one and two buckets, with and
without error feedback), with the helpers and tolerances of
tests/test_torch_ring.py, which holds the two-rank cases.
"""

import pytest

from test_torch_ring import RING_CASES, SHAPES, check_against_jax, ring_inputs


@pytest.mark.parametrize("n,nb,ef,dim1,hier",
                         [c for c in RING_CASES if c[0] == 4])
def test_ring_reduce_matches_jax_ring(n, nb, ef, dim1, hier):
    grads, res = ring_inputs(n * 10 + nb, n)
    cdims = {k: 0 for k in SHAPES}
    if dim1:
        cdims["a"] = 1
    buckets = (tuple(SHAPES),) if nb == 1 else (("a",), ("b", "c"))
    check_against_jax(grads, res, buckets, cdims, ef, hier)
