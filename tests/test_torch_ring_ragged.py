"""A ragged bucket of params chunked along different dims, through the
port's ring and the JAX ring on four ranks (helpers and tolerances of
tests/test_torch_ring.py).
"""

import pytest

from test_torch_ring import RAGGED, RAGGED_DIMS, check_against_jax, ring_inputs


@pytest.mark.parametrize("ef,hier", [(True, None), (False, (2, 2))])
def test_ragged_mixed_dim_bucket_matches_jax_ring(ef, hier):
    grads, res = ring_inputs(40 + ef, 4, RAGGED)
    check_against_jax(grads, res, (("f", "e"), ("h", "g")), RAGGED_DIMS, ef,
                      hier, RAGGED)
