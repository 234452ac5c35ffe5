"""The paged-attention kernel's split key range in its prefill and
overlay (verify) forms, on the CPU emulation of the kernel source
(tests/cuda_emu.h), held to the plain versions at the card's bar; the
emulated kernel and the helpers are tests/test_torch_paged_split.py's.
"""

import numpy as np
import pytest

from test_torch_paged_split import check, kernel, make_case  # noqa: F401


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("nq", [2, 9])
def test_prefill_splits_match_plain(kernel, splits, nq):
    """A prefill chunk deep into one sequence: Q = 2 (two rows a block,
    two warps to a row) and Q = 9 (four rows a block, a ragged last row
    tile)."""
    case = make_case(splits * nq, s=1, nq=nq, bl=8, d=64, max_len=128,
                     pos0=[100])
    check(kernel, case, splits)


@pytest.mark.parametrize("splits", [1, 2, 6])
@pytest.mark.parametrize("nq,bl", [(5, 16), (2, 8)])
def test_overlay_splits_match_plain(kernel, splits, nq, bl):
    """The verify form: ragged pool lengths (one at 0), ragged draft
    validity, the fresh chunk folded once by the last split, and a dead
    row (no pool entry and no valid column) that emits exact zeros."""
    valid = (np.arange(nq)[None, :] <= np.array([[0], [nq], [1], [9]])
             ).astype(np.int32)
    valid[2] = 0
    case = make_case(splits + nq, s=4, nq=nq, bl=bl, d=64, max_len=96,
                     pos0=[0, 41, 0, 90], valid=valid)
    got = check(kernel, case, splits)
    assert not got[2].any()
