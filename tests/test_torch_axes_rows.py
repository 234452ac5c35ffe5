"""A seq lane's own rows of the global attention (PyTorch port).

Out of ring mode each lane of a seq group computes only its own query
block's rows of the global causal attention the JAX program computes
over a seq-sharded input (``ops.attention.attention_rows``, dense or on
the flash route), held here to the whole attention's rows and their
gradients on the CPU. Also: the GPipe schedule's one tick loop against
the stages run in sequence, and ``Lanes.exchange`` refusing an axis set
no exchange runs over.
"""

from __future__ import annotations

import pytest
import torch

from singa_tpu_torch.ops.attention import attention, attention_rows
from singa_tpu_torch.parallel.axes import Lanes
from singa_tpu_torch.parallel.mesh import build_full_mesh
from singa_tpu_torch.parallel.pipeline import gpipe

TOL = 1e-5


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("nseq", [2, 4])
def test_attention_rows_are_the_global_attentions_rows(flash, nseq):
    gen = torch.Generator().manual_seed(0)
    b, h, s, d = 2, 2, 256, 32
    q, k, v = (torch.randn(b, h, s, d, generator=gen, requires_grad=True)
               for _ in range(3))
    whole = attention(q, k, v, causal=True)
    size = s // nseq
    rows = torch.cat([attention_rows(q[:, :, i * size:(i + 1) * size], k, v,
                                     i * size, flash=flash)
                      for i in range(nseq)], 2)
    assert (rows - whole).abs().max() <= TOL
    g = torch.randn(whole.shape, generator=gen)
    want = torch.autograd.grad(whole, (q, k, v), g)
    got = torch.autograd.grad(rows, (q, k, v), g)
    for a, b_ in zip(want, got):
        assert (a - b_).abs().max() <= TOL


def test_gpipe_runs_every_microbatch_through_every_stage():
    fns = [lambda a, s=s: a * 2 + s for s in range(3)]
    mbs = [torch.tensor(float(i)) for i in range(4)]
    want = []
    for m in mbs:
        for f in fns:
            m = f(m)
        want.append(m)
    assert [float(o) for o in gpipe(fns, mbs)] == [float(w) for w in want]


def test_exchange_refuses_an_axis_set_no_exchange_runs_over():
    mesh = build_full_mesh({"data": 2, "seq": 2}, devices=["cpu"] * 4)
    lanes = Lanes(mesh, tuple(range(4)))
    with pytest.raises(ValueError, match="EXCHANGE_AXES"):
        lanes.exchange([0, 1], [torch.zeros(2), torch.zeros(2)],
                       axes=("seq", "model"))
