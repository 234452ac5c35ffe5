"""Pipeline parallelism: the GPipe schedule over the mesh's pipe axis.

Counterpart of ``singa_tpu/parallel/pipeline.py``. Stage s runs on the
pipe ranks of index s; a step is ``nmicro + nstages - 1`` ticks, and at
tick t stage s works on microbatch t - s, stage 0 taking it from the
input and every other stage taking what stage s - 1 produced at tick
t - 1 (the hop). The last stage's outputs, in microbatch order, are the
region's output on every pipe rank (the JAX package's ``psum`` over the
pipe axis). Backward is autograd through the same schedule.

The JAX schedule runs every stage on every tick and masks the ticks
outside [s, s + nmicro) (their inputs are zeros, their outputs
dropped); here those ticks run nothing, which leaves the values as
they are.
"""

from __future__ import annotations

import torch

PIPE_AXIS = "pipe"


def _hop(sent: list, t: int) -> list:
    """What the stages receive at tick ``t``: ``sent[t - 1]``, each
    stage's output of the tick before (``[s]`` is stage s's, to stage
    s + 1)."""
    return sent[t - 1]


def gpipe(stage_fns: list, mbs: list) -> list:
    """Run ``mbs`` (stage 0's input, one entry per microbatch) through
    the stages ``stage_fns[s](act) -> act`` on the GPipe schedule; ->
    the last stage's outputs in microbatch order. An activation may be
    any value the stage functions take (a tensor, or a list of one per
    lane of the stage)."""
    nstages, nmicro = len(stage_fns), len(mbs)
    sent: list[list] = []
    outs = [None] * nmicro
    for t in range(nmicro + nstages - 1):
        recv = _hop(sent, t) if t else [None] * nstages
        row = [None] * nstages
        for s in range(nstages):
            mb = t - s
            if not 0 <= mb < nmicro:
                continue
            y = stage_fns[s](mbs[mb] if s == 0 else recv[s - 1])
            if s == nstages - 1:
                outs[mb] = y
            else:
                row[s] = y
        sent.append(row)
    return outs


def pipeline_apply(stage_fn, stage_params: dict, x: torch.Tensor,
                   nstages: int) -> torch.Tensor:
    """The JAX ``pipeline_apply`` on one controller: ``stage_fn(params
    of one stage, act) -> act``; ``stage_params`` has a leading
    ``nstages`` dim on every leaf; x (nmicro, mb, ...) -> the last
    stage's (nmicro, mb, ...) outputs. A 1-wide pipe axis maps the one
    stage over the microbatches."""
    fns = [
        (lambda act, one={k: v[s] for k, v in stage_params.items()}:
         stage_fn(one, act))
        for s in range(nstages)
    ]
    return torch.stack(gpipe(fns, list(x)))
