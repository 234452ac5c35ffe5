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

A Trainer's walk runs the schedule over its lanes (:func:`gpipe_lanes`):
each tick ends in one hop, an exchange over each pipe group
(``Lanes.exchange``) that hands every lane every stage's output of the
tick (zeros from a stage idle at it), so a pipe group may span
processes, each running only its own stages; every process of the
group enters every tick's hop, busy or not, in tick order. The last
stage's output reaches every pipe rank through the same hops.
"""

from __future__ import annotations

import torch

PIPE_AXIS = "pipe"


def _hop(sent: list, t: int):
    """What the stages receive at tick ``t``: ``sent[t - 1]``, what the
    tick before handed on (``[s]`` stage s's output, to stage s + 1; in
    ``gpipe_lanes`` ``[j][s]``, lane j's copy of it)."""
    return sent[t - 1]


def _ticks(nstages: int, nmicro: int, tick) -> None:
    """The GPipe schedule: at tick t every stage s whose microbatch t - s
    lies in [0, nmicro) is busy; ``tick(t, busy, recv)`` runs them (recv:
    ``_hop`` of what the ticks before handed on, None at tick 0) and
    returns what tick t hands on."""
    sent: list = []
    for t in range(nmicro + nstages - 1):
        busy = [s for s in range(nstages) if 0 <= t - s < nmicro]
        sent.append(tick(t, busy, _hop(sent, t) if t else None))


def gpipe(stage_fns: list, mbs: list) -> list:
    """Run ``mbs`` (stage 0's input, one entry per microbatch) through
    the stages ``stage_fns[s](act) -> act`` on the GPipe schedule; ->
    the last stage's outputs in microbatch order. An activation may be
    any value the stage functions take (a tensor, or a list of one per
    lane of the stage)."""
    nstages, nmicro = len(stage_fns), len(mbs)
    outs = [None] * nmicro

    def tick(t, busy, recv):
        row = [None] * nstages
        for s in busy:
            row[s] = stage_fns[s](mbs[t] if s == 0 else recv[s - 1])
        if busy[-1] == nstages - 1:
            outs[t - nstages + 1] = row[-1]
        return row

    _ticks(nstages, nmicro, tick)
    return outs


def gpipe_lanes(run, stage_lanes: list, mbs: dict, lanes) -> dict:
    """The GPipe schedule over a walk's lanes of one group of pipe (and
    model) ranks: ``stage_lanes[s]`` this walk's lanes of stage s (its
    model ranks, in model order; empty for a stage another process
    runs), ``run(s, acts) -> acts`` stage s on them, ``mbs[j]`` lane j's
    entry activation split into microbatches (stage 0 reads its lanes',
    every lane's gives the hop's shape and dtype). -> {lane: the last
    stage's outputs in microbatch order}. Each tick's hop is one
    exchange per model index over the pipe axis, entered at every tick
    whether this process's stages are busy or not; stage s + 1 reads
    part s of the hop of the tick before (``_hop``), every lane part
    ``nstages - 1`` of the tick its microbatch leaves the last stage."""
    nstages = len(stage_lanes)
    lanes_of = [j for js in stage_lanes for j in js]
    nmicro = len(mbs[lanes_of[0]])
    here = [s for s in range(nstages) if stage_lanes[s]]
    width = len(stage_lanes[here[0]])
    #: the hops' lanes: per model index, this walk's lane of each of its
    #: stages, in stage order
    chains = [[stage_lanes[s][k] for s in here] for k in range(width)]
    like = {j: mbs[j][0] for j in lanes_of}
    outs = {j: [None] * nmicro for j in lanes_of}

    def tick(t, busy, recv):
        row = {}
        for s in here:
            if s not in busy:
                continue
            js = stage_lanes[s]
            ys = run(s, [mbs[j][t] for j in js] if s == 0 else
                     [recv[j][s - 1] for j in js])
            for j, y in zip(js, ys):
                if (y.shape, y.dtype) != (like[j].shape, like[j].dtype):
                    raise ValueError(
                        f"pipeline stage {s}: output {tuple(y.shape)} "
                        f"{y.dtype} is not the entry's "
                        f"{tuple(like[j].shape)} {like[j].dtype}")
                row[j] = y
        got = {}
        for chain in chains:
            parts = [row[j] if j in row else torch.zeros_like(like[j])
                     for j in chain]
            got.update(zip(chain, lanes.exchange(chain, parts,
                                                 axes=(PIPE_AXIS,))))
        if busy[-1] == nstages - 1:
            for j in lanes_of:
                outs[j][t - nstages + 1] = got[j][nstages - 1]
        return got

    _ticks(nstages, nmicro, tick)
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
