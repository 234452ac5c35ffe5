"""The resilience pieces the serving fleet and the sharded checkpoint
format need, the PyTorch counterparts of ``singa_tpu/resilience``: the
fault-plan grammar (``faults``), the flag-only preemption handler and
its resumable exit status (``preemption``), the atomic file publish and
the sharded saves' commit markers (``coord``), LATEST resolution and
checkpoint validation (``retention``), and the box-intersection
restore of a sharded save onto any rank count plus the serving restore
of a saved param tree (``reshard``). The supervisor, the divergence
guard and async checkpoints are not ported (ROADMAP.md), and the
Trainer refuses a ``resilience {}`` block by name."""
