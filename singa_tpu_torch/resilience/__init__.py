"""The resilience pieces the serving fleet needs, the PyTorch
counterparts of ``singa_tpu/resilience``: the fault-plan grammar
(``faults``), the flag-only preemption handler and its resumable exit
status (``preemption``), the atomic file publish under the fleet
mailbox (``coord``), LATEST resolution (``retention``) and the serving
restore of a saved param tree (``reshard``). The supervisor, the
divergence guard, async checkpoints and the sharded format are not
ported (ROADMAP.md), and the Trainer refuses a ``resilience {}`` block
by name."""
