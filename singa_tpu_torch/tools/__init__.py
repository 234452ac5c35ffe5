"""Tools of the port, each the counterpart of the JAX package's tool of
the same name (the same flags, defaults, thresholds and JSON keys; every
entry point runs on the GPU unless ``--device cpu`` is given):

  trace               per-process event logs -> one Chrome trace, or the
                      ``--summarize`` incident report
  telemetry_overhead  the flight recorder on against off
  collective_stall    the gradient collective's six modes (exact ..
                      q8_hier); ``measure_comm_ms``, ``record_comm_probe``
  update_stall        replicated against zero update; ``measure_update_ms``
  ckpt_stall          no saves, async and sync saves every step
  input_stall         the sync, prefetch and stream feeders
  attend_stall        the paged-attention kernel against the reference
  graph               net JSON -> graphviz dot       (script/graph.py)
  draw                training-log curves -> PNG     (script/draw.py)
  partition           records across worker groups   (script/load_data.py)
  sweep               scaling sweep over mesh sizes  (examples/mnist/batch.sh)
  elastic_launch      gangs relaunched under a restart budget
  cluster             start/stop/ps/ls/scp/exec over a hostfile (run.sh,
                      node.sh)
  serve_bench         the serving load harness
  generate            sampling CLI for conf-trained LMs

and the timing harnesses of design variants (``dispatch_turns``,
``axes_turns``, ``flash_bwd_turns``, ``flash_bwd_variants``).
"""
