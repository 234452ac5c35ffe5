"""The contrastive-divergence engine with a model group that spans OS
processes. Its step runs the JAX program's one Gibbs chain over the
global batch on every process, each model rank's hidden units from its
shards of the stored params that every process holds (``CDTrainer.
_step_core``), so the spanning group needs no layer exchange: the
pieces' updates are the same on every process.

examples/mnist/rbm.conf narrowed as tests/test_torch_rbm.py narrows it
(hidden units 100-50-24-8, batch 16) with kLayerPartition on data 1 x
model 2 as 2 processes of one rank each, through the real CLI over gloo
on the CPU: both processes end with the digest of one process holding
the two ranks, bitwise.
"""

from test_torch_launch import one_torch_thread  # noqa: F401
from test_torch_model_span_trainer import check_span, one_process, span_launch
from test_torch_rbm import RBM_CONF, shards  # noqa: F401

STEPS = 4
CLUSTER = "nworkers: 2\nnprocs_per_group: 2"


def rbm_text(shards) -> str:
    text = RBM_CONF.read_text()
    for old, new in (("train_steps: 6000", f"train_steps: {STEPS}"),
                     ("examples/mnist/train_shard", shards["train"]),
                     ("examples/mnist/test_shard", shards["test"]),
                     ("batchsize: 100", "batchsize: 16"),
                     ("num_hidden: 1000", "num_hidden: 100"),
                     ("num_hidden: 500", "num_hidden: 50"),
                     ("num_hidden: 250", "num_hidden: 24"),
                     ("num_hidden: 30", "num_hidden: 8"),
                     ("neuralnet {",
                      "neuralnet {\n  partition_type: kLayerPartition")):
        assert old in text, old
        text = text.replace(old, new)
    return text


def test_cd_stack_split_over_two_processes_equals_one_process(tmp_path,
                                                              shards):
    text = rbm_text(shards)
    reports = span_launch(tmp_path, text, 2, CLUSTER)
    one = one_process(text, CLUSTER, 1, 2, tmp_path)
    assert type(one).__name__ == "CDTrainer"
    assert one._layout["rbm1/weight"] == (1, "model")
    # no layer exchange: the chain runs whole on every process
    check_span(reports, 2, 1, one.digest(), steps=STEPS, exchanged=False)
