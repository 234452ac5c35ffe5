"""Typed job-config schema mirroring the reference proto surface.

Field names, defaults, and enum vocabularies reproduce the reference's
`src/proto/model.proto` and `src/proto/cluster.proto` so that existing job
files (e.g. reference examples/mnist/mlp.conf, conv.conf) parse unchanged.
The schema is implemented as lightweight Python message classes rather than
generated protobuf code: the text-format front end lives in
``singa_tpu.config.textproto`` and this module applies typing + defaults.

Enums are represented as strings (the text-format identifiers, e.g.
``"kSGD"``, ``"MAX"``); constants are provided for comparison.
"""

from __future__ import annotations

from typing import Any

from . import textproto


# --------------------------------------------------------------------------
# enum vocabularies (model.proto:40-44,72-92,108-122,251-254,308-335)
# --------------------------------------------------------------------------

GRAD_CALC_ALGS = ("kBackPropagation", "kContrastiveDivergence")
INIT_METHODS = (
    "kConstant",
    "kGaussain",  # [sic] reference spelling, model.proto:75
    "kUniform",
    "kPretrained",
    "kGaussainSqrtFanIn",
    "kUniformSqrtFanIn",
    "kUniformSqrtFanInOut",
)
PHASES = ("kTrain", "kValidation", "kTest")
PARTITION_TYPES = ("kDataPartition", "kLayerPartition", "kNone")
CONNECTION_TYPES = ("kOneToOne", "kOneToAll")
POOL_METHODS = ("MAX", "AVE")
NORM_REGIONS = ("ACROSS_CHANNELS", "WITHIN_CHANNEL")
UPDATER_TYPES = ("kAdaGrad", "kAdaDelta", "kNesterov", "kSGD", "kRMSProp")
LR_CHANGE_METHODS = (
    "kFixed",
    "kInverse_t",
    "kInverse",
    "kExponential",
    "kLinear",
    "kStep",
)

#: Accepted alternate spellings, normalized to the reference token before
#: enum membership is checked. The reference's model.proto misspells
#: Gaussian ("kGaussain", model.proto:75); hand-written configs using the
#: corrected spelling parse fine and normalize to the [sic] token so the
#: rest of the system (param init, checkpoints) sees one vocabulary.
#: netlint's CFG003 points authors at this table.
ENUM_ALIASES = {
    "kGaussian": "kGaussain",
    "kGaussianSqrtFanIn": "kGaussainSqrtFanIn",
}


class ConfigError(ValueError):
    pass


# --------------------------------------------------------------------------
# message machinery
# --------------------------------------------------------------------------


class Field:
    """One schema field: type, default, repeated-ness, enum/message binding."""

    def __init__(
        self,
        kind: str,
        default: Any = None,
        *,
        repeated: bool = False,
        enum: tuple[str, ...] | None = None,
        message: type | None = None,
        required: bool = False,
    ):
        assert kind in ("int", "float", "bool", "string", "enum", "message")
        self.kind = kind
        self.default = default
        self.repeated = repeated
        self.enum = enum
        self.message = message
        self.required = required

    def convert(self, raw: Any, name: str) -> Any:
        k = self.kind
        if k == "message":
            if not isinstance(raw, dict):
                raise ConfigError(f"field {name!r} expects a message block")
            return self.message.from_fields(raw)
        if k == "int":
            if isinstance(raw, bool) or not isinstance(raw, (int, float)):
                raise ConfigError(f"field {name!r} expects an int, got {raw!r}")
            if isinstance(raw, float):
                # protobuf's text parser rejects any float literal for an
                # int32 field ("Expected integer, got: 2.0")
                raise ConfigError(
                    f"field {name!r} expects an int, got float {raw!r}"
                )
            return raw
        if k == "float":
            if isinstance(raw, bool) or not isinstance(raw, (int, float)):
                raise ConfigError(f"field {name!r} expects a number, got {raw!r}")
            return float(raw)
        if k == "bool":
            if isinstance(raw, bool):
                return raw
            if raw in (0, 1):
                return bool(raw)
            raise ConfigError(f"field {name!r} expects a bool, got {raw!r}")
        if k == "string":
            if not isinstance(raw, str):
                raise ConfigError(f"field {name!r} expects a string, got {raw!r}")
            return raw
        if k == "enum":
            if isinstance(raw, str) and raw in self.enum:
                # exact members always win; aliasing only rescues
                # spellings the vocabulary does not contain
                return raw
            canon = ENUM_ALIASES.get(raw, raw) if isinstance(raw, str) else raw
            if not isinstance(raw, str) or canon not in self.enum:
                # report what the user wrote, not the normalized token
                raise ConfigError(
                    f"field {name!r}: {raw!r} not in enum {self.enum}"
                )
            return canon
        raise AssertionError(k)


class Message:
    """Base for schema messages; subclasses declare FIELDS."""

    FIELDS: dict[str, Field] = {}

    def __init__(self, **kwargs: Any):
        for fname, spec in self.FIELDS.items():
            if fname in kwargs:
                val = kwargs.pop(fname)
            elif spec.repeated:
                val = []
            else:
                val = spec.default
            setattr(self, fname, val)
        if kwargs:
            raise ConfigError(
                f"{type(self).__name__}: unknown fields {sorted(kwargs)}"
            )

    @classmethod
    def from_fields(cls, raw: dict[str, list[Any]]) -> "Message":
        out: dict[str, Any] = {}
        for fname, occurrences in raw.items():
            spec = cls.FIELDS.get(fname)
            if spec is None:
                raise ConfigError(
                    f"{cls.__name__}: unknown field {fname!r} "
                    f"(known: {sorted(cls.FIELDS)})"
                )
            if spec.repeated:
                out[fname] = [spec.convert(v, fname) for v in occurrences]
            elif spec.kind == "message" and len(occurrences) > 1:
                # protobuf text-format merge: duplicate occurrences of a
                # non-repeated message field merge field-wise (recursively);
                # concatenating the occurrence lists reproduces that exactly.
                merged: dict[str, list[Any]] = {}
                for occ in occurrences:
                    if not isinstance(occ, dict):
                        raise ConfigError(
                            f"field {fname!r} expects a message block"
                        )
                    for sub, subvals in occ.items():
                        merged.setdefault(sub, []).extend(subvals)
                out[fname] = spec.convert(merged, fname)
            else:
                out[fname] = spec.convert(occurrences[-1], fname)
        msg = cls(**out)
        for fname, spec in cls.FIELDS.items():
            if spec.required and getattr(msg, fname) is None:
                raise ConfigError(f"{cls.__name__}: missing required {fname!r}")
        return msg

    @classmethod
    def from_text(cls, text: str) -> "Message":
        return cls.from_fields(textproto.parse(text))

    @classmethod
    def from_file(cls, path: str) -> "Message":
        return cls.from_fields(textproto.parse_file(path))

    def to_dict(self) -> dict[str, Any]:
        out = {}
        for fname, spec in self.FIELDS.items():
            v = getattr(self, fname)
            if spec.kind == "message":
                if spec.repeated:
                    v = [m.to_dict() for m in v]
                elif v is not None:
                    v = v.to_dict()
            out[fname] = v
        return out

    def __repr__(self) -> str:
        inner = ", ".join(
            f"{k}={getattr(self, k)!r}"
            for k in self.FIELDS
            if getattr(self, k) not in (None, [])
        )
        return f"{type(self).__name__}({inner})"


# --------------------------------------------------------------------------
# per-layer hyper-parameter messages (model.proto:160-275)
# --------------------------------------------------------------------------


class RGBImageConfig(Message):
    FIELDS = {
        "scale": Field("float", 1.0),
        "cropsize": Field("int", 0),
        "mirror": Field("bool", False),
        # singa-tpu extension (matches the successor SINGA's
        # rgbimage_param.meanfile): path to a mean.npy to subtract on
        # device. This snapshot's reference subtracts the mean at loader
        # time instead (tools/data_loader/data_source.cc:158-173); doing
        # it in the parser keeps shards uint8 and lets XLA fuse the
        # subtraction into the first conv.
        "meanfile": Field("string"),
    }


class SplitConfig(Message):
    FIELDS = {"num_splits": Field("int")}


class EmbeddingConfig(Message):
    """singa-tpu extension: token + learned positional embedding
    (layers/sequence.py). The reference predates sequence models."""

    FIELDS = {
        "vocab_size": Field("int", required=True),
        "embedding_dim": Field("int", required=True),
        "max_len": Field("int", 0),  # 0 = the data layer's seq length
    }


class LayerNormConfig(Message):
    FIELDS = {"eps": Field("float", 1e-5)}


class AttentionConfig(Message):
    """Causal multi-head self-attention over (B, S, D) activations.
    mode "flash" runs the Pallas kernel on TPU (dense fallback where the
    kernel can't serve the geometry)."""

    FIELDS = {
        "num_heads": Field("int", required=True),
        # "flash": Pallas kernel; "ring": sequence-parallel ring attention
        # over the cluster's seq mesh axis (nseq_per_group), falling back
        # to flash/dense when the mesh has no seq axis
        "mode": Field("enum", "dense", enum=("dense", "flash", "ring")),
    }


class DenseConfig(Message):
    """Per-position (last-dim) linear map — unlike kInnerProduct, which
    flattens to (batch, -1). Optional fused activation."""

    FIELDS = {
        "num_output": Field("int", required=True),
        "activation": Field("enum", "", enum=("", "gelu", "relu")),
        "bias_term": Field("bool", True),
    }


class MoEConfig(Message):
    """singa-tpu extension: Switch-style top-1 mixture-of-experts FFN
    (kMoE). Expert weights shard over the cluster's expert mesh axis
    (nexperts_per_group); the load-balancing aux loss joins the total
    loss with weight aux_loss_weight. num_experts must be a multiple of
    the expert axis width."""

    FIELDS = {
        "num_experts": Field("int", required=True),
        "d_ff": Field("int", required=True),
        "capacity_factor": Field("float", 1.25),
        "aux_loss_weight": Field("float", 0.01),
        # "psum" replicates tokens over the expert axis and all-reduces
        # the combine (exactly dense-equivalent); "alltoall" shards
        # tokens over the expert axis too and moves only capacity
        # buffers (GShard semantics: per-shard capacity) —
        # parallel/moe.py moe_ffn_a2a's comm-volume docstring
        "dispatch": Field("string", "psum"),
    }


class GlobalPoolingConfig(Message):
    """singa-tpu extension: kGlobalPooling has no kernel/stride — only the
    method (AVE default, the ResNet convention)."""

    FIELDS = {"pool": Field("enum", "AVE", enum=POOL_METHODS)}


class BatchNormConfig(Message):
    """singa-tpu extension (no counterpart in model.proto — the reference
    predates batch norm); configures layers/norm.py BatchNormLayer."""

    FIELDS = {
        "momentum": Field("float", 0.9),
        "eps": Field("float", 1e-5),
        # OPT-IN different math (r5): batch moments from the first
        # batch/N sample rows with a straight-through (detached-stats)
        # backward — see ops/norm.py batch_norm_train_sampled. 1 = exact.
        "stats_sample_stride": Field("int", 1),
    }


class TanhConfig(Message):
    # scaled tanh: outer_scale * tanh(inner_scale * x); defaults are 1.0 but
    # the reference kTanh layer always uses the LeCun constants (stanh,
    # cxxnet_op.h:77-87) regardless — see layers/neuron.py.
    FIELDS = {
        "outer_scale": Field("float", 1.0),
        "inner_scale": Field("float", 1.0),
    }


class SoftmaxLossConfig(Message):
    FIELDS = {
        "topk": Field("int", 1),
        "scale": Field("float", 1.0),
    }


class ConvolutionConfig(Message):
    FIELDS = {
        "num_filters": Field("int"),
        "bias_term": Field("bool", True),
        "pad": Field("int", 0),
        "stride": Field("int", 1),
        "kernel": Field("int", required=True),
    }


class ConcateConfig(Message):
    FIELDS = {
        "concate_dimension": Field("int"),
        "concate_num": Field("int"),
    }


class DataConfig(Message):
    FIELDS = {
        "source": Field("string"),
        "path": Field("string"),
        "batchsize": Field("int"),
        "random_skip": Field("int", 0),
    }


class MnistConfig(Message):
    FIELDS = {
        "kernel": Field("int", 0),
        "sigma": Field("float", 0.0),
        "alpha": Field("float", 0.0),
        "beta": Field("float", 0.0),
        "gamma": Field("float", 0.0),
        "resize": Field("int", 0),
        "elastic_freq": Field("int", 0),
        "norm_a": Field("float", 1.0),
        "norm_b": Field("float", 0.0),
    }


class DropoutConfig(Message):
    FIELDS = {"dropout_ratio": Field("float", 0.5)}


class InnerProductConfig(Message):
    FIELDS = {
        "num_output": Field("int"),
        "bias_term": Field("bool", True),
    }


class RBMConfig(Message):
    """singa-tpu extension: restricted Boltzmann machine hyperparams.

    The reference declares the contrastive-divergence algorithm
    (GradCalcAlg.kContrastiveDivergence, model.proto:40-44) but ships no CD
    worker or RBM layer; this message parameterizes the greenfield kRBM
    layer that fills that hole (BASELINE config 4)."""

    FIELDS = {
        "num_hidden": Field("int"),
        "cd_k": Field("int", 1),
        # sample (vs. use mean-field probabilities for) the visible units
        # during Gibbs steps
        "sample_visible": Field("bool", False),
    }


class LRNConfig(Message):
    FIELDS = {
        "local_size": Field("int", 5),
        "alpha": Field("float", 1.0),
        "beta": Field("float", 0.75),
        "norm_region": Field("enum", "ACROSS_CHANNELS", enum=NORM_REGIONS),
        "knorm": Field("float", 1.0),
    }


class PoolingConfig(Message):
    FIELDS = {
        "pool": Field("enum", "MAX", enum=POOL_METHODS),
        "kernel": Field("int", required=True),
        "pad": Field("int", 0),
        "stride": Field("int", 1),
    }


class SliceConfig(Message):
    FIELDS = {
        "slice_dimension": Field("int"),
        "slice_num": Field("int"),
    }


class ReLUConfig(Message):
    FIELDS = {"negative_slope": Field("float", 0.0)}


class ParamConfig(Message):
    FIELDS = {
        "name": Field("string"),
        "id": Field("int"),
        "shape": Field("int", repeated=True),
        "split_threshold": Field("int", 5000000),
        "partition_dim": Field("int", -1),
        "init_method": Field("enum", "kConstant", enum=INIT_METHODS),
        "value": Field("float", 1.0),
        "low": Field("float", -1.0),
        "high": Field("float", 1.0),
        "mean": Field("float", 0.0),
        "std": Field("float", 1.0),
        "learning_rate_multiplier": Field("float", 1.0),
        "weight_decay_multiplier": Field("float", 1.0),
    }


class LayerConfig(Message):
    FIELDS = {
        "name": Field("string"),
        "type": Field("string"),
        "srclayers": Field("string", repeated=True),
        # locationid is the reference's layer-placement field
        # (base_layer.h:151-165: which thread/process hosts the layer).
        # Here an explicitly-set locationid assigns the layer to a
        # PIPELINE STAGE (graph/pipeline_plan.py) when the cluster conf
        # declares npipes_per_group > 1. Default None = unplaced
        # (prologue/epilogue, replicated); the reference's default is 0,
        # which a conf may still write explicitly.
        "locationid": Field("int", None),
        "partitionid": Field("int", 0),
        "partition_type": Field("enum", None, enum=PARTITION_TYPES),
        "share_ary": Field("string", repeated=True),
        "param": Field("message", repeated=True, message=ParamConfig),
        "share_param": Field("string", repeated=True),
        "exclude": Field("enum", repeated=True, enum=PHASES),
        "batchnorm_param": Field("message", message=BatchNormConfig),
        "globalpooling_param": Field("message", message=GlobalPoolingConfig),
        "embedding_param": Field("message", message=EmbeddingConfig),
        "layernorm_param": Field("message", message=LayerNormConfig),
        "attention_param": Field("message", message=AttentionConfig),
        "dense_param": Field("message", message=DenseConfig),
        "moe_param": Field("message", message=MoEConfig),
        "convolution_param": Field("message", message=ConvolutionConfig),
        "concate_param": Field("message", message=ConcateConfig),
        "data_param": Field("message", message=DataConfig),
        "dropout_param": Field("message", message=DropoutConfig),
        "inner_product_param": Field("message", message=InnerProductConfig),
        "lrn_param": Field("message", message=LRNConfig),
        "mnist_param": Field("message", message=MnistConfig),
        "pooling_param": Field("message", message=PoolingConfig),
        "rbm_param": Field("message", message=RBMConfig),
        "slice_param": Field("message", message=SliceConfig),
        "split_param": Field("message", message=SplitConfig),
        "relu_param": Field("message", message=ReLUConfig),
        "rgbimage_param": Field("message", message=RGBImageConfig),
        "softmaxloss_param": Field("message", message=SoftmaxLossConfig),
        "tanh_param": Field("message", message=TanhConfig),
    }


# --------------------------------------------------------------------------
# data record messages (model.proto:279-305,342-349)
# --------------------------------------------------------------------------

RECORD_TYPES = ("kSingleLabelImage",)


class SingleLabelImageRecord(Message):
    """One labelled image sample (model.proto:300-305).

    ``pixel`` holds raw uint8 bytes (decoded from the protobuf bytes field);
    ``data`` holds float pixels. Exactly one of the two is normally set.
    """

    FIELDS = {
        "shape": Field("int", repeated=True),
        "label": Field("int", 0),
        "pixel": Field("string", ""),
        "data": Field("float", repeated=True),
    }


class RecordConfig(Message):
    """Top-level dataset record (model.proto:279-285)."""

    FIELDS = {
        "type": Field("enum", "kSingleLabelImage", enum=RECORD_TYPES),
        "image": Field("message", message=SingleLabelImageRecord),
    }


class DatumConfig(Message):
    """Caffe LMDB record for import (model.proto:288-299)."""

    FIELDS = {
        "channels": Field("int", 0),
        "height": Field("int", 0),
        "width": Field("int", 0),
        "data": Field("string", ""),
        "label": Field("int", 0),
        "float_data": Field("float", repeated=True),
        "encoded": Field("bool", False),
    }


class BlobConfig(Message):
    """Tensor snapshot message (model.proto:342-349); used by checkpoints."""

    FIELDS = {
        "num": Field("int", 0),
        "channels": Field("int", 0),
        "height": Field("int", 0),
        "width": Field("int", 0),
        "data": Field("float", repeated=True),
        "diff": Field("float", repeated=True),
    }


class NetConfig(Message):
    FIELDS = {
        "layer": Field("message", repeated=True, message=LayerConfig),
        "partition_type": Field("enum", "kNone", enum=PARTITION_TYPES),
    }


class UpdaterConfig(Message):
    FIELDS = {
        "type": Field("enum", "kAdaGrad", enum=UPDATER_TYPES),
        "hogwild": Field("bool", True),
        "momentum": Field("float", 0.0),
        "weight_decay": Field("float", 0.0),
        "gamma": Field("float", 1.0),
        "pow": Field("float", 0.0),
        "delta": Field("float", 1e-7),
        "rho": Field("float", 0.9),
        "base_learning_rate": Field("float"),
        "final_learning_rate": Field("float"),
        "learning_rate_change_frequency": Field("int"),
        "learning_rate_change_method": Field(
            "enum", "kFixed", enum=LR_CHANGE_METHODS
        ),
        "sync_frequency": Field("int", 1),
        "warmup_steps": Field("int", 10),
        "moving_rate": Field("float", 0.0),
        "param_type": Field("string", "Elastic"),
    }


GUARD_POLICIES = ("kNone", "kSkip", "kRollback")


class ResilienceConfig(Message):
    """singa-tpu extension: fault-tolerance runtime knobs (resilience/).

    Presence of this block opts the job into the supervised train loop:
    ``resilience.supervisor.run`` catches crashes, restores the newest
    complete checkpoint, and retries with bounded exponential backoff; a
    crash-loop circuit breaker gives up loudly after ``max_restarts``
    failures that each made less than ``restart_window_steps`` steps of
    progress. SIGTERM/SIGINT drain the current step, write a final
    checkpoint, and exit resumable (TPU maintenance-event discipline).
    The reference's availability story was the parameter-server tier a
    restarted worker group rejoined (src/main.cc:49-55) plus the
    never-implemented Worker::Resume (src/worker/worker.cc:65-67); with
    no server tier, this block is the trainer-side replacement.
    """

    FIELDS = {
        # --- supervisor: crash-loop circuit breaker + backoff ---
        # give up after this many restarts that each progressed fewer
        # than restart_window_steps steps (a restart that gets past the
        # window resets the breaker); 0 = never restart
        "max_restarts": Field("int", 3),
        "restart_window_steps": Field("int", 1),
        # --- launcher-side restart budget (resilience/launcher.py) ---
        # distinct from the in-process breaker above: the breaker bounds
        # crash loops WITHIN one process lifetime, while exit-75
        # (resumable) statuses deliberately bypass it — a launcher that
        # blindly relaunches them can loop forever on a deterministic
        # drain/death cycle. The elastic launcher relaunches a gang at
        # most max_restarts_per_window times per rolling
        # restart_window_s seconds, then gives up loudly.
        # 0 = unbudgeted (relaunch forever; today's behavior).
        "max_restarts_per_window": Field("int", 0),
        "restart_window_s": Field("float", 3600.0),
        # exponential backoff between restarts: base * 2^k seconds,
        # capped at backoff_max (tests set base 0 for instant retries)
        "backoff_base": Field("float", 1.0),
        "backoff_max": Field("float", 60.0),
        # --- retention: keep-last-N complete checkpoints + LATEST ---
        "keep_last": Field("int", 3),
        # --- zero-stall checkpointing (resilience/async_ckpt.py): the
        # save becomes a non-blocking device snapshot at the step
        # boundary + a background writer thread (double-buffered; a full
        # buffer applies backpressure). SIGTERM drain flushes the
        # in-flight write before exiting resumable; a crash mid-write
        # never corrupts LATEST. false = the synchronous save path. ---
        "async_checkpoint": Field("bool", False),
        # --- divergence guard (on-device; no per-step host sync) ---
        # kSkip: drop a non-finite step's update and count it;
        # kRollback: additionally restore the last checkpoint with an LR
        # backoff after guard_rollback_after consecutive bad steps
        "guard_policy": Field("enum", "kNone", enum=GUARD_POLICIES),
        "guard_rollback_after": Field("int", 3),
        # effective-LR multiplier applied at each rollback (grads are
        # scaled by the accumulated factor inside the jitted step)
        "guard_lr_backoff": Field("float", 0.5),
        # --- hung-step watchdog: dump diagnostics when a step exceeds
        # this many seconds without reaching a boundary; 0 = disabled ---
        "watchdog_timeout": Field("float", 0.0),
        # write a final checkpoint when draining on SIGTERM/SIGINT
        "preemption_checkpoint": Field("bool", True),
        # --- cluster coordination (resilience/coord.py) ---
        # fold every host's preemption flag into a cross-host OR at
        # step/chunk boundaries so ANY host's SIGTERM drains EVERY host
        # at the SAME step (all ranks checkpoint + exit 75 together);
        # no-op on single-process jobs
        "coordinate_preemption": Field("bool", True),
        # peer-liveness watchdog: each rank touches a heartbeat file
        # while its process lives; a peer file stale past this many
        # seconds while OUR step is stalled means the peer died
        # mid-collective -> loud resumable exit (75) instead of a
        # silent forever-hang. 0 = disabled.
        "heartbeat_timeout_s": Field("float", 0.0),
        # two-phase sharded-save commit: process 0 promotes LATEST only
        # after every rank's CRC'd commit_k marker lands and verifies;
        # past this deadline the save is judged torn (LATEST keeps the
        # previous complete checkpoint)
        "commit_timeout_s": Field("float", 60.0),
    }


GRAD_COMM_MODES = ("exact", "quantized")
GRAD_COMM_DTYPES = ("int8", "bf16")


class GradCommConfig(Message):
    """singa-tpu extension: quantized + overlapped gradient collectives
    (parallel/collectives.py; PAPERS.md arxiv 2506.17615 EQuARX).

    ``mode: quantized`` casts each bucket's gradients to a scaled
    low-precision wire format (``dtype``) before the data-axis
    reduction — composing with ``zero_update``'s reduce-scatter layout —
    and dequantizes after; with ``error_feedback`` (default on) the
    compression error persists as per-param residual buffers re-injected
    next step, so convergence matches fp32 (validated end to end by
    tools/convergence.py ``--grad_comm q8``). ``buckets: N`` partitions
    the params into N reverse-topo groups whose reductions are chained
    in gradient-readiness order, so bucket k's collective overlaps
    bucket k+1's backward segment instead of one barrier at step end
    (N also sets the quantization-scale granularity; 0 = per-param
    scales, no ordering chain). ``mode: exact`` (default, = no block)
    keeps today's bitwise-identical fp32 path. Rejected by the replica
    engine, whose EASGD protocol owns its own sync math."""

    FIELDS = {
        "mode": Field("enum", "exact", enum=GRAD_COMM_MODES),
        "dtype": Field("enum", "int8", enum=GRAD_COMM_DTYPES),
        "error_feedback": Field("bool", True),
        "buckets": Field("int", 0),
    }


SPEC_DRAFTERS = ("ngram", "null")


class SpeculateConfig(Message):
    """singa-tpu extension: speculative multi-token decode for the
    serving tier (serve/speculate.py). ``k`` draft tokens per live slot
    per tick are proposed by a model-free ``drafter`` (``ngram`` =
    longest-suffix prompt lookup against the sequence's own
    prompt+emitted tokens; ``null`` = never proposes — the machinery
    probe) and scored in ONE fixed-shape batched verify pass; greedy
    acceptance takes the longest matching prefix plus the bonus token,
    and a masked KV rewind keeps the paged cache bitwise what
    sequential one-token decode would have written. Token streams are
    identical to non-speculative greedy by construction — speculation
    changes *when* tokens appear, never *which*. ``k: 0`` (default)
    disables speculation (the one-token decode tick). Speculation is
    greedy-only per slot: a temperature > 0 slot rides the verify tick
    with zero drafts (one sampled token per tick)."""

    FIELDS = {
        # draft tokens proposed per live greedy slot per tick; the
        # verify program scores (slots, k+1) positions in one forward
        "k": Field("int", 0),
        # draft source: "ngram" prompt-lookup, "null" (machinery probe)
        "drafter": Field("enum", "ngram", enum=SPEC_DRAFTERS),
    }


class PrefixCacheConfig(Message):
    """singa-tpu extension: prefix caching for the paged KV pool
    (serve/kv_pool.py). ``enabled`` turns the block allocator into a
    content-addressed, refcounted cache: FULL prompt-prefilled blocks
    are hashed by (prefix-so-far, block token ids), admissions share
    the incoming prompt's longest cached block-prefix instead of
    re-prefilling it (copy-on-write where a write into a shared block
    is unavoidable), and token streams plus the paged cache stay
    BITWISE identical to cache-disabled admission. ``lru`` keeps
    refcount-0 cached blocks on an LRU list — reclaimed lazily only
    when an allocation would otherwise exhaust the pool — so hits
    survive the cached sequence's retirement; false shares only among
    concurrently-live sequences."""

    FIELDS = {
        # content-addressed block sharing at admission (default off:
        # the plain free-list allocator, no hashing, no refcount > 1)
        "enabled": Field("bool", False),
        # park refcount-0 cached blocks on an LRU list instead of
        # freeing eagerly (reclaimed lazily at pool exhaustion)
        "lru": Field("bool", True),
        # > 0: PARTIAL-TAIL sharing — sub-block digests at this token
        # stride index a prompt's last partial block, so a prompt whose
        # shared prefix ends mid-block copy-on-write-EXTENDS the deepest
        # registered partial match instead of re-prefilling the whole
        # block. Must divide kv_block_len (netlint SRV001 checks this
        # statically). 0 = full-block granularity only.
        "tail_stride": Field("int", 0),
        # register FULL decode-written blocks under the same chained
        # digest at retirement, so multi-turn conversations hit their
        # own history. Decode-written bytes ride a different compiled
        # shape than prefill (the cross-shape caveat), so warm
        # streams over these blocks are TOKEN-LEVEL identical to cold
        # admission, not bitwise — default off preserves the bitwise
        # guarantee.
        "decode_blocks": Field("bool", False),
        # fleet cross-host block shipping: how long a host holds a
        # request awaiting a peer's cache_ship reply before degrading
        # to plain prefill (serve/fleet/host.py; never a hang)
        "fetch_timeout_s": Field("float", 2.0),
    }


class ServingConfig(Message):
    """singa-tpu extension: the serving tier (singa_tpu/serve/) — the
    capability analog of the reference's Server tier (one process
    answering every worker's kGet/kPut, src/server/server.cc), here one
    engine answering every client's generation request. ``slots`` is
    the decode batch width (one donated fixed-shape step advances every
    live slot per tick; admit/retire never recompiles); the KV cache is
    paged — ``kv_blocks`` fixed-size blocks of ``kv_block_len``
    positions each, allocated per request at admission and freed at
    retirement, so concurrent streams share device memory instead of
    each reserving max_len (admission backpressure when the pool is
    exhausted). ``max_prefill_chunk`` bounds how much prompt one tick
    prefills, so long prompts never stall live decode."""

    FIELDS = {
        # concurrent decode lanes in the single compiled step
        "slots": Field("int", 8),
        # positions per KV block; must divide the model's max_len
        "kv_block_len": Field("int", 16),
        # total pool blocks (incl. the reserved trash block);
        # 0 = dense-equivalent sizing (every slot can hold max_len)
        "kv_blocks": Field("int", 0),
        # max prompt tokens prefilled per request per tick
        "max_prefill_chunk": Field("int", 64),
        # speculative multi-token decode (absent = one-token ticks)
        "speculate": Field("message", message=SpeculateConfig),
        # refcounted copy-on-write block sharing at admission (absent =
        # the plain free-list allocator, every prompt fully prefilled)
        "prefix_cache": Field("message", message=PrefixCacheConfig),
    }


FLEET_ROLES = ("unified", "prefill", "decode", "auto")
FLEET_PEER_ROLES = ("unified", "prefill", "decode")


class FleetLoadConfig(Message):
    """singa-tpu extension: the offered-load model for the cost-aware
    shardlint's fleet sizing rule (lint/cost_model.py FLT002). Declares
    the traffic the fleet is sized for; netlint checks each role's
    aggregate capacity against it — decode capacity is
    ``decode_hosts * serving.slots * ticks_per_s`` tokens/s (every live
    slot emits one token per tick), prefill capacity is
    ``prefill_hosts * serving.max_prefill_chunk * ticks_per_s``
    prompt tokens/s (one chunk per host per tick). The rule only runs
    when ``requests_per_s`` and ``ticks_per_s`` are both positive —
    an absent or zeroed block declares no load model and is skipped."""

    FIELDS = {
        # steady-state request arrival rate the fleet must absorb
        "requests_per_s": Field("float", 0.0),
        # mean prompt length per request (prefill token demand)
        "prompt_tokens": Field("int", 0),
        # mean generated tokens per request (decode token demand)
        "decode_tokens": Field("int", 0),
        # engine step rate per host (decode ticks == prefill ticks)
        "ticks_per_s": Field("float", 0.0),
        # steady-state fraction [0, 1] of each prompt's tokens served
        # from the warm (fleet-wide) prefix cache: discounts FLT002's
        # prefill demand and SRV002's per-sequence block pressure so
        # capacity planning matches a warm fleet instead of pricing
        # every admission as a full prefill. Honored only when
        # serving { prefix_cache { enabled } } — a declared hit rate
        # with the cache off is wishful and is ignored.
        "prefix_hit_rate": Field("float", 0.0),
    }


class FleetPeerConfig(Message):
    """One host of a disaggregated serving fleet (serve/fleet/): its
    mailbox name and concrete role. Listed in RANK ORDER — entry k is
    the host ``-procsID k`` launches as, the reference's hostfile
    pattern (src/utils/cluster.cc:18-24)."""

    FIELDS = {
        "name": Field("string", required=True),
        "role": Field("enum", "unified", enum=FLEET_PEER_ROLES),
        # the host's "host:port" endpoint under `transport: socket`
        # (comm/wire.py; required there — netlint WIR001); the mailbox
        # transport needs only the shared root and ignores it
        "address": Field("string", ""),
    }


FLEET_TRANSPORTS = ("mailbox", "socket")


class WireConfig(Message):
    """singa-tpu extension: the socket transport's wire discipline
    (comm/wire.py) — send/connect deadlines, the bounded exponential
    reconnect backoff, and the peer-liveness window the host watchdog
    tombstones on. Only read under ``fleet { transport: socket }``;
    every field has a serving-safe default, so an empty block works."""

    FIELDS = {
        # TCP connect deadline per attempt
        "connect_timeout_s": Field("float", 2.0),
        # one attempt's transmit+ack deadline; a max-size migration
        # message must fit in it (retries re-send from scratch —
        # netlint WIR001 checks this against link_bandwidth)
        "send_timeout_s": Field("float", 5.0),
        # redelivery attempts after the first (0 = single attempt)
        "max_retries": Field("int", 4),
        # exponential backoff base between attempts ...
        "backoff_s": Field("float", 0.05),
        # ... capped here (no hot reconnect loop)
        "backoff_cap_s": Field("float", 2.0),
        # > 0: a peer we HAVE heard from that goes silent this long is
        # reported dead (peer_death tombstone); 0 = only exhausted
        # sends tombstone
        "liveness_timeout_s": Field("float", 0.0),
        # the front door's "host:port" endpoint — finished streams
        # report there (host.py results_to), so socket fleets need it
        "frontdoor_address": Field("string", ""),
        # modeled link bandwidth for WIR001's can-one-attempt-ever-
        # deliver check; 0 disables the check
        "link_bandwidth_bytes_per_s": Field("float", 1e9),
    }


class RolloutConfig(Message):
    """singa-tpu extension: live weight rollout into a RUNNING fleet
    (serve/rollout.py) — the controller stages next-version params
    alongside the live ones on every host (dual-resident until the
    flip; netlint ROL001 prices the extra HBM), canaries ONE
    decode-capable host, verifies stream parity on replayed probe
    traffic, then promotes host-by-host; a parity mismatch rolls the
    whole fleet back to the pinned current version."""

    FIELDS = {
        # next-version weights: an npz save, a sharded checkpoint dir,
        # or a retention folder (its newest complete save wins) —
        # restored through resilience/reshard.load_serving_params, so
        # ANY saved topology stages onto ANY serving host
        "checkpoint": Field("string", ""),
        # version tag the flip installs; 0 = derive from the save's
        # step (a rollout must always move to a NEW, nonzero version)
        "version": Field("int", 0),
        # the decode-capable host canaried first ("" = the first
        # decode-capable peer in rank order)
        "canary": Field("string", ""),
        # replayed probe streams the canary parity check verifies
        # against a reference engine on the staged weights
        "parity_probes": Field("int", 4),
        # tokens each probe stream decodes
        "probe_tokens": Field("int", 8),
        # per-host deadline for a stage/flip/probe acknowledgment
        # before the rollout declares the host dead and PAUSES
        "stage_timeout_s": Field("float", 30.0),
        # CRC-rejected weight ships retried this many times before the
        # version is quarantined (serving stays on current throughout)
        "ship_retries": Field("int", 2),
    }


class FleetConfig(Message):
    """singa-tpu extension: the disaggregated serving fleet
    (singa_tpu/serve/fleet/) — the serving-scale analog of the
    reference's rank-picks-role Worker/Server split (src/main.cc:49-55).
    Presence of this block routes ``singa_tpu.main`` to a fleet host
    instead of the trainer: ``role`` pins this host's role, or
    ``auto`` (default) assigns it by rank — ranks below
    ``prefill_hosts`` run admission + chunked prefill only and hand
    filled sequences to decode ranks over the paged-KV block-migration
    path; decode ranks run the fixed-shape decode tick only. Explicit
    ``peers`` entries name the whole fleet in rank order (else
    ``nworkers`` synthetic hosts). ``mailbox`` roots the filesystem
    transport (default ``<workspace>/fleet``)."""

    FIELDS = {
        # this host's role; "auto" = the rank-picks-role dispatch
        "role": Field("enum", "auto", enum=FLEET_ROLES),
        # the fleet topology in rank order (absent = synthetic names
        # with auto roles over the cluster's nworkers)
        "peers": Field("message", repeated=True, message=FleetPeerConfig),
        # with role auto: ranks [0, prefill_hosts) prefill, the rest
        # decode
        "prefill_hosts": Field("int", 1),
        # shared mailbox-transport root ("" = <workspace>/fleet)
        "mailbox": Field("string", ""),
        # the cross-process wiring: "mailbox" (filesystem, the
        # deterministic CI drill transport) or "socket" (comm/wire.py
        # TCP — the production path; peers need address fields and the
        # wire block's frontdoor_address, netlint WIR001)
        "transport": Field("enum", "mailbox", enum=FLEET_TRANSPORTS),
        # socket-transport deadlines/backoff/liveness (absent = the
        # WireConfig defaults)
        "wire": Field("message", message=WireConfig),
        # --- elastic fleet sizing (serve/fleet/host.py): the topology
        # (peers / nworkers) declares up to max_hosts ranks, but only
        # ranks [0, min_hosts) must be live at launch — the rest are
        # LATENT: declared, excluded from every placement decision
        # until they JOIN by publishing a serving status through the
        # transport (at which point prefill hosts start exporting to
        # them and the router sees their occupancy). Scale-down is the
        # drain-to-peer path (tombstone). 0 = the whole topology is
        # live at launch (the fixed fleet; today's behavior). ---
        "min_hosts": Field("int", 0),
        "max_hosts": Field("int", 0),
        # offered-load model for the cost-aware shardlint's per-role
        # fleet sizing (FLT002); absent = no declared load, rule skipped
        "load": Field("message", message=FleetLoadConfig),
        # live weight rollout: canaried, health-gated hot-swap of a
        # next-version checkpoint into the running fleet
        # (serve/rollout.py; netlint ROL001 checks feasibility)
        "rollout": Field("message", message=RolloutConfig),
    }


KERNEL_IMPLS = ("reference", "fused")
GRAD_ALLREDUCE_IMPLS = ("reference", "quantized_ring", "q8_hier")


class RingConfig(Message):
    """singa-tpu extension: two-level ring geometry for
    ``kernels { grad_allreduce: q8_hier }`` (the EQuARX deployment
    topology, arxiv 2506.17615 — fast intra-slice ICI feeding one
    scarce inter-slice DCN hop). Two mutually exclusive forms:

    - factored data axis: ``intra_degree: K`` splits the single
      ``data`` axis of width n into n/K groups of K adjacent ranks —
      the intra rings run over each K-block, the quantized inter ring
      over same-position ranks across blocks.
    - named axes: ``intra_axis`` / ``inter_axis`` name two real mesh
      axes (e.g. ``data`` × ``model``) and the reduction runs over
      their product, int8 only on the inter_axis hops.
    """

    FIELDS = {
        # mesh axis for the fast (full-precision) intra-slice rings
        "intra_axis": Field("string", ""),
        # mesh axis for the scarce (quantized) inter-slice ring
        "inter_axis": Field("string", ""),
        # factored form: group width K carved out of the data axis
        # (must divide it); 0 = use the named-axes form above
        "intra_degree": Field("int", 0),
    }


class KernelsConfig(Message):
    """singa-tpu extension: per-site kernel implementation selection
    (the Pallas hot-path seam, singa_tpu/ops/paged_attention.py +
    singa_tpu/ops/quantized_collective.py).

    ``paged_attention: fused`` swaps the serving engine's attention —
    every decode tick, prefill chunk, and speculative verify pass —
    from the reference gather -> ``cache_attend`` path onto a Pallas
    kernel that reads K/V blocks IN PLACE through the block table
    (flash-attention online-softmax tiling over block-granular K/V, no
    dense ``(slots, heads, cache_len, head_dim)`` materialization per
    layer). Output is allclose to the reference (online softmax
    reorders the reduction); greedy token streams are identical.
    ``reference`` (default, = no block) keeps the bitwise-pinned
    oracle path untouched. ``interpret`` (default true) runs the
    kernel through the Pallas interpreter (or, for the ring, the
    pure-ppermute XLA form) — plain XLA ops, CPU-safe and
    GSPMD-shardable, what CI exercises — set false on a real TPU
    to compile through Mosaic, which constrains the geometry
    (kv_block_len a multiple of 8, head_dim a multiple of 128; the
    engine rejects violations at construction, netlint KRN001 flags
    them statically).

    ``grad_allreduce: quantized_ring`` swaps the trainer's data-axis
    gradient collective — the ``grad_comm { mode: quantized }``
    numerics, whose cast sits AROUND the GSPMD psum so the wire stays
    fp32 — onto an explicit ring reduce-scatter + allgather whose
    ppermute'd wire value is genuinely int8 (per-bucket f32 scale
    riding alongside; ops/quantized_collective.py). Requires an active
    quantized ``grad_comm`` block, composes with ``zero_update`` (the
    ring's scatter output IS the update layout — the allgather phase
    is skipped) and ``error_feedback``; the replica engine rejects it
    (netlint KRN002 flags both statically, plus un-chunkable data-axis
    geometry). ``reference`` keeps the dequantize-then-psum oracle —
    jaxpr-identical to a config with no knob.

    ``grad_allreduce: q8_hier`` is the hierarchical two-level form
    (EQuARX's deployment topology): full-precision intra-slice ring
    reduce-scatter over the fast axis, ONE int8 inter-slice ring over
    group leaders (the quantization lands where bandwidth is
    scarcest), then the intra-slice allgather. Geometry comes from the
    model conf's ``ring {}`` block (``intra_degree`` to factor the
    data axis, or ``intra_axis``/``inter_axis`` to name two mesh
    axes); unlike the flat ring it accepts composed meshes whose
    non-data axes the factorization covers."""

    FIELDS = {
        # serving-tier attention: "reference" gather + cache_attend
        # oracle, "fused" Pallas paged-attention kernel
        "paged_attention": Field("enum", "reference", enum=KERNEL_IMPLS),
        # training-tier gradient collective: "reference" = grad_comm's
        # quantize-around-the-psum oracle (fp32 on the wire),
        # "quantized_ring" = int8-on-the-wire ppermute ring
        # "q8_hier" = hierarchical two-level ring (f32 intra-slice,
        # int8 inter-slice; geometry from the model's ring {} block)
        "grad_allreduce": Field(
            "enum", "reference", enum=GRAD_ALLREDUCE_IMPLS
        ),
        # run the fused kernel in the Pallas interpreter / the ring in
        # its pure-XLA ppermute form (CPU-safe); false = compile the
        # inner kernels through Mosaic (TPU, geometry-gated)
        "interpret": Field("bool", True),
    }


class TelemetryConfig(Message):
    """singa-tpu extension: the flight-recorder telemetry plane
    (singa_tpu/obs/). Always-on by default — a job with a workspace
    writes per-rank JSONL event logs to ``<workspace>/events/`` with
    zero added per-step device syncs (events buffer in memory and flush
    at display-cadence boundaries). ``tools/trace.py`` merges the
    per-rank logs into one Perfetto-loadable trace.json. The reference
    had only the Worker display line (src/worker/worker.cc:350-386);
    this block is its post-mortem-grade replacement."""

    FIELDS = {
        # master switch: false silences the event log, span recording,
        # and the profile@K trigger (the display line is unaffected)
        "enabled": Field("bool", True),
        # record every timed phase occurrence (train/data/eval/ckpt,
        # feeder/stager threads, async-ckpt writer, coord barriers) as a
        # span — the Chrome-trace tracks. false = lifecycle events only.
        "trace_spans": Field("bool", True),
        # per-rank event logs land in <workspace>/<events_subfolder>/
        "events_subfolder": Field("string", "events"),
        # jax.profiler traces from profile@K triggers land in
        # <workspace>/<profile_subfolder>/
        "profile_subfolder": Field("string", "xprof"),
    }


class ModelConfig(Message):
    FIELDS = {
        "name": Field("string"),
        "train_folder": Field("string", "train"),
        "test_folder": Field("string", "test"),
        "validation_folder": Field("string", "validation"),
        "display_after_steps": Field("int", 0),
        "display_frequency": Field("int", 0),
        "validation_after_steps": Field("int", 0),
        "validation_frequency": Field("int", 0),
        "test_after_steps": Field("int", 0),
        "test_frequency": Field("int", 0),
        "prefetch": Field("bool", True),
        "train_steps": Field("int"),
        "validation_steps": Field("int"),
        "test_steps": Field("int"),
        "step": Field("int", 0),
        "updater": Field("message", message=UpdaterConfig),
        "alg": Field("enum", "kBackPropagation", enum=GRAD_CALC_ALGS),
        "neuralnet": Field("message", message=NetConfig),
        "debug": Field("bool", False),
        # --- singa-tpu extensions: checkpoint restore path + save cadence
        # (fills the reference's unimplemented Worker::Resume,
        # worker.cc:65-67; the reference has no snapshot cadence at all) ---
        "checkpoint": Field("string"),
        "checkpoint_frequency": Field("int", 0),
        "checkpoint_after_steps": Field("int", 0),
        # "npz": one gathered file (small models); "sharded": per-process
        # shard files, arrays stay device-sharded end to end (pods) —
        # restore auto-detects the format from the path
        "checkpoint_format": Field("enum", "npz", enum=("npz", "sharded")),
        # --- singa-tpu extension: ZeRO-style cross-replica update
        # sharding (arxiv 2004.13336; parallel/shardings.py
        # zero_update_shardings). true = reduce-scatter grads to
        # per-rank shards over the data axis, run the optimizer on each
        # rank's shard only (updater slots live sharded, shrinking
        # per-device opt-state bytes by the data-parallel degree), and
        # allgather fresh params for the next forward. Loss-identical
        # to the replicated update (the math between the collectives is
        # elementwise); false = the reference's replicated update. ---
        "zero_update": Field("bool", False),
        # --- singa-tpu extension: quantized + overlapped gradient
        # collectives (parallel/collectives.py; see GradCommConfig).
        # Absent = the exact fp32 gradient collective. ---
        "grad_comm": Field("message", message=GradCommConfig),
        # --- singa-tpu extension: mixed-precision compute. Params stay
        # fp32 (master copies, updater math in fp32); forward/backward
        # matmuls run in this dtype so the MXU sees bf16. "" = fp32. ---
        "compute_dtype": Field("string", ""),
        # --- singa-tpu extension: microbatches per step for pipeline
        # parallelism (layers staged by locationid over the cluster's
        # pipe axis). 0 = the pipe width (the GPipe minimum); more
        # microbatches shrink the fill/drain bubble. ---
        "pipeline_microbatches": Field("int", 0),
        # --- singa-tpu extension: fault-tolerance runtime (supervised
        # auto-resume, preemption drain, divergence guard, watchdog) ---
        "resilience": Field("message", message=ResilienceConfig),
        # --- singa-tpu extension: flight-recorder telemetry plane
        # (singa_tpu/obs/). Absent = enabled with defaults ---
        "telemetry": Field("message", message=TelemetryConfig),
        # --- singa-tpu extension: serving tier (singa_tpu/serve/) —
        # continuous-batching inference with a paged KV cache. Absent =
        # serving defaults (tools/serve_bench.py, tools/generate.py) ---
        "serving": Field("message", message=ServingConfig),
        # --- singa-tpu extension: per-site kernel selection (Pallas
        # hot paths, singa_tpu/ops/paged_attention.py). Absent = every
        # site runs its reference oracle path ---
        "kernels": Field("message", message=KernelsConfig),
        # --- singa-tpu extension: disaggregated serving fleet
        # (singa_tpu/serve/fleet/) — presence dispatches main.py to a
        # fleet host (role by rank) instead of the trainer ---
        "fleet": Field("message", message=FleetConfig),
        # --- singa-tpu extension: two-level ring geometry for
        # kernels { grad_allreduce: q8_hier } (see RingConfig). Absent
        # with q8_hier = ConfigError at trainer construction. ---
        "ring": Field("message", message=RingConfig),
    }


class ClusterConfig(Message):
    FIELDS = {
        "nworkers": Field("int"),
        "nservers": Field("int", 0),
        "start_port": Field("int", 6723),
        "nprocs_per_group": Field("int", 1),
        "nthreads_per_procs": Field("int", 1),
        "nthreads_per_server": Field("int", 1),
        "workspace": Field("string", required=True),
        "vis_subfolder": Field("string", "vis"),
        "log_subfolder": Field("string", "log"),
        "synchronous": Field("bool", False),
        "largest_message": Field("int", 1048576),
        "bandwidth": Field("float", 100.0),
        # ---- singa-tpu extensions: how nprocs_per_group splits across
        # the intra-group parallelism axes. The reference's only
        # intra-group axis is kLayerPartition (tensor/model); sequence
        # (ring attention), expert (kMoE), and pipeline (locationid
        # stages) are new. model width = nprocs_per_group /
        # (nseq * nexperts * npipes); must divide evenly.
        "nseq_per_group": Field("int", 1),
        "nexperts_per_group": Field("int", 1),
        "npipes_per_group": Field("int", 1),
        # ---- singa-tpu extension: persistent XLA compilation cache.
        # main.py wires jax's compile cache to this directory so repeat
        # runs skip recompilation (BENCH_r05 measured 60-135 ms of fixed
        # per-run startup, mostly XLA compiles). "" = default
        # <workspace>/compile_cache; "off" disables; the
        # SINGA_TPU_COMPILE_CACHE env var overrides either.
        "compile_cache_dir": Field("string", ""),
        # ---- singa-tpu extension: per-device HBM budget in bytes for
        # the cost-aware shardlint (lint/cost_model.py). When > 0,
        # netlint's MEM001 errors on any model conf whose predicted
        # per-device footprint (params + optimizer slots + residuals +
        # activation working set + serving KV pool) exceeds it — the
        # static mirror of the OOM the pod would hit. 0 (default) =
        # no declared budget, MEM001 stays silent.
        "device_hbm_bytes": Field("int", 0),
        # ---- singa-tpu extension: inter-slice (DCN) bandwidth in
        # bytes/sec for the cost-aware shardlint. When > 0 and the
        # model runs the hierarchical ring (q8_hier), --explain-cost
        # prices the scarce inter-slice hop's transfer time from the
        # per-level wire model. 0 (default) = no declared bandwidth.
        "inter_slice_bandwidth": Field("int", 0),
    }

    @property
    def axis_widths(self) -> dict[str, int]:
        """Mesh axis widths {data, pipe, expert, seq, model} implied by
        the topology fields. See parallel.mesh.mesh_from_cluster."""
        npg = max(1, self.nprocs_per_group)
        nseq = max(1, self.nseq_per_group)
        nexp = max(1, self.nexperts_per_group)
        npipe = max(1, self.npipes_per_group)
        inner = nseq * nexp * npipe
        if npg % inner:
            raise ConfigError(
                f"nprocs_per_group ({npg}) not divisible by nseq*nexperts*"
                f"npipes ({nseq}*{nexp}*{npipe}={inner})"
            )
        return {
            "data": self.ngroups,
            "pipe": npipe,
            "expert": nexp,
            "seq": nseq,
            "model": npg // inner,
        }

    @property
    def ngroups(self) -> int:
        """Number of worker groups = data-parallel replicas.

        Reference: include/utils/cluster.h:49-50 — workers are partitioned
        into groups of ``nprocs_per_group`` (plain integer division). A
        config with nworkers < nprocs_per_group would yield zero groups in
        the reference and silently do nothing; we reject it explicitly.
        """
        if not self.nworkers:
            return 1
        npg = max(1, self.nprocs_per_group)
        if self.nworkers < npg:
            raise ConfigError(
                f"nworkers ({self.nworkers}) < nprocs_per_group ({npg}): "
                "yields zero worker groups"
            )
        return self.nworkers // npg


def load_model_config(path: str) -> ModelConfig:
    return ModelConfig.from_file(path)


def load_cluster_config(path: str) -> ClusterConfig:
    return ClusterConfig.from_file(path)


def parse_model_config(text: str) -> ModelConfig:
    return ModelConfig.from_text(text)


def parse_cluster_config(text: str) -> ClusterConfig:
    return ClusterConfig.from_text(text)
