"""Job configuration: protobuf text-format parsing + typed schema.

Drop-in for the reference's proto config surface (src/proto/model.proto,
src/proto/cluster.proto, read via src/utils/common.cc:56-64) so existing
job files launch unchanged.
"""

from .schema import (
    ClusterConfig,
    ConfigError,
    LayerConfig,
    ModelConfig,
    NetConfig,
    ParamConfig,
    UpdaterConfig,
    load_cluster_config,
    load_model_config,
    parse_cluster_config,
    parse_model_config,
)
from .textproto import TextProtoError, parse, parse_file

__all__ = [
    "ClusterConfig",
    "ConfigError",
    "LayerConfig",
    "ModelConfig",
    "NetConfig",
    "ParamConfig",
    "UpdaterConfig",
    "TextProtoError",
    "load_cluster_config",
    "load_model_config",
    "parse_cluster_config",
    "parse_model_config",
    "parse",
    "parse_file",
]
