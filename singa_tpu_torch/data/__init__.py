"""Data subsystem of the port: record codec and shard files (copies of
the JAX package's), token datasets and the batch pipeline."""

from .pipeline import BatchPipeline, load_shard_arrays
from .records import ImageRecord, decode_record, encode_record
from .shard import ShardReader, ShardWriter

__all__ = [
    "ImageRecord",
    "decode_record",
    "encode_record",
    "ShardReader",
    "ShardWriter",
    "BatchPipeline",
    "load_shard_arrays",
]
