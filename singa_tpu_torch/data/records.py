"""Protobuf wire-format codec for dataset records (no protobuf dependency).

The reference stores each sample as a binary-serialized ``Record`` proto
inside shard.dat (src/utils/shard.cc:43-47). For byte compatibility with
shards written by the reference's loader, this module hand-implements the
proto2 wire format for exactly these messages (src/proto/model.proto:279-305):

    message Record { optional Type type=1; optional SingleLabelImageRecord image=2; }
    message SingleLabelImageRecord {
      repeated int32 shape=1; optional int32 label=2;
      optional bytes pixel=3; repeated float data=4;
    }

The encoder writes canonical proto2 (unpacked repeated fields, ascending
field order); the decoder additionally accepts packed repeated encodings and
unknown fields, like any conforming proto2 reader.
"""

from __future__ import annotations

import dataclasses
import struct


class RecordError(ValueError):
    pass


RECORD_TYPE_SINGLE_LABEL_IMAGE = 0


@dataclasses.dataclass
class ImageRecord:
    """Decoded Record(kSingleLabelImage): the payload of one sample."""

    shape: list[int] = dataclasses.field(default_factory=list)
    label: int = 0
    pixel: bytes = b""  # raw uint8 pixels (exclusive with `data`)
    data: list[float] = dataclasses.field(default_factory=list)


# ---------------------------- varint / tags ----------------------------


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value += 1 << 64  # proto2 int32: negatives as 10-byte two's complement
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise RecordError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 64:
            raise RecordError("varint too long")


def _int32(value: int) -> int:
    value &= (1 << 64) - 1
    if value >= 1 << 63:
        value -= 1 << 64
    return int(value)


def _read_f32s(buf: bytes, pos: int, count: int) -> tuple[tuple, int]:
    """Bounds-checked little-endian float reads: a truncated buffer must
    raise RecordError, never leak struct.error (fuzz-pinned)."""
    end = pos + 4 * count
    if end > len(buf):
        raise RecordError("truncated float field")
    return struct.unpack_from(f"<{count}f", buf, pos), end


def _read_bytes(buf: bytes, pos: int, ln: int) -> tuple[bytes, int]:
    end = pos + ln
    if end > len(buf):
        raise RecordError("truncated bytes field")
    return buf[pos:end], end


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        ln, pos = _read_varint(buf, pos)
        pos += ln
    elif wire_type == 5:
        pos += 4
    else:
        raise RecordError(f"unsupported wire type {wire_type}")
    if pos > len(buf):
        raise RecordError("truncated field")
    return pos


# ---------------------------- encode ----------------------------


def _encode_image(rec: ImageRecord) -> bytes:
    out = bytearray()
    for s in rec.shape:
        out.append(0x08)  # field 1, varint
        _write_varint(out, s)
    out.append(0x10)  # field 2, varint
    _write_varint(out, rec.label)
    if rec.pixel:
        out.append(0x1A)  # field 3, bytes
        _write_varint(out, len(rec.pixel))
        out.extend(rec.pixel)
    for f in rec.data:
        out.append(0x25)  # field 4, fixed32
        out.extend(struct.pack("<f", f))
    return bytes(out)


def encode_record(rec: ImageRecord) -> bytes:
    """Serialize Record{type=kSingleLabelImage, image=rec} to proto2 bytes."""
    img = _encode_image(rec)
    out = bytearray()
    out.append(0x08)  # Record.type, field 1 varint
    _write_varint(out, RECORD_TYPE_SINGLE_LABEL_IMAGE)
    out.append(0x12)  # Record.image, field 2 length-delimited
    _write_varint(out, len(img))
    out.extend(img)
    return bytes(out)


# ---------------------------- decode ----------------------------


def _decode_image(buf: bytes) -> ImageRecord:
    rec = ImageRecord()
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 0:
            v, pos = _read_varint(buf, pos)
            rec.shape.append(_int32(v))
        elif field == 1 and wt == 2:  # packed repeated int32
            ln, pos = _read_varint(buf, pos)
            end = pos + ln
            if end > len(buf):
                raise RecordError("truncated packed field")
            while pos < end:
                v, pos = _read_varint(buf, pos)
                rec.shape.append(_int32(v))
            if pos != end:  # a varint straddled the declared boundary
                raise RecordError("malformed packed field")
        elif field == 2 and wt == 0:
            v, pos = _read_varint(buf, pos)
            rec.label = _int32(v)
        elif field == 3 and wt == 2:
            ln, pos = _read_varint(buf, pos)
            rec.pixel, pos = _read_bytes(buf, pos, ln)
        elif field == 4 and wt == 5:
            vals, pos = _read_f32s(buf, pos, 1)
            rec.data.append(vals[0])
        elif field == 4 and wt == 2:  # packed repeated float
            ln, pos = _read_varint(buf, pos)
            if ln % 4:
                raise RecordError("bad packed float length")
            vals, pos = _read_f32s(buf, pos, ln // 4)
            rec.data.extend(vals)
        else:
            pos = _skip_field(buf, pos, wt)
    return rec


@dataclasses.dataclass
class Datum:
    """Caffe's LMDB record message (the reference converts it to a
    SingleLabelImageRecord in LMDBDataLayer, layer.cc:306-328):

        message Datum { optional int32 channels=1; optional int32 height=2;
          optional int32 width=3; optional bytes data=4; optional int32
          label=5; repeated float float_data=6; optional bool encoded=7; }
    """

    channels: int = 0
    height: int = 0
    width: int = 0
    data: bytes = b""
    label: int = 0
    float_data: list[float] = dataclasses.field(default_factory=list)
    encoded: bool = False


def encode_datum(d: Datum) -> bytes:
    out = bytearray()
    for field, v in ((1, d.channels), (2, d.height), (3, d.width)):
        out.append(field << 3)
        _write_varint(out, v)
    if d.data:
        out.append(0x22)  # field 4, bytes
        _write_varint(out, len(d.data))
        out.extend(d.data)
    out.append(0x28)  # field 5, varint
    _write_varint(out, d.label)
    for f in d.float_data:
        out.append(0x35)  # field 6, fixed32
        out.extend(struct.pack("<f", f))
    if d.encoded:
        out.extend((0x38, 1))
    return bytes(out)


def decode_datum(buf: bytes) -> Datum:
    d = Datum()
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if field in (1, 2, 3, 5, 7) and wt == 0:
            v, pos = _read_varint(buf, pos)
            v = _int32(v)
            if field == 1:
                d.channels = v
            elif field == 2:
                d.height = v
            elif field == 3:
                d.width = v
            elif field == 5:
                d.label = v
            else:
                d.encoded = bool(v)
        elif field == 4 and wt == 2:
            ln, pos = _read_varint(buf, pos)
            d.data, pos = _read_bytes(buf, pos, ln)
        elif field == 6 and wt == 5:
            vals, pos = _read_f32s(buf, pos, 1)
            d.float_data.append(vals[0])
        elif field == 6 and wt == 2:  # packed repeated float
            ln, pos = _read_varint(buf, pos)
            if ln % 4:
                raise RecordError("bad packed float length")
            vals, pos = _read_f32s(buf, pos, ln // 4)
            d.float_data.extend(vals)
        else:
            pos = _skip_field(buf, pos, wt)
    return d


def datum_to_image_record(d: Datum) -> ImageRecord:
    """The reference's Datum -> SingleLabelImageRecord conversion
    (layer.cc:306-328): shape=(C,H,W); raw uint8 ``data`` xor float_data."""
    if d.encoded:
        raise RecordError(
            "encoded (compressed) Datum payloads are unsupported; "
            "re-export the database with raw pixels"
        )
    return ImageRecord(
        shape=[d.channels, d.height, d.width],
        label=d.label,
        pixel=d.data,
        data=list(d.float_data),
    )


def decode_record(buf: bytes) -> ImageRecord:
    """Parse a serialized Record; returns its SingleLabelImageRecord."""
    rtype = RECORD_TYPE_SINGLE_LABEL_IMAGE
    image: ImageRecord | None = None
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 0:
            rtype, pos = _read_varint(buf, pos)
        elif field == 2 and wt == 2:
            ln, pos = _read_varint(buf, pos)
            sub, pos = _read_bytes(buf, pos, ln)
            image = _decode_image(sub)
        else:
            pos = _skip_field(buf, pos, wt)
    if rtype != RECORD_TYPE_SINGLE_LABEL_IMAGE:
        raise RecordError(f"unsupported Record.type {rtype}")
    if image is None:
        raise RecordError("Record has no image payload")
    return image
