"""OBU framing (AV1 spec §5.3); copy of ``svtav1_tpu/utils/obu.py``."""

from __future__ import annotations

from .bitio import leb128_decode, leb128_encode

OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME_HEADER = 3
OBU_TILE_GROUP = 4
OBU_METADATA = 5
OBU_FRAME = 6


def wrap_obu(obu_type: int, payload: bytes) -> bytes:
    """OBU header (has_size_field=1, no extension) + leb128 size +
    payload."""
    return bytes([(obu_type << 3) | 0x02]) + leb128_encode(len(payload)) + \
        payload


def parse_obus(data: bytes):
    """Yield (obu_type, temporal_id, spatial_id, payload) for each OBU."""
    pos = 0
    while pos < len(data):
        byte = data[pos]
        if byte & 0x80:
            raise ValueError("obu_forbidden_bit set")
        obu_type = (byte >> 3) & 0xF
        ext = (byte >> 2) & 1
        has_size = (byte >> 1) & 1
        pos += 1
        tid = sid = 0
        if ext:
            tid = data[pos] >> 5
            sid = (data[pos] >> 3) & 3
            pos += 1
        if has_size:
            size, pos = leb128_decode(data, pos)
        else:
            size = len(data) - pos
        yield obu_type, tid, sid, data[pos:pos + size]
        pos += size
