"""IVF container writer and reader; copy of ``svtav1_tpu/utils/ivf.py``."""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator, Tuple

IVF_FOURCC = b"AV01"


class IvfWriter:
    def __init__(self, fp: BinaryIO, width: int, height: int,
                 timebase_num: int = 1, timebase_den: int = 30):
        self._fp = fp
        self._frame_count = 0
        self._header_pos = fp.tell()
        fp.write(struct.pack(
            "<4sHH4sHHIII4x",
            b"DKIF", 0, 32, IVF_FOURCC,
            width, height, timebase_den, timebase_num, 0))

    def write_frame(self, payload: bytes, pts: int) -> None:
        self._fp.write(struct.pack("<IQ", len(payload), pts))
        self._fp.write(payload)
        self._frame_count += 1

    def finalize(self) -> None:
        end = self._fp.tell()
        self._fp.seek(self._header_pos + 24)
        self._fp.write(struct.pack("<I", self._frame_count))
        self._fp.seek(end)
        self._fp.flush()


def read_ivf(fp: BinaryIO) -> Tuple[dict, Iterator[Tuple[bytes, int]]]:
    hdr = fp.read(32)
    magic, version, hdr_size, fourcc, w, h, tb_den, tb_num, nframes = (
        struct.unpack("<4sHH4sHHIII", hdr[:28]))
    if magic != b"DKIF":
        raise ValueError("not an IVF file")
    info = dict(fourcc=fourcc, width=w, height=h,
                timebase_num=tb_num, timebase_den=tb_den, frame_count=nframes)

    def frames():
        while True:
            fh = fp.read(12)
            if len(fh) < 12:
                return
            size, pts = struct.unpack("<IQ", fh)
            yield fp.read(size), pts

    return info, frames()
