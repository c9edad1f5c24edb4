"""Y4M (YUV4MPEG2) reader and writer; copy of ``svtav1_tpu/utils/y4m.py``.

Frames are returned as numpy arrays: a tuple (y, u, v) with dtype uint8 (8-bit)
or uint16 (10-bit).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO, Iterator, Tuple

import numpy as np


@dataclass
class Y4mInfo:
    width: int
    height: int
    fps_num: int
    fps_den: int
    bit_depth: int = 8
    subsampling: str = "420"  # "420" | "422" | "444"
    interlace: str = "Ip"
    aspect: str = "A0:0"


_COLORSPACES = {
    "420": ("420", 8), "420jpeg": ("420", 8), "420mpeg2": ("420", 8),
    "420paldv": ("420", 8), "422": ("422", 8), "444": ("444", 8),
    "420p10": ("420", 10), "422p10": ("422", 10), "444p10": ("444", 10),
    "mono": ("mono", 8),
}


def _plane_shapes(info: Y4mInfo):
    w, h = info.width, info.height
    if info.subsampling == "420":
        return (h, w), ((h + 1) // 2, (w + 1) // 2)
    if info.subsampling == "422":
        return (h, w), (h, (w + 1) // 2)
    if info.subsampling == "444":
        return (h, w), (h, w)
    raise ValueError(info.subsampling)


class Y4mReader:
    def __init__(self, fp: BinaryIO):
        self._fp = fp
        header = bytearray()
        while True:
            c = fp.read(1)
            if not c or c == b"\n":
                break
            header += c
        fields = header.decode().split(" ")
        if fields[0] != "YUV4MPEG2":
            raise ValueError("not a y4m file")
        w = h = None
        fps_num, fps_den = 30, 1
        sub, depth = "420", 8
        interlace, aspect = "Ip", "A0:0"
        for f in fields[1:]:
            if not f:
                continue
            key, rest = f[0], f[1:]
            if key == "W":
                w = int(rest)
            elif key == "H":
                h = int(rest)
            elif key == "F":
                a, b = rest.split(":")
                fps_num, fps_den = int(a), int(b)
            elif key == "C":
                sub, depth = _COLORSPACES[rest]
            elif key == "I":
                interlace = f
            elif key == "A":
                aspect = f
        self.info = Y4mInfo(w, h, fps_num, fps_den, depth, sub, interlace, aspect)

    def frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        info = self.info
        yshape, cshape = _plane_shapes(info)
        dtype = np.uint8 if info.bit_depth == 8 else np.uint16
        itemsize = 1 if info.bit_depth == 8 else 2
        ysize = yshape[0] * yshape[1] * itemsize
        csize = cshape[0] * cshape[1] * itemsize
        while True:
            line = bytearray()
            while True:
                c = self._fp.read(1)
                if not c:
                    return
                if c == b"\n":
                    break
                line += c
            if not line.startswith(b"FRAME"):
                raise ValueError(f"bad frame marker: {bytes(line)!r}")
            y = np.frombuffer(self._fp.read(ysize), dtype).reshape(yshape)
            u = np.frombuffer(self._fp.read(csize), dtype).reshape(cshape)
            v = np.frombuffer(self._fp.read(csize), dtype).reshape(cshape)
            yield y, u, v


class Y4mWriter:
    def __init__(self, fp: BinaryIO, info: Y4mInfo):
        self._fp = fp
        self.info = info
        cs = {8: info.subsampling,
              10: info.subsampling + "p10"}[info.bit_depth]
        if cs == "420":
            cs = "420jpeg"
        fp.write(f"YUV4MPEG2 W{info.width} H{info.height} "
                 f"F{info.fps_num}:{info.fps_den} {info.interlace} "
                 f"{info.aspect} C{cs}\n".encode())

    def write_frame(self, y: np.ndarray, u: np.ndarray,
                    v: np.ndarray) -> None:
        self._fp.write(b"FRAME\n")
        for plane in (y, u, v):
            self._fp.write(np.ascontiguousarray(plane).tobytes())
