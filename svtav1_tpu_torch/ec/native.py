"""ctypes bindings of the native host code: the tile entropy coder of the
flat path (``native/tile_coder.c``; copy of ``svtav1_tpu/ec/native.py``
with its own copy of the C source beside it, which also writes each
block's luma angle delta, where the JAX package falls back to its Python
flat coder) and the decoder's
coefficient reader (``native/coeff_reader.c``, the loop of
``ec/coeffs.py::read_coeffs_txb``).  gcc builds each source at first use
into the git-ignored ``svtav1_tpu_torch/build/``, keyed by a hash of the
source and the flags (not by mtime, which a copy of the tree can reset).
A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from ..spec import tables as tbl
from ..utils import trace

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "tile_coder.c"
_READER_SRC = _PKG / "native" / "coeff_reader.c"
_BUILD_DIR = _PKG / "build"
_CFLAGS = ("-O3", "-fPIC", "-shared")

_u16p = ctypes.POINTER(ctypes.c_uint16)
_i16p = ctypes.POINTER(ctypes.c_int16)


class _Tables(ctypes.Structure):
    _fields_ = [(n, _u16p) for n in
                ("txb_skip", "eob_flag16", "eob_flag32", "eob_flag64",
                 "eob_flag128", "eob_flag256", "eob_flag512", "eob_flag1024",
                 "eob_extra", "coeff_base_eob", "coeff_base", "coeff_br",
                 "dc_sign", "partition", "skip", "kf_y", "uv_mode",
                 "angle_delta")] + [("scan32", _i16p), ("scan16", _i16p)]


_lib = None
_reader = None


def library_path(src: Path = _SRC, stem: str = "libtilecoder") -> Path:
    """Where the library built from the current source and flags lives."""
    h = hashlib.sha256(" ".join(_CFLAGS).encode())
    h.update(src.read_bytes())
    return _BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _build(src: Path, stem: str) -> ctypes.CDLL:
    with trace.span("setup.build", always=True):
        so = library_path(src, stem)
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            r = subprocess.run(["gcc", *_CFLAGS, "-o", str(tmp), str(src)],
                               capture_output=True, text=True)
            trace.count("build.gcc")
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"native build failed: {r.stderr[:500]}")
            os.replace(tmp, so)
        return ctypes.CDLL(str(so))


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = _build(_SRC, "libtilecoder")
    lib.encode_tile_intra.restype = ctypes.c_long
    lib.encode_tile_intra.argtypes = [
        np.ctypeslib.ndpointer(np.uint8), ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
        ctypes.POINTER(_Tables), ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
        ctypes.POINTER(ctypes.c_long)]
    _lib = lib
    return lib


def _load_reader():
    global _reader
    if _reader is None:
        lib = _build(_READER_SRC, "libcoeffreader")
        u16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        lib.read_coeffs.restype = ctypes.c_int
        lib.read_coeffs.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS"),
            u16, u16, u16, u16, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
        _reader = lib
    return _reader


def read_coeffs(dec, h: int, w: int, eob: int, tx_class: int, scan,
                base, br, eob_base, dc_sign, adapt: bool) -> np.ndarray:
    """The coefficient loop of read_coeffs_txb in C on `dec`'s state (a
    RangeDecoder, advanced in place) and the CDF rows base [42, 5], br [21,
    5], eob_base [4, 4] and dc_sign [3] (adapted in place when adapt):
    the block's [h, w] int32 levels.  Raises ValueError where the stream
    codes a level beyond int32."""
    lib = _load_reader()
    state = np.array([dec.bptr, dec.dif, dec.rng, dec.cnt], np.int64)
    out = np.zeros((h, w), np.int32)
    err = lib.read_coeffs(dec.data, len(dec.data), state, h, w, eob,
                          tx_class, scan, base, br, eob_base, dc_sign,
                          int(adapt), out)
    dec.bptr, dec.dif, dec.rng, dec.cnt = (int(v) for v in state)
    if err:
        raise ValueError("coefficient level beyond int32")
    return out


def encode_tile_intra(width: int, height: int, update_cdf: bool,
                      y_modes: np.ndarray, y_lev: np.ndarray,
                      u_lev: np.ndarray, v_lev: np.ndarray, cdf,
                      true_h: int = 0, uv_modes: np.ndarray = None,
                      y_deltas: np.ndarray = None) -> bytes:
    """cdf: spec.cdf.CdfContext (its tables are copied, not mutated).
    true_h: signaled frame height when `height` is the SB-padded plane
    height (0 → equal); bottom-edge geometry per encoder/geometry.py.
    uv_modes / y_deltas [bh, bw]: each block's uv_mode (None: DC) and
    luma angle delta (None: 0; written for the directional modes).  The
    symbols coded go to the ``coder.symbols`` counter (``utils.trace``)."""
    lib = _load()
    keep = []  # keep arrays alive

    def u16(arr):
        a = np.ascontiguousarray(arr, np.uint16).copy()
        keep.append(a)
        return a.ctypes.data_as(_u16p)

    def i16(arr):
        a = np.ascontiguousarray(arr, np.int16)
        keep.append(a)
        return a.ctypes.data_as(_i16p)

    t = _Tables(
        txb_skip=u16(cdf.txb_skip_cdf),
        eob_flag16=u16(cdf.eob_flag_cdf16),
        eob_flag32=u16(cdf.eob_flag_cdf32),
        eob_flag64=u16(cdf.eob_flag_cdf64),
        eob_flag128=u16(cdf.eob_flag_cdf128),
        eob_flag256=u16(cdf.eob_flag_cdf256),
        eob_flag512=u16(cdf.eob_flag_cdf512),
        eob_flag1024=u16(cdf.eob_flag_cdf1024),
        eob_extra=u16(cdf.eob_extra_cdf),
        coeff_base_eob=u16(cdf.coeff_base_eob_cdf),
        coeff_base=u16(cdf.coeff_base_cdf),
        coeff_br=u16(cdf.coeff_br_cdf),
        dc_sign=u16(cdf.dc_sign_cdf),
        partition=u16(cdf.partition_cdf),
        skip=u16(cdf.skip_cdfs),
        kf_y=u16(cdf.kf_y_cdf),
        uv_mode=u16(cdf.uv_mode_cdf),
        angle_delta=u16(cdf.angle_delta_cdf),
        scan32=i16(tbl.scan(3, 0)),
        scan16=i16(tbl.scan(2, 0)),
    )
    # not zeroed: the coder writes every byte it returns; zeroing the
    # buffer, or copying all of it back, holds the GIL for milliseconds a
    # 1080p frame, which the coder threads share with the thread that
    # queues the device work
    cap = width * height * 4 + (1 << 16)
    dst = np.empty(cap, np.uint8)
    zeros = np.zeros(np.shape(y_modes), np.int32)
    if uv_modes is None:
        uv_modes = zeros
    if y_deltas is None:
        y_deltas = zeros
    if np.abs(y_deltas).max(initial=0) > 3:
        raise ValueError("angle deltas lie in -3..3")
    nsym = ctypes.c_long(0)
    n = lib.encode_tile_intra(
        dst, cap, width, height, int(update_cdf),
        np.ascontiguousarray(y_modes, np.int32),
        np.ascontiguousarray(y_lev, np.int32),
        np.ascontiguousarray(u_lev, np.int32),
        np.ascontiguousarray(v_lev, np.int32), ctypes.byref(t),
        int(true_h), np.ascontiguousarray(uv_modes, np.int32),
        np.ascontiguousarray(y_deltas, np.int32), ctypes.byref(nsym))
    if n <= 0:
        raise RuntimeError("native tile coder failed")
    trace.count("coder.symbols", nsym.value)
    return dst[:n].tobytes()
