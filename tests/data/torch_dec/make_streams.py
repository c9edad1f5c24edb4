"""Write the decoder fixtures: small IVF streams that only the JAX encoder
makes (compound pyramid, two tile columns, 10-bit, angle deltas), and
``md5.json`` with the per-frame MD5s of the JAX encoder's recons in
display order.

    JAX_PLATFORMS=cpu python tests/data/torch_dec/make_streams.py [NAME ...]

Run by hand from the repo root; NAMEs (default: all of STREAMS) pick the
streams to write, and their entries are merged into ``md5.json``.  Each
configuration compiles its own JAX scans: 5-30 minutes a stream on a CPU
(the angle-delta key frame the longest).  Every stream is checked before
it is written: the JAX ``Decoder`` must give the encoder's recons, and
each stream must carry the syntax it is kept for.
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from svtav1_tpu.decoder import decoder as jdec  # noqa: E402
from svtav1_tpu.ec import inter_modes as JIM  # noqa: E402
from svtav1_tpu.encoder.intra_encoder import (EncoderConfig,  # noqa: E402
                                              IntraEncoder)
from svtav1_tpu.encoder.presets import apply_preset  # noqa: E402
from svtav1_tpu.encoder.video_encoder import VideoEncoder  # noqa: E402
from svtav1_tpu.utils.ivf import IvfWriter  # noqa: E402


def moving_clip(w, h, n, seed):
    """tests/test_e2e_inter.py::_moving_clip."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = np.clip(110 + 70 * np.sin((xx + 5 * t) / 19.0) +
                    50 * np.cos((yy + 3 * t) / 13.0) +
                    rng.randint(-3, 4, (h, w)), 0, 255).astype(np.uint8)
        u = np.clip(120 + 40 * np.sin((xx[::2, ::2] + 2 * t) / 23.0),
                    0, 255).astype(np.uint8)
        v = np.clip(135 + 35 * np.cos((yy[::2, ::2] + t) / 27.0),
                    0, 255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def tile_clip(w, h, n, seed=5):
    """tests/test_tiles.py::_clip."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = np.clip(120 + 70 * np.sin((xx + yy + 5 * t) / 9.0) +
                    (rng.randint(-40, 41, (h, w)) * ((xx // 32) % 2)), 0,
                    255).astype(np.uint8)
        u = np.clip(120 + 30 * np.sin((xx[::2, ::2] + 2 * t) / 30.0), 0,
                    255).astype(np.uint8)
        v = np.clip(130 + 30 * np.cos((yy[::2, ::2] + t) / 20.0), 0,
                    255).astype(np.uint8)
        out.append((y, u, v))
    return out


def frame_md5(planes, bd):
    dt = np.uint8 if bd == 8 else np.uint16
    m = hashlib.md5()
    for p in planes:
        m.update(np.asarray(p).astype(dt).tobytes())
    return m.hexdigest()


def compound_pyramid():
    """As test_e2e_pyramid.py::test_pyramid_compound_roundtrip_own_decoder:
    128x64, 6 frames, q150, seed 4."""
    enc = VideoEncoder(EncoderConfig(128, 64, qindex=150), keyint=64,
                       pyramid=True)
    payloads, recons = enc.encode_frames(moving_clip(128, 64, 6, seed=4))
    p, r = enc.flush()
    return payloads + p, recons + r, 8


def two_tiles():
    """As test_tiles.py::test_two_tile_roundtrip_and_dav1d: 256x64, 2
    frames, two tile columns."""
    enc = VideoEncoder(EncoderConfig(256, 64, qindex=100, tile_cols=2),
                       keyint=64)
    out = [enc.encode_frame(*f) for f in tile_clip(256, 64, 2)]
    return [p for p, _ in out], [r for _, r in out], 8


def ten_bit():
    """As test_decoder.py::test_roundtrip_own_decoder_10bit: a 128x64
    10-bit key frame of random planes, seed 7, q120."""
    rng = np.random.RandomState(7)
    y = rng.randint(0, 1024, (64, 128)).astype(np.uint16)
    u = rng.randint(0, 1024, (32, 64)).astype(np.uint16)
    v = rng.randint(0, 1024, (32, 64)).astype(np.uint16)
    enc = IntraEncoder(EncoderConfig(128, 64, qindex=120, bit_depth=10))
    payload, rec = enc.encode_frame(y, u, v)
    return [payload], [rec], 10


def stripes(w, h, deg, seed=0):
    """Luma stripes constant along the direction deg (degrees from the
    x axis, y up), period 9 px, with +-3 of noise; flat-ish chroma."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    t = np.deg2rad(deg)
    phase = (xx * np.sin(t) + yy * np.cos(t)) * 2 * np.pi / 9.0
    y = np.clip(128 + 90 * np.sin(phase) + rng.randint(-3, 4, (h, w)), 0,
                255).astype(np.uint8)
    u = np.full((h // 2, w // 2), 120, np.uint8)
    v = np.full((h // 2, w // 2), 136, np.uint8)
    return y, u, v


def angle_deltas():
    """A 128x64 key frame at preset 4 (angle deltas -2, 0, 2 searched),
    q60: the first of the stripe frames at 129, 51, 39, 141 degrees that
    the JAX Decoder decodes to the encoder's recon and whose decode takes
    a directional prediction with a non-zero angle delta (the encoder
    compiles once; each try is a fresh IntraEncoder).  A frame where the
    encoder picks V_PRED or H_PRED with a non-zero delta does not decode
    to its recon: the JAX Decoder predicts those blocks as plain V / H
    (decoder.py:937); such a frame is skipped and reported."""
    cfg = apply_preset(EncoderConfig(128, 64, qindex=60), 4)
    for deg in (129, 51, 39, 141):
        payload, rec = IntraEncoder(cfg).encode_frame(*stripes(128, 64, deg))
        try:
            seen = decode_checked("angle_deltas", [payload], [rec], 8)
        except AssertionError as e:
            print("angle deltas: stripes at", deg, "degrees:", e, flush=True)
            continue
        if seen["angle_delta"]:
            print("angle deltas: stripes at", deg, "degrees", flush=True)
            return [payload], [rec], 8
    raise AssertionError("no stripe frame codes a non-zero angle delta")


STREAMS = {"compound_pyramid": compound_pyramid, "two_tiles": two_tiles,
           "ten_bit": ten_bit, "angle_deltas": angle_deltas}


def decode_checked(name, payloads, recons, bd):
    """JAX Decoder output equals the recons; counts the compound blocks
    and the non-zero angle deltas it decodes."""
    seen = {"compound": 0, "angle_delta": 0}
    comp_mode, dr = JIM.read_comp_mode, jdec.dr_pred

    def spy_comp(*a):
        r = comp_mode(*a)
        seen["compound"] += int(r)
        return r

    def spy_dr(mode, delta, *a):
        seen["angle_delta"] += int(delta != 0)
        return dr(mode, delta, *a)

    JIM.read_comp_mode, jdec.dr_pred = spy_comp, spy_dr
    try:
        dec = jdec.Decoder()
        out = [f for f in map(dec.decode_frame_obus, payloads)
               if f is not None]
    finally:
        JIM.read_comp_mode, jdec.dr_pred = comp_mode, dr
    assert len(out) == len(recons), name
    for k, (a, b) in enumerate(zip(out, recons)):
        assert frame_md5(a, bd) == frame_md5(b, bd), f"{name} frame {k}"
    return seen


def main(names):
    md5 = {}
    for name in names:
        make = STREAMS[name]
        payloads, recons, bd = make()
        seen = decode_checked(name, payloads, recons, bd)
        if name == "compound_pyramid":
            assert seen["compound"] > 0, "no compound block"
        if name == "angle_deltas":
            assert seen["angle_delta"] > 0, "no non-zero angle delta"
        h, w = np.asarray(recons[0][0]).shape
        with open(HERE / f"{name}.ivf", "wb") as f:
            ivf = IvfWriter(f, w, h)
            for i, p in enumerate(payloads):
                ivf.write_frame(p, i)
            ivf.finalize()
        md5[name] = {"bit_depth": bd, "tus": len(payloads),
                     "frames": [frame_md5(r, bd) for r in recons],
                     "seen": seen}
        print(name, len(payloads), "TUs", md5[name]["frames"][0], seen,
              flush=True)
    path = HERE / "md5.json"
    old = json.loads(path.read_text()) if path.exists() else {}
    with open(path, "w") as f:
        json.dump(dict(sorted((old | md5).items())), f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main(sys.argv[1:] or list(STREAMS))
