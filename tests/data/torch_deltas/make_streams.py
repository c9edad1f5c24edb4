"""Write the angle-delta fixtures: small IVF streams of the JAX encoder at
presets 0-5 (angle deltas searched), and ``md5.json`` with each stream's
source, configuration and the per-frame MD5s of the JAX encoder's recons
in display order.

    JAX_PLATFORMS=cpu python tests/data/torch_deltas/make_streams.py [NAME ...]

Run by hand from the repo root; NAMEs (default: all of STREAMS) pick the
streams to write, and their entries are merged into ``md5.json``.  Each
configuration compiles its own JAX scans (minutes to tens of minutes a
stream on a CPU), so streams are best made in parallel processes, one
NAME each.  Every stream is checked before it is written: the libavcodec
oracle ``tools/av1dec`` (built from ``tools/av1dec.c`` when missing) must
decode it to the encoder's recons, and the stream must carry the syntax
it is kept for (non-zero angle deltas; for ``vh_delta`` a V_PRED or
H_PRED block with one).  The JAX ``Decoder`` is not the check: it
predicts a V_PRED or H_PRED block with a non-zero delta as plain V or H.
The tests (``tests/test_torch_angle_deltas.py``) rebuild each source and
configuration from the entry and hold the port's encoder to the bytes.
"""

import hashlib
import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from svtav1_tpu.ec import modes as jmodes  # noqa: E402
from svtav1_tpu.encoder.intra_encoder import (EncoderConfig,  # noqa: E402
                                              IntraEncoder)
from svtav1_tpu.encoder.presets import apply_preset  # noqa: E402
from svtav1_tpu.encoder.video_encoder import VideoEncoder  # noqa: E402
from svtav1_tpu.utils.ivf import IvfWriter  # noqa: E402
from svtav1_tpu.utils.obu import OBU_FRAME, parse_obus  # noqa: E402
from svtav1_tpu_torch.cuda import inputs  # noqa: E402

AV1DEC = ROOT / "tools" / "av1dec"
P0_DELTAS = (-3, -2, -1, 0, 1, 2, 3)

# name -> (encoder "intra" or "video", configuration, source); the
# configuration is EncoderConfig(width, height, qindex, bit_depth), then
# apply_preset(preset) when preset is not None, then the overrides
STREAMS = {
    # (a) a preset-4 key frame that codes V_PRED or H_PRED with a delta:
    # the first stripe angle (of "degs") whose frame does
    "vh_delta": ("intra", dict(width=128, height=64, qindex=60, bit_depth=8,
                               preset=4, overrides={}),
                 dict(kind="stripes", degs=[51, 80, 20])),
    # (b) preset 4, low-delay I, P, P (P frames with intra delta blocks)
    "p4_lowdelay": ("video", dict(width=128, height=64, qindex=60,
                                  bit_depth=8, preset=4, overrides={}),
                    dict(kind="moving_stripes", n=3, seed=0)),
    # (c) the flat path with preset 0's deltas, I, P (no preset selects
    # it: part_search off, filters off)
    "flat_p0": ("video", dict(width=128, height=64, qindex=100, bit_depth=8,
                              preset=None,
                              overrides=dict(part_search=False,
                                             angle_deltas=list(P0_DELTAS))),
                dict(kind="moving_stripes", n=2, seed=0)),
    # (d) a 10-bit preset-4 key frame
    "p4_10bit": ("intra", dict(width=128, height=64, qindex=100, bit_depth=10,
                               preset=4, overrides={}),
                 dict(kind="stripes", degs=[51, 80, 20])),
    # (e) a preset-1 partition key frame (61 luma candidates)
    "p1_key": ("intra", dict(width=64, height=64, qindex=100, bit_depth=8,
                             preset=1, overrides={}),
               dict(kind="stripes", degs=[51, 80, 20])),
}


def config(c, make_cfg, preset_fn):
    """The EncoderConfig of a STREAMS entry, built with make_cfg (an
    EncoderConfig class) and preset_fn (an apply_preset)."""
    cfg = make_cfg(c["width"], c["height"], qindex=c["qindex"],
                   bit_depth=c["bit_depth"])
    if c["preset"] is not None:
        cfg = preset_fn(cfg, c["preset"])
    ov = dict(c["overrides"])
    if "angle_deltas" in ov:
        ov["angle_deltas"] = tuple(ov["angle_deltas"])
    return replace(cfg, **ov)


def source(s, w, h, bd, deg=None):
    """The frames of a STREAMS source (stripes at deg)."""
    if s["kind"] == "stripes":
        return [inputs.stripes(w, h, deg, bd=bd)]
    return getattr(inputs, s["kind"])(w, h, s["n"], seed=s["seed"])


def frame_md5(planes, bd):
    dt = np.uint8 if bd == 8 else np.uint16
    m = hashlib.md5()
    for p in planes:
        m.update(np.asarray(p).astype(dt).tobytes())
    return m.hexdigest()


def write_ivf(path, payloads, w, h):
    with open(path, "wb") as f:
        ivf = IvfWriter(f, w, h)
        for i, p in enumerate(payloads):
            ivf.write_frame(p, i)
        ivf.finalize()


def av1dec_md5s(path, w, h, n, bd):
    """Per-frame MD5s of tools/av1dec's output (planar, 16-bit LE samples
    at 10 bits)."""
    if not AV1DEC.exists():
        subprocess.run(f"gcc -O2 -o {AV1DEC} {AV1DEC}.c -lavformat "
                       "-lavcodec -lavutil", shell=True, check=True)
    yuv = Path(str(path) + ".yuv")
    subprocess.run([str(AV1DEC), str(path), str(yuv)], check=True,
                   capture_output=True)
    dt = np.uint8 if bd == 8 else np.uint16
    data = np.fromfile(yuv, dt)
    yuv.unlink()
    fsz = w * h + 2 * (w // 2) * (h // 2)
    assert data.size == fsz * n, (data.size, fsz, n)
    out = []
    for k in range(n):
        f = data[k * fsz:(k + 1) * fsz]
        c = (w // 2) * (h // 2)
        planes = (f[:w * h], f[w * h:w * h + c], f[w * h + c:])
        out.append(frame_md5(planes, bd))
    return out


def frame_types(payloads):
    """Each payload's frame_type (0 KEY_FRAME, 1 INTER_FRAME): the bits
    after show_existing_frame in its first OBU_FRAME's header."""
    return [next((d[0] >> 5) & 3 for t, _, _, d in parse_obus(p)
                 if t == OBU_FRAME) for p in payloads]


def encode(kind, cfg, frames):
    """(payloads, recons, deltas written: {"any": n, "vh": n, "p": n}) of
    the JAX encoder; the deltas are counted at the tile coders' writes,
    "p" those of P frames."""
    seen = {"any": 0, "vh": 0, "p": 0}
    write = jmodes.write_angle_delta

    def spy(enc, cdf, mode, delta):
        seen["any"] += int(delta != 0)
        seen["p"] += int(delta != 0 and len(out) > 0)
        seen["vh"] += int(delta != 0 and mode in (1, 2))
        return write(enc, cdf, mode, delta)

    out = []
    jmodes.write_angle_delta = spy
    try:
        if kind == "intra":
            payloads, recons = IntraEncoder(cfg).encode_frames(frames)
        else:
            enc = VideoEncoder(cfg, keyint=64)
            for f in frames:
                out.append(enc.encode_frame(*f))
            payloads, recons = [p for p, _ in out], [r for _, r in out]
    finally:
        jmodes.write_angle_delta = write
    return payloads, recons, seen


def make(name):
    kind, c, s = STREAMS[name]
    cfg = config(c, EncoderConfig, apply_preset)
    w, h, bd = c["width"], c["height"], c["bit_depth"]
    path = HERE / f"{name}.ivf"
    t0 = time.time()
    for deg in s.get("degs", [None]):
        payloads, recons, seen = encode(kind, cfg, source(s, w, h, bd, deg))
        md5s = [frame_md5(r, bd) for r in recons]
        write_ivf(path, payloads, w, h)
        oracle = av1dec_md5s(path, w, h, len(recons), bd)
        types = frame_types(payloads)
        ok = oracle == md5s and seen["any"] > 0 and \
            (name != "vh_delta" or seen["vh"] > 0) and \
            (kind != "video" or (seen["p"] > 0 and
                                 types == [0] + [1] * (len(types) - 1)))
        print(name, "deg", deg, "deltas", seen, "frame types", types,
              "oracle equal", oracle == md5s, flush=True)
        if ok:
            break
    else:
        path.unlink()
        raise AssertionError(f"{name}: no source passed its checks")
    entry = {"encoder": kind, "config": c,
             "source": dict(s, **({"deg": deg} if deg is not None else {})),
             "bit_depth": bd, "tus": len(payloads), "frame_types": types,
             "frames": md5s,
             "deltas": seen, "seconds": round(time.time() - t0, 1)}
    entry["source"].pop("degs", None)
    return entry


def main(names):
    for name in names:
        entry = make(name)
        print(name, json.dumps(entry), flush=True)
        # merge under a lock-free re-read: parallel processes each write
        # their own entry
        path = HERE / "md5.json"
        old = json.loads(path.read_text()) if path.exists() else {}
        old[name] = entry
        tmp = path.with_suffix(f".{name}.tmp")
        tmp.write_text(json.dumps(dict(sorted(old.items())), indent=1) +
                       "\n")
        tmp.replace(path)


if __name__ == "__main__":
    main(sys.argv[1:] or list(STREAMS))
