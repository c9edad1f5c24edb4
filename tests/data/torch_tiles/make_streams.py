"""Write the tile-column and CLI fixtures: small IVF streams of the JAX
encoder with two or four tile columns, the JAX CLI's IVF bytes and its
output for ``--mbr`` and ``--stat-report``, and ``md5.json`` with each
entry's source, configuration, the per-frame MD5s of the JAX encoder's
recons in display order and, for the CLI entries, the arguments and the
printed lines.

    JAX_PLATFORMS=cpu python tests/data/torch_tiles/make_streams.py [NAME ...]

Run by hand from the repo root; NAMEs (default: all of STREAMS) pick the
entries to write, and they are merged into ``md5.json``.  Each
configuration compiles its own JAX scans (minutes to tens of minutes an
entry on a CPU), so entries are best made in parallel processes, one NAME
each.  Every stream is checked before it is written: the libavcodec
oracle ``tools/av1dec`` (built from ``tools/av1dec.c`` when missing) must
decode it to the encoder's recons; a CCSO stream, which is not standard
AV1, is checked with the port's ``Decoder(ccso=True)`` on the CPU instead
(the JAX ``Decoder`` predicts a V_PRED or H_PRED block with a non-zero
angle delta as plain V or H, and preset 4 searches deltas).  An entry
with a list of sources takes the first that passes its checks (for
``p4_lr_ccso``: a P frame that signals loop restoration and one that
signals CCSO).  The ``mesh`` entry runs the functions of
``svtav1_tpu/parallel/mesh.py`` on two host CPU devices (a (2, 1) and a
(1, 2) mesh) and keeps their outputs' MD5s, lengths and totals.  The
tests (``tests/test_torch_tiles.py``, ``tests/test_torch_cli.py``)
rebuild each source and configuration from its entry and hold the port to
the bytes, lines and values.
"""

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
sys.path.insert(0, str(ROOT))

# two host devices for the mesh entry (the encodes run on the first)
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_"
                               "device_count=2")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from svtav1_tpu import app as japp  # noqa: E402
from svtav1_tpu.encoder import ccso_search as jccso  # noqa: E402
from svtav1_tpu.encoder import lr_search as jlr  # noqa: E402
from svtav1_tpu.encoder.intra_encoder import (EncoderConfig,  # noqa: E402
                                              IntraEncoder)
from svtav1_tpu.encoder.presets import apply_preset  # noqa: E402
from svtav1_tpu.encoder.video_encoder import VideoEncoder  # noqa: E402
from svtav1_tpu.parallel import mesh as jmesh  # noqa: E402
from svtav1_tpu.utils.ivf import IvfWriter, read_ivf  # noqa: E402
from svtav1_tpu.utils.obu import OBU_FRAME, parse_obus  # noqa: E402
from svtav1_tpu.utils.y4m import Y4mInfo, Y4mWriter  # noqa: E402
from svtav1_tpu_torch.cuda import inputs  # noqa: E402

AV1DEC = ROOT / "tools" / "av1dec"

# name -> (kind, configuration, sources); kind "intra" (IntraEncoder on
# every frame), "video" (low-delay VideoEncoder, keyint 64), "pyramid"
# (VideoEncoder(pyramid=True, gop, tf)) or "cli" (the JAX CLI on a Y4M of
# the source); the configuration is EncoderConfig(width, height, qindex,
# bit_depth, tile_cols), then apply_preset(preset) when preset is not
# None, then the overrides; a source is an ``inputs`` clip (kind, n, seed)
STREAMS = {
    # (a) a key frame with four 64-px tile columns
    "key_t4": ("intra", dict(width=256, height=64, qindex=100, bit_depth=8,
                             tile_cols=4, preset=None, overrides={}),
               [dict(kind="moving_frames", n=1, seed=0)]),
    # (b) preset 4 (CDEF, angle deltas) with LR and CCSO, two tile
    # columns, I, P, P: the first source with a P frame that signals LR
    # and one that signals CCSO
    "p4_lr_ccso": ("video", dict(width=256, height=128, qindex=100,
                                 bit_depth=8, tile_cols=2, preset=4,
                                 overrides=dict(enable_lr=True,
                                                enable_ccso=True)),
                   [dict(kind="moving_frames", n=3, seed=s)
                    for s in (0, 1, 2)]),
    # (c) 10-bit low-delay I, P with two tile columns
    "ten_bit_t2": ("video", dict(width=256, height=64, qindex=100,
                                 bit_depth=10, tile_cols=2, preset=None,
                                 overrides={}),
                   [dict(kind="moving_frames10", n=2, seed=0)]),
    # (d) the compound pyramid (gop 2, TF) with two tile columns: key,
    # anchor, compound frame, two overlays
    "pyramid_t2": ("pyramid", dict(width=256, height=64, qindex=100,
                                   bit_depth=8, tile_cols=2, preset=None,
                                   overrides={}, gop=2, tf=True),
                   [dict(kind="moving_frames", n=3, seed=0)]),
    # (e) the CLI: capped CRF on the flat path (--preset 12) and on the
    # default partition path, each with --stat-report; --stat-report of a
    # 10-bit clip
    "cli_mbr_flat": ("cli", dict(width=128, height=64, bit_depth=8,
                                 args=["--keyint", "1", "--preset", "12",
                                       "--stat-report"], mbr=True),
                     [dict(kind="moving_frames", n=2, seed=0)]),
    "cli_mbr_part": ("cli", dict(width=128, height=64, bit_depth=8,
                                 args=["--keyint", "1", "--stat-report"],
                                 mbr=True),
                     [dict(kind="moving_frames", n=2, seed=0)]),
    "cli_stat10": ("cli", dict(width=128, height=64, bit_depth=10,
                               args=["--keyint", "1", "--preset", "12",
                                     "--stat-report"], mbr=False),
                   [dict(kind="moving_frames10", n=2, seed=0)]),
    # (f) parallel/mesh.py on two devices: the GOP-parallel encodes (64x64,
    # keyint 3, two GOPs, q110; flat and partition), the tile-parallel key
    # frames (2 and 4 tiles), the encode and pipeline steps (tile_parallel
    # 1 and 2); each function's own sources
    "mesh": ("mesh", dict(devices=2, part_search=[False, True],
                          n_tiles=[2, 4], tile_parallel=[1, 2]), []),
}


def config(c, make_cfg, preset_fn):
    """The EncoderConfig of an encoder entry, built with make_cfg (an
    EncoderConfig class) and preset_fn (an apply_preset)."""
    cfg = make_cfg(c["width"], c["height"], qindex=c["qindex"],
                   bit_depth=c["bit_depth"], tile_cols=c["tile_cols"])
    if c["preset"] is not None:
        cfg = preset_fn(cfg, c["preset"])
    return replace(cfg, **c["overrides"])


def source(s, w, h):
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


def write_y4m(path, frames, w, h, bd):
    with open(path, "wb") as f:
        wtr = Y4mWriter(f, Y4mInfo(w, h, 30, 1, bit_depth=bd))
        for fr in frames:
            wtr.write_frame(*fr)


def av1dec_md5s(path, w, h, n, bd):
    """Per-frame MD5s of tools/av1dec's output (planar, 16-bit LE samples
    at 10 bits)."""
    if not AV1DEC.exists():
        subprocess.run(f"gcc -O2 -o {AV1DEC} {AV1DEC}.c -lavformat "
                       "-lavcodec -lavutil", shell=True, check=True)
    yuv = Path(str(path) + ".yuv")
    subprocess.run([str(AV1DEC), str(path), str(yuv)], check=True,
                   capture_output=True)
    data = np.fromfile(yuv, np.uint8 if bd == 8 else np.uint16)
    yuv.unlink()
    fsz = w * h * 3 // 2
    assert data.size == fsz * n, (data.size, fsz, n)
    c = w * h // 4
    return [frame_md5((f[:w * h], f[w * h:w * h + c], f[w * h + c:]), bd)
            for f in data.reshape(n, fsz)]


def ccso_decoder_md5s(payloads, bd):
    """Per-frame MD5s of the port's decoder (CCSO syntax on, the CPU)."""
    from svtav1_tpu_torch.decoder.decoder import Decoder
    dec = Decoder(ccso=True, device="cpu")
    out = [f for f in map(dec.decode_frame_obus, payloads) if f is not None]
    return [frame_md5(f, bd) for f in out]


def frame_types(payloads):
    """Each payload's frame_type (0 KEY_FRAME, 1 INTER_FRAME) or "overlay"
    for a show_existing_frame TU (no OBU_FRAME)."""
    out = []
    for p in payloads:
        fr = [d for t, _, _, d in parse_obus(p) if t == OBU_FRAME]
        out.append((fr[0][0] >> 5) & 3 if fr else "overlay")
    return out


def encode(kind, c, cfg, frames):
    """(payloads in decode order, recons in display order, the frames (by
    coding index) whose LR search turned a plane on and whose CCSO search
    kept CCSO)."""
    seen = {"lr": [], "ccso": []}
    lr0, ccso0 = jlr.lr_search_frame, jccso.ccso_search_frame
    k = [0]

    def spy_lr(*a, **kw):
        r = lr0(*a, **kw)
        if any(r[0]):
            seen["lr"].append(k[0])
        return r

    def spy_ccso(*a, **kw):
        r = ccso0(*a, **kw)
        if r is not None:
            seen["ccso"].append(k[0])
        return r

    jlr.lr_search_frame, jccso.ccso_search_frame = spy_lr, spy_ccso
    try:
        if kind == "intra":
            payloads, recons = IntraEncoder(cfg).encode_frames(frames)
        elif kind == "video":
            enc = VideoEncoder(cfg, keyint=64)
            payloads, recons = [], []
            for f in frames:
                p, r = enc.encode_frame(*f)
                payloads.append(p)
                recons.append(r)
                k[0] += 1
        else:
            enc = VideoEncoder(cfg, keyint=64, pyramid=True, gop=c["gop"],
                               tf=c["tf"])
            payloads, recons = enc.encode_frames(frames)
            p2, r2 = enc.flush()
            payloads, recons = payloads + p2, recons + r2
    finally:
        jlr.lr_search_frame, jccso.ccso_search_frame = lr0, ccso0
    return payloads, recons, seen


def run_cli(argv):
    """(exit status, stdout, stderr) of the JAX CLI's main(argv)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = japp.main(argv)
    return rc, out.getvalue(), err.getvalue()


def make_cli(name, c, s):
    """The JAX CLI on a Y4M of the source: without --mbr first (the frame
    sizes), then, for an --mbr entry, with a cap of 0.7 of the largest
    frame's bits (at 30 fps), so that the ladder re-encodes it."""
    w, h, bd = c["width"], c["height"], c["bit_depth"]
    frames = source(s, w, h)
    path = HERE / f"{name}.ivf"
    with tempfile.TemporaryDirectory() as d:
        src = Path(d) / "in.y4m"
        write_y4m(src, frames, w, h, bd)
        args = ["-i", str(src), "-b", str(path)] + c["args"]
        rc, out, err = run_cli(args)
        assert rc == 0, (rc, err)
        with open(path, "rb") as f:
            plain = [p for p, _ in read_ivf(f)[1]]
        mbr = None
        if c["mbr"]:
            mbr = int(0.7 * max(len(p) for p in plain) * 8 * 30 / 1000)
            args += ["--mbr", str(mbr)]
            rc, out, err = run_cli(args)
            assert rc == 0, (rc, err)
    with open(path, "rb") as f:
        payloads = [p for p, _ in read_ivf(f)[1]]
    recoded = sum(a != b for a, b in zip(payloads, plain))
    assert len(payloads) == len(frames)
    assert not c["mbr"] or recoded > 0, "the cap re-encoded no frame"
    print(name, "mbr", mbr, "recoded", recoded, "stdout", out.strip(),
          "stderr", err.strip(), flush=True)
    return {"encoder": "cli", "config": c, "source": s, "bit_depth": bd,
            "mbr": mbr, "recoded": recoded, "tus": len(payloads),
            "stdout": out.splitlines(), "stderr": err.splitlines(),
            "sizes": [len(p) for p in payloads],
            "plain_sizes": [len(p) for p in plain]}


def md5(data):
    return hashlib.md5(data).hexdigest()


def make_mesh(c):
    """The JAX mesh functions' outputs: the sharded and the serial (or
    one-device) bytes of each encode, which must agree, and the steps'
    recons (MD5 of their uint8 / int32 bytes, shape) and totals."""
    n = c["devices"]
    assert len(jax.devices()) >= n, jax.devices()
    out = {"video": {}, "tiles": {}, "encode_step": {}, "pipeline_step": {}}
    mesh = jmesh.make_mesh(n)
    for part in c["part_search"]:
        got = jmesh.sharded_video_encode_bytes(mesh, part_search=part)
        want = jmesh.sharded_video_encode_bytes(mesh, shard=False,
                                                part_search=part)
        assert got == want, part
        out["video"][str(part)] = dict(md5=md5(got), bytes=len(got))
    for t in c["n_tiles"]:
        got = jmesh.sharded_tile_encode_bytes(mesh, n_tiles=t)
        want = jmesh.sharded_tile_encode_bytes(mesh, n_tiles=t, shard=False)
        assert got == want, t
        out["tiles"][str(t)] = dict(md5=md5(got), bytes=len(got))
    for tp in c["tile_parallel"]:
        m = jmesh.make_mesh(n, tile_parallel=tp)
        rec, total = jmesh.sharded_encode_step(m)
        rec = np.asarray(rec).astype(np.uint8)
        out["encode_step"][str(tp)] = dict(
            md5=md5(rec.tobytes()), shape=list(rec.shape),
            total=float(total))
        rec, bits = jmesh.sharded_pipeline_step(m)
        rec = np.asarray(rec).astype(np.int32)
        out["pipeline_step"][str(tp)] = dict(
            md5=md5(rec.tobytes()), shape=list(rec.shape), bits=int(bits))
    print("mesh", out, flush=True)
    return out


def make(name):
    kind, c, sources = STREAMS[name]
    t0 = time.time()
    if kind == "mesh":
        entry = dict(encoder="mesh", config=c, **make_mesh(c))
        entry["seconds"] = round(time.time() - t0, 1)
        return entry
    if kind == "cli":
        entry = make_cli(name, c, sources[0])
        entry["seconds"] = round(time.time() - t0, 1)
        return entry
    cfg = config(c, EncoderConfig, apply_preset)
    w, h, bd = c["width"], c["height"], c["bit_depth"]
    path = HERE / f"{name}.ivf"
    for s in sources:
        frames = source(s, w, h)
        payloads, recons, seen = encode(kind, c, cfg, frames)
        md5s = [frame_md5(r, bd) for r in recons]
        write_ivf(path, payloads, w, h)
        types = frame_types(payloads)
        if cfg.enable_ccso:
            check = ccso_decoder_md5s(payloads, bd)
        else:
            check = av1dec_md5s(path, w, h, len(recons), bd)
        ok = check == md5s and len(recons) == len(frames)
        if kind == "video":
            ok = ok and types == [0] + [1] * (len(types) - 1)
        if kind == "pyramid":
            ok = ok and types == [0, 1, 1, "overlay", "overlay"]
        if name == "p4_lr_ccso":
            ok = ok and any(k > 0 for k in seen["lr"]) and \
                any(k > 0 for k in seen["ccso"])
        print(name, "source", s, "types", types, "seen", seen,
              "decoder equal", check == md5s, flush=True)
        if ok:
            break
    else:
        path.unlink()
        raise AssertionError(f"{name}: no source passed its checks")
    return {"encoder": kind, "config": c, "source": s, "bit_depth": bd,
            "tus": len(payloads), "frame_types": types, "frames": md5s,
            "seen": seen, "seconds": round(time.time() - t0, 1)}


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
