"""Write the JAX side of the port's 10-bit partition tests at 128x64, q100:
one ``<NAME>.npz`` each, holding what the JAX package computes on the
same input and state as the port's test fixture.

    JAX_PLATFORMS=cpu python tests/data/torch_10bit/make_fixtures.py [NAME ...]

Run by hand from the repo root; NAMEs (default: all of FIXTURES) pick the
files to write.  Each compiles the JAX partition scans at bd=10 (minutes
on a CPU), so the names are best made in parallel processes, one each.

- ``intra`` (``tests/test_torch_10bit_intra.py``): the JAX IntraEncoder
  with CDEF, LR and CCSO on one frame of ``edge_frames10``: every array
  of its device tuple (by index), the DLF level, the payload and the
  recon; and the JAX CLI's payloads at its defaults on that frame as a
  C420p10 Y4M.
- ``video`` (``tests/test_torch_10bit_video.py``): the JAX VideoEncoder's
  two P frames of ``moving_frames10`` after the port's key frame (its
  state set to what the port holds after it): each P frame's dumped
  decision maps (``SVT_DUMP_DIR``), DLF level, payload and recon.
- ``part_pyramid`` (``tests/test_torch_10bit_part_pyramid.py``): the JAX
  VideoEncoder's compound frame of a gop-2 pyramid of
  ``moving_frames10``, coded alone through ``_encode_ref_frame`` from the
  port's pyramid state before it (DPB slots, the anchor's CDF snapshot
  copied into a JAX CdfContext, display indices, GM parameters): its
  dumped maps, q, DLF level, compound flag, payload and recon.

The JAX side starts from the port's state, so each file also keeps the
MD5 of the port's payloads that make that state (``state_md5``: the key
frame; for the pyramid, the key frame and the anchor); a test whose port
no longer writes them says so before it compares.
"""

import contextlib
import copy
import hashlib
import io
import os
import pickle
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

from svtav1_tpu import app as japp  # noqa: E402
from svtav1_tpu.encoder import intra_encoder as jie  # noqa: E402
from svtav1_tpu.encoder import video_encoder as jve  # noqa: E402
from svtav1_tpu.spec import cdf as jcdf  # noqa: E402
from svtav1_tpu.utils.ivf import read_ivf  # noqa: E402
from svtav1_tpu_torch.cuda.inputs import (edge_frames10,  # noqa: E402
                                          moving_frames10)
from svtav1_tpu_torch.encoder import intra_encoder as tie  # noqa: E402
from svtav1_tpu_torch.encoder import video_encoder as tve  # noqa: E402
from svtav1_tpu_torch.utils.y4m import Y4mInfo, Y4mWriter  # noqa: E402

W, H, Q, BD = 128, 64, 100, 10
FILTERS = dict(enable_cdef=True, enable_lr=True, enable_ccso=True)
# the device tuple's arrays (index: name), as tests/test_torch_part.py
DEV_FIELDS = (2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 18, 19,
              20, 21, 22, 23)
# the P-frame dump's maps (leading tile axis dropped), as MAPS of
# tests/test_torch_video.py and tests/test_torch_part_pyramid.py
MAPS = ("part", "y_mi", "y_lev", "y_smi", "y_slev", "y_stx", "part_sb",
        "y_mi_sb", "y_lev_sb", "u_lev", "v_lev", "u_slev", "v_slev",
        "u_lev_sb", "v_lev_sb", "mv_t", "mv_s", "mv_sb")


def payload_md5(payloads):
    m = hashlib.md5()
    for p in payloads:
        m.update(len(p).to_bytes(4, "little"))
        m.update(p)
    return m.hexdigest()


def as_u8(payload):
    return np.frombuffer(payload, np.uint8)


@contextlib.contextmanager
def dump_dir():
    """SVT_DUMP_DIR set to a fresh directory (the JAX P-frame dumps)."""
    saved = os.environ.get("SVT_DUMP_DIR")
    with tempfile.TemporaryDirectory() as d:
        os.environ["SVT_DUMP_DIR"] = d
        try:
            yield Path(d)
        finally:
            if saved is None:
                del os.environ["SVT_DUMP_DIR"]
            else:
                os.environ["SVT_DUMP_DIR"] = saved


def load_dump(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def make_intra():
    frames = edge_frames10(W, H, 1)
    jenc = jie.IntraEncoder(jie.EncoderConfig(W, H, qindex=Q, bit_depth=BD,
                                              **FILTERS))
    jdev = jenc.device_encode(frames)
    out = {f"dev_{k}": np.asarray(jdev[k]) for k in DEV_FIELDS}
    out["lf"] = np.asarray(jdev[24], np.int64)
    jpay, jrec = jenc.host_finish(jdev)
    out.update({f"pay_{i}": as_u8(p) for i, p in enumerate(jpay)})
    out.update({f"rec_{i}_{p}": np.asarray(r[p], np.uint16)
                for i, r in enumerate(jrec) for p in range(3)})
    with tempfile.TemporaryDirectory() as d:
        src, ivf = Path(d) / "in.y4m", Path(d) / "j.ivf"
        with open(src, "wb") as f:
            Y4mWriter(f, Y4mInfo(W, H, 30, 1, bit_depth=BD)).write_frame(
                *frames[0])
        with contextlib.redirect_stdout(io.StringIO()):
            assert japp.main(["-i", str(src), "-b", str(ivf)]) == 0
        with open(ivf, "rb") as f:
            cli = [p for p, _ in read_ivf(f)[1]]
    out.update({f"cli_{i}": as_u8(p) for i, p in enumerate(cli)})
    return out


def make_video():
    frames = moving_frames10(W, H, 3)
    torch.set_num_threads(1)
    enc = tve.VideoEncoder(tie.EncoderConfig(W, H, qindex=Q, bit_depth=BD),
                           keyint=64, device="cpu")
    key = enc.encode_frame(*frames[0])
    jenc = jve.VideoEncoder(jie.EncoderConfig(W, H, qindex=Q, bit_depth=BD),
                            keyint=64)
    jenc._dpb = tuple(np.asarray(p, np.int32) for p in key[1])
    jenc._idx, jenc._kf_at = 1, 64
    jenc._tail_src = np.asarray(frames[0][0], np.int32)[::4, ::4]
    out = {"state_md5": np.asarray(payload_md5([key[0]]))}
    with dump_dir() as dump:
        for k, f in enumerate(frames[1:], 1):
            payload, rec = jenc.encode_frame(*f)
            d = load_dump(dump / f"pframe_{k - 1:03d}.pkl")
            out.update({f"map_{k}_{m}": np.asarray(d[m][0])
                        for m in MAPS})
            out[f"lf_{k}"] = np.asarray(d["lf"], np.int64)
            out[f"pay_{k}"] = as_u8(payload)
            out.update({f"rec_{k}_{p}": np.asarray(rec[p], np.uint16)
                        for p in range(3)})
    return out


def _jax_cdf(snap):
    """The port's CDF snapshot as a JAX CdfContext (the same tables)."""
    if snap is None:
        return None
    c = object.__new__(jcdf.CdfContext)
    c.update_enabled = snap.update_enabled
    c._t = {k: v.copy() for k, v in snap._t.items()}
    return c


def make_part_pyramid():
    frames = moving_frames10(W, H, 3)
    torch.set_num_threads(1)
    enc = tve.VideoEncoder(tie.EncoderConfig(W, H, qindex=Q, bit_depth=BD),
                           keyint=64, pyramid=True, gop=2, device="cpu")
    coded, state = [], {}
    code = enc._encode_p_part

    def spy_code(*a, **kw):
        if kw.get("ref2") is not None:
            state.update(copy.deepcopy(dict(
                slots=enc._slots, slot_cdf=enc._slot_cdf,
                slot_t=enc._slot_t, slot_gm=enc._slot_gm)))
        out = code(*a, **kw)
        coded.append(dict(enc.last_p, payload=out[0]))
        return out

    enc._encode_p_part = spy_code
    payloads, _ = enc.encode_frames(frames)
    enc.flush()
    jenc = jve.VideoEncoder(jie.EncoderConfig(W, H, qindex=Q, bit_depth=BD),
                            keyint=64, pyramid=True, gop=2)
    jenc._slots = {s: tuple(np.asarray(p, np.int32) for p in r)
                   for s, r in state["slots"].items()}
    jenc._slot_cdf = {s: _jax_cdf(c) for s, c in state["slot_cdf"].items()}
    jenc._slot_t, jenc._slot_gm = state["slot_t"], state["slot_gm"]
    with dump_dir() as dump:
        payload, rec = jenc._encode_ref_frame(frames[1], [0, 1],
                                              coded[1]["q"], 2, False,
                                              refresh_t=1, layer=1)
        d = load_dump(dump / "pframe_000.pkl")
    out = {f"map_{m}": np.asarray(d[m][0]) for m in MAPS}
    out.update(q=np.asarray(d["q"]), lf=np.asarray(d["lf"], np.int64),
               comp=np.asarray(d["comp"]), payload=as_u8(payload))
    out.update({f"rec_{p}": np.asarray(rec[p], np.uint16) for p in range(3)})
    # the state: the key frame and the anchor (the first two payloads)
    out["state_md5"] = np.asarray(payload_md5(
        [payloads[0], coded[0]["payload"]]))
    return out


FIXTURES = {"intra": make_intra, "video": make_video,
            "part_pyramid": make_part_pyramid}


def main(names):
    for name in names:
        out = FIXTURES[name]()
        np.savez_compressed(HERE / f"{name}.npz", **out)
        print(name, sorted(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(FIXTURES))
