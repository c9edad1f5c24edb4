"""The port's 10-bit flat paths against the JAX package at 128x64, q100,
on the CPU: all-intra (M11-M13 at --keyint 1), low-delay I, P, P
(--no-part-search at --keyint 64) and the pyramid (gop 4, TF on) under CQ
and CBR, on the 10-bit clips of ``cuda/inputs``.  Payloads must be
byte-identical and the uint16 recons equal (the pyramid's anchors are
filtered by the port, JAX's TF planes counted against them and replaced by
them: float32 exp can round a pixel apart).  The port's Decoder decodes
each port stream to the encoder's recons.  The CLI on a C420p10 Y4M
writes the JAX CLI's IVF bytes at --keyint 1 --preset 13, and with
--film-grain (a 10-bit stream carries no grain parameters, in both
packages; at 8 bits the flag writes JAX's grain bytes too).
"""

import numpy as np
import pytest

from svtav1_tpu import app as japp
from svtav1_tpu.encoder import intra_encoder as jie
from svtav1_tpu.encoder import rate_control as jrc
from svtav1_tpu.encoder import video_encoder as jve
from svtav1_tpu.utils.ivf import read_ivf
from svtav1_tpu_torch import app
from svtav1_tpu_torch.cuda.inputs import (moving_frames, moving_frames10,
                                          synth_frames10)
from svtav1_tpu_torch.decoder.decoder import Decoder
from svtav1_tpu_torch.encoder import intra_encoder as tie
from svtav1_tpu_torch.encoder import rate_control as trc
from svtav1_tpu_torch.encoder import video_encoder as tve
from svtav1_tpu_torch.utils.y4m import Y4mInfo, Y4mWriter
from test_torch_part import one_thread

W, H, Q, BD = 128, 64, 100, 10
TBR = 120            # kbps of the CBR pyramid: q moves between the GoPs


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    monkeypatch.setenv("SVT_TPU_LAMBDA_SCALE", "1.0")
    with one_thread():
        yield


def _cfg(mod, **kw):
    return mod.EncoderConfig(W, H, qindex=Q, bit_depth=BD,
                             part_search=False, **kw)


def _same(port, jax):
    """Byte-identical payloads and equal uint16 recons."""
    assert port[0] == jax[0]
    assert len(port[1]) == len(jax[1])
    for got, want in zip(port[1], jax[1]):
        for p, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == np.uint16, p
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(p))


def _decodes_to(payloads, recons):
    dec = Decoder(device="cpu")
    outs = [o for o in map(dec.decode_frame_obus, payloads) if o is not None]
    assert len(outs) == len(recons)
    for out, rec in zip(outs, recons):
        for g, w in zip(out, rec):
            assert g.dtype == np.uint16
            np.testing.assert_array_equal(g, w)


# ---- all-intra --------------------------------------------------------------

@pytest.fixture(scope="module")
def intra():
    frames = synth_frames10(W, H, 3)
    with one_thread():
        port = tie.IntraEncoder(_cfg(tie), device="cpu").encode_frames(
            frames)
    return frames, port, jie.IntraEncoder(_cfg(jie)).encode_frames(frames)


def test_flat_intra_matches_jax_10bit(intra):
    _, port, jax = intra
    _same(port, jax)
    assert int(port[1][0][0].max()) > 255


def test_flat_intra_decodes_10bit(intra):
    _decodes_to(*intra[1])


# ---- low-delay I, P, P ------------------------------------------------------

@pytest.fixture(scope="module")
def ipp():
    frames = moving_frames10(W, H, 3)
    with one_thread():
        enc = tve.VideoEncoder(_cfg(tie), keyint=64, device="cpu")
        port, inter = ([], []), []
        for f in frames:
            p, r = enc.encode_frame(*f)
            port[0].append(p)
            port[1].append(r)
            inter.append(None if enc.last_p is None else
                         float((enc.last_p["y_mi"] >= 13).mean()))
    jenc = jve.VideoEncoder(_cfg(jie), keyint=64)
    jax = ([], [])
    for f in frames:
        p, r = jenc.encode_frame(*f)
        jax[0].append(p)
        jax[1].append(r)
    return frames, port, jax, inter


def test_flat_ipp_matches_jax_10bit(ipp):
    _, port, jax, inter = ipp
    _same(port, jax)
    assert max(len(p) for p in port[0][1:]) < len(port[0][0])
    assert min(inter[1:]) > 0, inter          # inter blocks in each P


def test_flat_ipp_decodes_10bit(ipp):
    _decodes_to(*ipp[1])


# ---- the pyramid, gop 4, TF -------------------------------------------------

def _pyramid(port, frames, rc, tf_hook):
    """(payloads, recons) of the port's (port=True) or JAX's pyramid;
    tf_hook(planes) sees each filtered anchor and returns the planes to
    code."""
    kw = dict(keyint=64, pyramid=True, gop=4, tf=True, rc=rc)
    enc = (tve.VideoEncoder(_cfg(tie), device="cpu", **kw) if port else
           jve.VideoEncoder(_cfg(jie), **kw))
    filt = enc._tf_filter
    enc._tf_filter = lambda *a: tf_hook(filt(*a))
    payloads, recons = enc.encode_frames(frames)
    p, r = enc.flush()
    return payloads + p, recons + r


@pytest.fixture(scope="module", params=["cq", "cbr"])
def pyramid(request):
    frames = moving_frames10(W, H, 9)
    mode = request.param
    rc = lambda m: None if mode == "cq" else m.RateControl(
        "cbr", qindex=Q, target_kbps=TBR, fps=30.0)
    planes, diffs = [], []
    with one_thread():
        port = _pyramid(True, frames, rc(trc),
                        lambda x: planes.append(x) or x)

    def port_planes(want):
        got = planes[len(diffs)]
        diffs.append(max(int(np.abs(g.astype(np.int32) -
                                    w_.astype(np.int32)).max())
                         for g, w_ in zip(got, want)))
        return got
    jax = _pyramid(False, frames, rc(jrc), port_planes)
    return mode, port, jax, diffs


def test_pyramid_matches_jax_10bit(pyramid):
    mode, port, jax, diffs = pyramid
    assert len(diffs) == 3 and max(diffs) <= 1      # key frame, 2 anchors
    _same(port, jax)
    assert len(port[1]) == 9 and len(port[0]) == 17    # 8 overlays


def test_pyramid_decodes_10bit(pyramid):
    _decodes_to(*pyramid[1])


# ---- the CLI ----------------------------------------------------------------

def _y4m(path, frames, bd):
    with open(path, "wb") as f:
        wtr = Y4mWriter(f, Y4mInfo(W, H, 30, 1, bit_depth=bd))
        for fr in frames:
            wtr.write_frame(*fr)


def _ivf(path):
    with open(path, "rb") as f:
        return [p for p, _ in read_ivf(f)[1]]


@pytest.mark.parametrize("bd,extra", [
    (10, []), (10, ["--film-grain", "20"]), (8, ["--film-grain", "20"])])
def test_cli_flat_intra_matches_jax_cli(tmp_path, bd, extra):
    """--keyint 1 --preset 13: the port's IVF is the JAX CLI's.  With
    --film-grain, 8-bit streams carry grain parameters and 10-bit ones
    none, in both packages."""
    frames = synth_frames10(W, H, 2) if bd == 10 else moving_frames(W, H, 2)
    src = tmp_path / "in.y4m"
    _y4m(src, frames, bd)
    args = ["-i", str(src), "--keyint", "1", "--preset", "13", *extra]
    assert app.main(args + ["-b", str(tmp_path / "t.ivf"), "--device",
                            "cpu"]) == 0
    assert japp.main(args + ["-b", str(tmp_path / "j.ivf")]) == 0
    got, want = _ivf(tmp_path / "t.ivf"), _ivf(tmp_path / "j.ivf")
    assert got == want
    if extra:
        dec = Decoder(device="cpu")
        for p in got:
            dec.decode_frame_obus(p)
        assert (dec.frame_header.film_grain is None) == (bd == 10)
