"""The port's compound partition pyramid at 10 bits against the JAX
package at 128x64, q100, on the CPU: a GoP of 2 of the 10-bit moving clip
(``cuda/inputs.moving_frames10``): key frame, no-show anchor, no-show
compound frame, overlays.

One module fixture encodes the clip with the port's VideoEncoder
(``pyramid=True, gop=2``) and reads the JAX side from
``tests/data/torch_10bit/part_pyramid.npz`` (written by its
``make_fixtures.py``): a JAX VideoEncoder given the port's pyramid state
just before the compound frame (the DPB slots of the key frame and the
anchor, the anchor's CDF snapshot copied into a JAX CdfContext, display
indices, GM parameters) codes the compound frame alone through its
``_encode_ref_frame``.  The file keeps the MD5 of the port's key frame
and anchor that made that state; no JAX scan is compiled here.  The
compound frame's every decision map, the 4-component mv fields, q, the
DLF level, the uint16 recon and the payload must equal the port's; the
port's stream decodes in the JAX Decoder and in the port's to the port's
recons.  (``test_torch_part_pyramid.py`` holds the anchors and deeper
pyramids at 8 bits.)
"""

from pathlib import Path

import numpy as np
import pytest

from svtav1_tpu.decoder.decoder import Decoder as JaxDecoder
from svtav1_tpu_torch.cuda.inputs import moving_frames10
from svtav1_tpu_torch.decoder.decoder import Decoder
from svtav1_tpu_torch.encoder import intra_encoder as tie
from svtav1_tpu_torch.encoder import video_encoder as tve
from svtav1_tpu_torch.spec import mv as MV
from test_torch_10bit_video import payload_md5
from test_torch_part import one_thread
from test_torch_part_pyramid import MAPS

W, H, Q, BD = 128, 64, 100, 10
FIX = (Path(__file__).resolve().parent / "data" / "torch_10bit" /
       "part_pyramid.npz")


@pytest.fixture(scope="module")
def runs():
    frames = moving_frames10(W, H, 3)
    enc = tve.VideoEncoder(tie.EncoderConfig(W, H, qindex=Q, bit_depth=BD),
                           keyint=64, pyramid=True, gop=2, device="cpu")
    coded = []
    code = enc._encode_p_part

    def spy_code(*a, **kw):
        out = code(*a, **kw)
        coded.append(dict(enc.last_p, payload=out[0], rec=out[1]))
        return out

    enc._encode_p_part = spy_code
    with one_thread():
        payloads, recons = enc.encode_frames(frames)
        tail, rtail = enc.flush()
    port = dict(payloads=payloads + tail, recons=recons + rtail,
                coded=coded)
    with np.load(FIX) as d:
        fix = {k: d[k] for k in d.files}
    # the JAX compound frame started from the state these two made
    assert payload_md5([port["payloads"][0], coded[0]["payload"]]) == \
        str(fix["state_md5"]), \
        "the port's key frame or anchor changed: rewrite the fixture"
    want = dict({m: fix[f"map_{m}"] for m in MAPS}, q=fix["q"],
                lf=fix["lf"], comp=fix["comp"],
                payload=fix["payload"].tobytes(),
                rec=tuple(fix[f"rec_{p}"] for p in range(3)))
    return dict(frames=frames, port=port, jax=want)


def test_the_port_codes_a_10bit_compound_gop(runs):
    coded = runs["port"]["coded"]
    assert [m["comp"] for m in coded] == [False, True]
    assert runs["port"]["recons"][0][0].dtype == np.uint16
    m = coded[1]
    assert m["mode_counts"][MV.NEW_NEWMV] + \
        m["mode_counts"][MV.NEAREST_NEARESTMV] + \
        m["mode_counts"][MV.GLOBAL_GLOBALMV] > 0


@pytest.mark.parametrize("field", MAPS + ("q", "lf", "comp"))
def test_compound_frame_decisions(runs, field):
    np.testing.assert_array_equal(np.asarray(runs["port"]["coded"][1][field]),
                                  np.asarray(runs["jax"][field]),
                                  err_msg=field)


def test_compound_frame_payload(runs):
    assert runs["port"]["coded"][1]["payload"] == runs["jax"]["payload"]


def test_compound_frame_recon(runs):
    for p, (g, w_) in enumerate(zip(runs["port"]["coded"][1]["rec"],
                                    runs["jax"]["rec"])):
        assert g.dtype == np.uint16
        np.testing.assert_array_equal(g.astype(np.int32),
                                      np.asarray(w_, np.int32),
                                      err_msg=f"plane {p}")


@pytest.mark.parametrize("decoder", ["jax", "port"])
def test_decoders_decode_the_ports_stream(runs, decoder):
    dec = JaxDecoder() if decoder == "jax" else Decoder(device="cpu")
    with one_thread():
        out = [f for f in (dec.decode_frame_obus(p)
                           for p in runs["port"]["payloads"])
               if f is not None]
    recons = runs["port"]["recons"]
    assert len(out) == len(recons) == 3
    for k, (g, w_) in enumerate(zip(out, recons)):
        for p in range(3):
            np.testing.assert_array_equal(np.asarray(g[p]), w_[p],
                                          err_msg=f"frame {k} plane {p}")
