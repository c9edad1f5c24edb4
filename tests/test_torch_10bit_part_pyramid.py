"""The port's compound partition pyramid at 10 bits against the JAX
package at 128x64, q100, on the CPU: a GoP of 2 of the 10-bit moving clip
(``cuda/inputs.moving_frames10``): key frame, no-show anchor, no-show
compound frame, overlays.

One module fixture encodes the clip with the port's VideoEncoder
(``pyramid=True, gop=2``) and records its pyramid state just before the
compound frame (the DPB slots of the key frame and the anchor, the
anchor's CDF snapshot, display indices, GM parameters).  A JAX
VideoEncoder given that state (the snapshot copied into a JAX
CdfContext) codes the compound frame alone through its
``_encode_ref_frame``, so the JAX side compiles only the compound path at
bd=10.  Its every decision map, the 4-component mv fields, q, the DLF
level, the uint16 recon and the payload must equal the port's; the port's
stream decodes in the JAX Decoder and in the port's to the port's
recons.  (``test_torch_part_pyramid.py`` holds the anchors and deeper
pyramids at 8 bits.)
"""

import copy
import os
import pickle

import numpy as np
import pytest

from svtav1_tpu.decoder.decoder import Decoder as JaxDecoder
from svtav1_tpu.encoder import intra_encoder as jie
from svtav1_tpu.encoder import video_encoder as jve
from svtav1_tpu.spec import cdf as jcdf
from svtav1_tpu_torch.cuda.inputs import moving_frames10
from svtav1_tpu_torch.decoder.decoder import Decoder
from svtav1_tpu_torch.encoder import intra_encoder as tie
from svtav1_tpu_torch.encoder import video_encoder as tve
from svtav1_tpu_torch.spec import mv as MV
from test_torch_part import one_thread
from test_torch_part_pyramid import MAPS

W, H, Q, BD = 128, 64, 100, 10


def _jax_cdf(snap):
    """The port's CDF snapshot as a JAX CdfContext (the same tables)."""
    if snap is None:
        return None
    c = object.__new__(jcdf.CdfContext)
    c.update_enabled = snap.update_enabled
    c._t = {k: v.copy() for k, v in snap._t.items()}
    return c


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    frames = moving_frames10(W, H, 3)
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
        coded.append(dict(enc.last_p, payload=out[0], rec=out[1]))
        return out

    enc._encode_p_part = spy_code
    with one_thread():
        payloads, recons = enc.encode_frames(frames)
        tail, rtail = enc.flush()
    port = dict(payloads=payloads + tail, recons=recons + rtail,
                coded=coded)

    jenc = jve.VideoEncoder(jie.EncoderConfig(W, H, qindex=Q, bit_depth=BD),
                            keyint=64, pyramid=True, gop=2)
    jenc._slots = {s: tuple(np.asarray(p, np.int32) for p in r)
                   for s, r in state["slots"].items()}
    jenc._slot_cdf = {s: _jax_cdf(c) for s, c in state["slot_cdf"].items()}
    jenc._slot_t, jenc._slot_gm = state["slot_t"], state["slot_gm"]
    dump = tmp_path_factory.mktemp("compound10")
    saved = os.environ.get("SVT_DUMP_DIR")
    os.environ["SVT_DUMP_DIR"] = str(dump)
    try:
        comp = coded[1]
        payload, rec = jenc._encode_ref_frame(frames[1], [0, 1], comp["q"],
                                              2, False, refresh_t=1,
                                              layer=1)
    finally:
        if saved is None:
            del os.environ["SVT_DUMP_DIR"]
        else:
            os.environ["SVT_DUMP_DIR"] = saved
    with open(dump / "pframe_000.pkl", "rb") as f:
        d = pickle.load(f)
    want = dict({m: d[m][0] for m in MAPS}, q=d["q"], lf=d["lf"],
                comp=d["comp"], payload=payload, rec=rec)
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
