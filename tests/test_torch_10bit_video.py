"""The port's 10-bit low-delay partition path (the CLI default, --keyint
64) against the JAX package at 128x64, q100, on the CPU: I, P, P of the
10-bit moving clip (``cuda/inputs.moving_frames10``).

One module fixture encodes the three frames with the port's
VideoEncoder, then sets the JAX VideoEncoder's state to what it holds
after that key frame (its DPB is the port's uint16 key-frame recon; the
port's 10-bit key frames are held to JAX by ``test_torch_10bit_intra.py``)
and encodes the two P frames with it, so the JAX side compiles only the P
path at bd=10 (most of the file's time).  JAX's decision maps come from
its ``SVT_DUMP_DIR`` dump.  On both P frames every decision map and mv
field, the DLF level, the uint16 recon and the payload must be equal; the
port's Decoder decodes the port's stream to its recons; the CLI at its
defaults on the clip writes the port encoder's payloads.
"""

import os
import pickle

import numpy as np
import pytest

from svtav1_tpu.encoder import intra_encoder as jie
from svtav1_tpu.encoder import video_encoder as jve
from svtav1_tpu.utils.ivf import read_ivf
from svtav1_tpu_torch import app
from svtav1_tpu_torch.cuda.inputs import moving_frames10
from svtav1_tpu_torch.decoder.decoder import Decoder
from svtav1_tpu_torch.encoder import intra_encoder as tie
from svtav1_tpu_torch.encoder import video_encoder as tve
from svtav1_tpu_torch.utils.obu import OBU_FRAME, parse_obus
from svtav1_tpu_torch.utils.y4m import Y4mInfo, Y4mWriter
from test_torch_part import one_thread
from test_torch_video import MAPS

W, H, Q, BD = 128, 64, 100, 10


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    frames = moving_frames10(W, H, 3)
    with one_thread():
        enc = tve.VideoEncoder(tie.EncoderConfig(W, H, qindex=Q,
                                                 bit_depth=BD),
                               keyint=64, device="cpu")
        port, maps = [], []
        for f in frames:
            port.append(enc.encode_frame(*f))
            maps.append(enc.last_p)
        jenc = jve.VideoEncoder(jie.EncoderConfig(W, H, qindex=Q,
                                                  bit_depth=BD), keyint=64)
        jenc._dpb = tuple(np.asarray(p, np.int32) for p in port[0][1])
        jenc._idx, jenc._kf_at = 1, 64
        jenc._tail_src = np.asarray(frames[0][0], np.int32)[::4, ::4]
        dump = tmp_path_factory.mktemp("pframes10")
        saved = os.environ.get("SVT_DUMP_DIR")
        os.environ["SVT_DUMP_DIR"] = str(dump)
        try:
            jax_out = [None] + [jenc.encode_frame(*f) for f in frames[1:]]
        finally:
            if saved is None:
                del os.environ["SVT_DUMP_DIR"]
            else:
                os.environ["SVT_DUMP_DIR"] = saved
    dumps = [None]
    for k in range(2):
        with open(dump / f"pframe_{k:03d}.pkl", "rb") as f:
            dumps.append(pickle.load(f))
    return dict(frames=frames, port=port, maps=maps, jax=jax_out,
                dumps=dumps)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", MAPS)
def test_p_frame_map_10bit(runs, k, name):
    got, want = runs["maps"][k][name], runs["dumps"][k][name][0]
    assert got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("k", [1, 2])
def test_p_frame_dlf_level_10bit(runs, k):
    assert tuple(runs["maps"][k]["lf"]) == tuple(runs["dumps"][k]["lf"])


@pytest.mark.parametrize("k", [1, 2])
def test_p_frame_recon_10bit(runs, k):
    for p, (got, want) in enumerate(zip(runs["port"][k][1],
                                        runs["jax"][k][1])):
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, np.asarray(want),
                                      err_msg=f"plane {p}")


@pytest.mark.parametrize("k", [1, 2])
def test_p_frame_payload_10bit(runs, k):
    got, want = runs["port"][k][0], runs["jax"][k][0]
    assert any(t == OBU_FRAME for t, _, _, _ in parse_obus(got))
    assert got == want


def test_the_clip_takes_the_inter_path_10bit(runs):
    """Below the scene-cut threshold: the P frames code inter blocks at the
    panned global motion, NEWMV and other modes, smaller than the key
    frame."""
    sizes = [len(p) for p, _ in runs["port"]]
    assert max(sizes[1:]) < sizes[0], sizes
    for k in (1, 2):
        m = runs["maps"][k]
        assert m["gm"] == (-16, -24), m["gm"]
        assert m["mode_counts"][16] > 0 and \
            sum(m["mode_counts"].values()) > m["mode_counts"][16]


def test_decoder_decodes_the_port_stream_10bit(runs):
    with one_thread():
        dec = Decoder(device="cpu")
        outs = [dec.decode_frame_obus(p) for p, _ in runs["port"]]
    for out, (_, rec) in zip(outs, runs["port"]):
        for g, w in zip(out, rec):
            assert g.dtype == np.uint16
            np.testing.assert_array_equal(g, w)


def test_cli_defaults_write_the_encoders_payloads_10bit(runs, tmp_path):
    """The CLI at its defaults (--keyint 64, the partition path) on the
    clip as a C420p10 Y4M: the IVF holds the port's VideoEncoder's
    payloads, whose P frames the tests above hold to JAX's."""
    src, out = tmp_path / "in.y4m", tmp_path / "out.ivf"
    with open(src, "wb") as f:
        wtr = Y4mWriter(f, Y4mInfo(W, H, 30, 1, bit_depth=BD))
        for fr in runs["frames"]:
            wtr.write_frame(*fr)
    with one_thread():
        assert app.main(["-i", str(src), "-b", str(out), "--device",
                         "cpu"]) == 0
    with open(out, "rb") as f:
        got = [p for p, _ in read_ivf(f)[1]]
    assert got == [p for p, _ in runs["port"]]
