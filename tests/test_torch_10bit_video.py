"""The port's 10-bit low-delay partition path (the CLI default, --keyint
64) against the JAX package at 128x64, q100, on the CPU: I, P, P of the
10-bit moving clip (``cuda/inputs.moving_frames10``).

One module fixture encodes the three frames with the port's
VideoEncoder and reads the JAX VideoEncoder's two P frames from
``tests/data/torch_10bit/video.npz`` (written by its ``make_fixtures.py``:
the JAX encoder's state set to what the port holds after its key frame,
whose payload's MD5 the file keeps; the port's 10-bit key frames are held
to JAX by ``test_torch_10bit_intra.py``; no JAX scan is compiled here).
JAX's decision maps are those of its ``SVT_DUMP_DIR`` dump.  On both P
frames every decision map and mv field, the DLF level, the uint16 recon
and the payload must be equal; the port's Decoder decodes the port's
stream to its recons; the CLI at its defaults on the clip writes the port
encoder's payloads.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest

from svtav1_tpu_torch import app
from svtav1_tpu_torch.cuda.inputs import moving_frames10
from svtav1_tpu_torch.decoder.decoder import Decoder
from svtav1_tpu_torch.encoder import intra_encoder as tie
from svtav1_tpu_torch.encoder import video_encoder as tve
from svtav1_tpu_torch.utils.ivf import read_ivf
from svtav1_tpu_torch.utils.obu import OBU_FRAME, parse_obus
from svtav1_tpu_torch.utils.y4m import Y4mInfo, Y4mWriter
from test_torch_part import one_thread
from test_torch_video import MAPS

W, H, Q, BD = 128, 64, 100, 10
FIX = Path(__file__).resolve().parent / "data" / "torch_10bit" / "video.npz"


def payload_md5(payloads):
    """The fixture's MD5 of a list of payloads (lengths and bytes)."""
    m = hashlib.md5()
    for p in payloads:
        m.update(len(p).to_bytes(4, "little"))
        m.update(p)
    return m.hexdigest()


@pytest.fixture(scope="module")
def runs():
    frames = moving_frames10(W, H, 3)
    with one_thread():
        enc = tve.VideoEncoder(tie.EncoderConfig(W, H, qindex=Q,
                                                 bit_depth=BD),
                               keyint=64, device="cpu")
        port, maps = [], []
        for f in frames:
            port.append(enc.encode_frame(*f))
            maps.append(enc.last_p)
    with np.load(FIX) as d:
        fix = {k: d[k] for k in d.files}
    # the JAX P frames started from this key frame
    assert payload_md5([port[0][0]]) == str(fix["state_md5"]), \
        "the port's key frame changed: rewrite the fixture"
    jax_out, dumps = [None], [None]
    for k in (1, 2):
        jax_out.append((fix[f"pay_{k}"].tobytes(),
                        tuple(fix[f"rec_{k}_{p}"] for p in range(3))))
        dumps.append(dict({m: fix[f"map_{k}_{m}"] for m in MAPS},
                          lf=tuple(int(x) for x in fix[f"lf_{k}"])))
    return dict(frames=frames, port=port, maps=maps, jax=jax_out,
                dumps=dumps)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", MAPS)
def test_p_frame_map_10bit(runs, k, name):
    got, want = runs["maps"][k][name], runs["dumps"][k][name]
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
