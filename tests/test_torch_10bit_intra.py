"""The port's 10-bit partition all-intra path with CDEF, loop restoration
and CCSO against the JAX package at 128x64, q100, on the CPU.

One module fixture runs the port on one frame of the 10-bit edge clip
(``cuda/inputs.edge_frames10``: all three filters fire) and reads the JAX
IntraEncoder's results on the same frame from
``tests/data/torch_10bit/intra.npz`` (written by its
``make_fixtures.py``, which runs the JAX package; no JAX scan is
compiled here).  Every field of the device tuple, the DLF level, the
payload and the uint16 recon must be equal; the port's Decoder decodes
the port's stream to its recon.  The CLI at its defaults (the low-delay
path, here its key frame: one frame of the clip) writes the JAX CLI's
IVF bytes (the fixture's ``cli_*``) and a 10-bit recon Y4M.
"""

from pathlib import Path

import numpy as np
import pytest

from svtav1_tpu_torch import app
from svtav1_tpu_torch.cuda.inputs import edge_frames10
from svtav1_tpu_torch.decoder.decoder import Decoder
from svtav1_tpu_torch.encoder import intra_encoder as tie
from svtav1_tpu_torch.utils.ivf import read_ivf
from svtav1_tpu_torch.utils.obu import OBU_FRAME, parse_obus
from svtav1_tpu_torch.utils.y4m import Y4mInfo, Y4mReader, Y4mWriter
from test_torch_part import FIELDS, one_thread

W, H, Q, BD = 128, 64, 100, 10
FILTERS = dict(enable_cdef=True, enable_lr=True, enable_ccso=True)
FIX = Path(__file__).resolve().parent / "data" / "torch_10bit" / "intra.npz"


def _payloads_of(fix, prefix):
    n = sum(k.startswith(prefix) for k in fix)
    return [fix[f"{prefix}{i}"].tobytes() for i in range(n)]


@pytest.fixture(scope="module")
def both():
    frames = edge_frames10(W, H, 1)
    with np.load(FIX) as d:
        fix = {k: d[k] for k in d.files}
    jdev = {k: fix[f"dev_{k}"] for k in FIELDS.values()}
    jdev[24] = tuple(int(x) for x in fix["lf"])
    jpay = _payloads_of(fix, "pay_")
    jrec = [tuple(fix[f"rec_{i}_{p}"] for p in range(3))
            for i in range(len(jpay))]
    with one_thread():
        tenc = tie.IntraEncoder(tie.EncoderConfig(W, H, qindex=Q,
                                                  bit_depth=BD, **FILTERS),
                                device="cpu")
        decisions = []
        run = tenc._filter_frame
        tenc._filter_frame = lambda *a, **k: decisions.append(
            run(*a, **k)) or decisions[-1]
        tdev = tenc.device_encode(frames)
        tpay, trec = tenc.host_finish(tdev)
    return dict(frames=frames, jdev=jdev, jpay=jpay, jrec=jrec, tdev=tdev,
                tpay=tpay, trec=trec, decisions=decisions,
                jcli=_payloads_of(fix, "cli_"))


@pytest.mark.parametrize("field", list(FIELDS))
def test_device_tuple_matches_jax(both, field):
    k = FIELDS[field]
    got = both["tdev"][k].numpy()
    want = both["jdev"][k]
    assert got.shape == want.shape, field
    np.testing.assert_array_equal(got, want, err_msg=field)


def test_dlf_level_matches_jax(both):
    assert both["tdev"][24] == both["jdev"][24]


def test_payloads_match_jax(both):
    assert both["tpay"] == both["jpay"]
    assert any(t == OBU_FRAME and len(d)
               for t, _, _, d in parse_obus(both["tpay"][0]))


def test_recons_match_jax(both):
    for got, want in zip(both["trec"], both["jrec"]):
        for p, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == np.uint16, p
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(p))
    assert int(both["trec"][0][0].max()) > 255


def test_every_filter_fires(both):
    """CDEF (a nonzero strength), CCSO (a plane on) and LR (a unit on)."""
    (_, cdef, ccso, lr_types, _), = both["decisions"]
    assert any(any(s) for s in cdef["y_strengths"] + cdef["uv_strengths"])
    assert ccso is not None and any(p is not None for p in ccso["planes"])
    assert any(lr_types)


def test_decoder_decodes_the_port_stream(both):
    with one_thread():
        dec = Decoder(ccso=True, device="cpu")
        outs = [o for o in map(dec.decode_frame_obus, both["tpay"])
                if o is not None]
    assert len(outs) == 1
    for g, w in zip(outs[0], both["trec"][0]):
        assert g.dtype == np.uint16
        np.testing.assert_array_equal(g, w)


def _payloads(path):
    with open(path, "rb") as f:
        return [p for p, _ in read_ivf(f)[1]]


def test_cli_defaults_10bit(both, tmp_path):
    """The CLI's defaults (the low-delay partition path, its key frame at
    q70) on a one-frame C420p10 Y4M: the port's IVF equals the JAX CLI's,
    and -o writes a 10-bit recon Y4M equal to the decoded stream."""
    src = tmp_path / "in.y4m"
    with open(src, "wb") as f:
        wtr = Y4mWriter(f, Y4mInfo(W, H, 30, 1, bit_depth=BD))
        wtr.write_frame(*both["frames"][0])
    out, rec = tmp_path / "t.ivf", tmp_path / "r.y4m"
    with one_thread():
        assert app.main(["-i", str(src), "-b", str(out), "-o", str(rec),
                         "--device", "cpu", "--stat-report"]) == 0
    got = _payloads(out)
    assert got == both["jcli"]
    with open(rec, "rb") as f:
        rdr = Y4mReader(f)
        assert rdr.info.bit_depth == BD
        frames = list(rdr.frames())
    with one_thread():
        dec = Decoder(device="cpu")
        outs = [o for o in map(dec.decode_frame_obus, got) if o is not None]
    assert len(frames) == len(outs) == 1
    for g, w in zip(frames[0], outs[0]):
        assert g.dtype == np.uint16
        np.testing.assert_array_equal(g, w)
