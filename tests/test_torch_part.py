"""The port's partition intra path (the CLI default) against the JAX
package at 128x64, q100, EncoderConfig defaults (tx search, DLF level
search), on the CPU.

One module fixture runs the JAX IntraEncoder once (about 100 s of XLA
compile) and the port on the same frames.  The source makes the JAX run
take every decision of the path: a flat 64x64 SB (SB NONE), a smooth
32x32 block (32 NONE), textured blocks (32 SPLIT) and non-DCT tx types on
their 16x16 leaves.  Maps, modes, tx indices, levels, recon and the DLF
level must be equal, and the payloads byte-identical.
``test_torch_part_edge.py`` runs the same checks at 128x56 (the bottom
32-row forced NONE, valid_h).
"""

from contextlib import contextmanager

import numpy as np
import pytest
import torch

from svtav1_tpu.encoder import intra_encoder as jie
from svtav1_tpu.utils.ivf import read_ivf
from svtav1_tpu.utils.y4m import Y4mInfo, Y4mWriter
from svtav1_tpu_torch import app
from svtav1_tpu_torch.encoder import intra_encoder as tie
from svtav1_tpu_torch.utils.obu import OBU_FRAME, parse_obus

# the "part" tuple of _device_encode_part, by index
FIELDS = {"part": 2, "y_mi": 3, "y_lev": 4, "y_smi": 5, "y_slev": 6,
          "u_lev": 7, "u_slev": 8, "v_lev": 9, "v_slev": 10, "y_stx": 11,
          "y_rec": 12, "u_rec": 13, "v_rec": 14, "part_sb": 16,
          "y_mi_sb": 17, "y_lev_sb": 18, "u_lev_sb": 19, "v_lev_sb": 20,
          "uv_mi": 21, "uv_smi": 22, "uv_mi_sb": 23}


def part_frames(w, h, n=2, seed=0):
    """Frames whose 128-wide luma holds a flat SB (cols 0-63), a smooth
    32x32 block (rows 0-31, cols 64-95), a busy 32x32 block (rows 0-31,
    cols 96-127: strong noise) and a mildly noisy sine pattern elsewhere;
    at q100 the DLF search then picks a level above 0."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for b in range(n):
        y = (120 + 20 * np.sin((xx + 5 * b) / 9.0) + 30 * np.cos(yy / 7.0) +
             rng.randint(-5, 6, (h, w)))
        busy = (xx >= 96) & (yy < 32)
        y = np.where(busy, y + 20 * np.sin(xx / 2.0 + yy / 3.0) +
                     rng.randint(-20, 21, (h, w)), y)
        y = np.where(xx < 64, 90 + xx // 16, y)
        smooth = (xx >= 64) & (xx < 96) & (yy < 32)
        y = np.where(smooth, 150 + (xx - 64) // 4 + yy // 8, y)
        u = 120 + 30 * np.sin(xx[::2, ::2] / 5.0 + b) + \
            rng.randint(-8, 9, (h // 2, w // 2))
        v = 130 + 25 * np.cos(yy[::2, ::2] / 4.0) + \
            rng.randint(-8, 9, (h // 2, w // 2))
        frames.append(tuple(np.clip(p, 0, 255).astype(np.uint8)
                            for p in (y, u, v)))
    return frames


@contextmanager
def one_thread():
    """The port's CPU ops on one thread: its tensors are small, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def run_both(w, h):
    """The JAX package and the port (CPU) on part_frames(w, h), defaults;
    and the port alone with tx_search=False (preset 10)."""
    with one_thread():
        return _run_both(w, h)


def _run_both(w, h):
    frames = part_frames(w, h)
    jenc = jie.IntraEncoder(jie.EncoderConfig(w, h, qindex=100))
    jdev = jenc.device_encode(frames)
    jnp_dev = tuple(np.asarray(a) if hasattr(a, "shape") else a
                    for a in jdev)
    jpay, _ = jenc.host_finish(jdev)
    tenc = tie.IntraEncoder(tie.EncoderConfig(w, h, qindex=100),
                            device="cpu")
    tdev = tenc.device_encode(frames)
    tpay, trec = tenc.host_finish(tdev)
    t10 = tie.IntraEncoder(tie.EncoderConfig(w, h, qindex=100,
                                             tx_search=False), device="cpu")
    dev10 = t10.device_encode(frames)
    pay10, _ = t10.host_finish(dev10)
    return dict(frames=frames, jdev=jnp_dev, jpay=jpay, tdev=tdev, tpay=tpay,
                trec=trec, dev10=dev10, pay10=pay10, w=w, h=h)


@pytest.fixture(scope="module")
def both():
    return run_both(128, 64)


def check_decisions(jdev, edge=False):
    """The JAX run took every decision the path has."""
    part, part_sb, stx = (jdev[FIELDS[k]] for k in ("part", "part_sb",
                                                    "y_stx"))
    assert (part_sb == 0).any(), "no 64x64 SB NONE"
    # 32x32 blocks of split SBs
    in_split_sb = np.repeat(np.repeat(part_sb, 2, 1), 2, 2) == 1
    assert (part[in_split_sb] == 0).any(), "no 32x32 NONE"
    assert (part[in_split_sb] == 1).any(), "no 32x32 SPLIT"
    leaves = np.repeat(part[..., None], 4, -1) == 1
    assert (stx[leaves & in_split_sb[..., None]] != 0).any(), \
        "no non-DCT tx type on a coded 16x16 leaf"
    if edge:
        assert (part[:, -1] == 0).all(), "bottom 32-row not forced NONE"


def test_decisions_occur(both):
    check_decisions(both["jdev"])


@pytest.mark.parametrize("field", list(FIELDS))
def test_device_tuple_matches_jax(both, field):
    k = FIELDS[field]
    got = both["tdev"][k].numpy()
    want = both["jdev"][k]
    assert got.shape == want.shape, field
    np.testing.assert_array_equal(got, want, err_msg=field)


def test_dlf_level_matches_jax(both):
    assert both["tdev"][24] == both["jdev"][24]
    assert both["tdev"][24][0] > 0


def test_payloads_match_jax(both):
    assert both["tpay"] == both["jpay"]
    for p in both["tpay"]:
        assert any(t == OBU_FRAME and len(d) for t, _, _, d in parse_obus(p))
    rec = both["trec"][0]
    assert rec[0].shape == (both["h"], both["w"])
    assert rec[1].shape == (both["h"] // 2, both["w"] // 2)


def test_tx_search_off_codes_dct_only(both):
    dev10 = both["dev10"]
    assert not dev10[11].any()                    # y_stx
    assert dev10[2].shape == both["tdev"][2].shape
    assert all(len(p) > 50 for p in both["pay10"])


def _write_y4m(path, frames, w, h):
    with open(path, "wb") as f:
        wtr = Y4mWriter(f, Y4mInfo(w, h, 30, 1))
        for fr in frames:
            wtr.write_frame(*fr)


def _read_payloads(path):
    with open(path, "rb") as f:
        _, frames = read_ivf(f)
        return [p for p, _ in frames]


@pytest.mark.parametrize("preset", [None, 10])
def test_cli_partition_path(both, tmp_path, preset):
    """The CLI's default mode and --preset 10 at 128x64 on the CPU: the
    payloads equal the fixture's (JAX's for the default)."""
    src, out = tmp_path / "in.y4m", tmp_path / "out.ivf"
    _write_y4m(src, both["frames"], both["w"], both["h"])
    extra = [] if preset is None else ["--preset", str(preset)]
    with one_thread():
        rc = app.main(["-i", str(src), "-b", str(out), "--keyint", "1",
                       "--device", "cpu", *extra])
    assert rc == 0
    want = both["jpay"] if preset is None else both["pay10"]
    assert _read_payloads(out) == want
