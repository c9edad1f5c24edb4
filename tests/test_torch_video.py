"""The port's low-delay inter path (the CLI default, --keyint 64) against
the JAX package at 128x64, q100, EncoderConfig defaults, on the CPU.

One module fixture encodes three frames of a panned texture (I, P, P) with
the port's VideoEncoder, then sets the JAX VideoEncoder's state to what it
holds after that key frame (its DPB is the port's key-frame recon; the
port's key frames are held to JAX by ``test_torch_part.py``) and encodes
the two P frames with it, so the JAX side compiles the P path only (most
of the file's few minutes).  JAX's decision maps come from its ``SVT_DUMP_DIR``
dump.  On both P frames (the second on the CDF chain) every decision map
and mv field, the DLF level, the recon and the payload must be equal.

At the fixture's shapes and static arguments, so that this worker's JAX
jit cache serves them, the file also holds motion_estimate (16/32/64),
predict_inter_blocks (luma 64/32/16, chroma 32/16/8, the three filters,
the 56-row UMV clamp) and the inter scans (luma, paired chroma) against
JAX on random inputs; and the CLI with --keyint 64, its flat path
(presets 11-13, --no-part-search), --pyramid [--tf] on the partition
path and --rc cbr without --tbr, which exits 2.

Rate control on this path: I, P, P under CBR with the port's VideoEncoder
and with the JAX one, whose state is again set to what it holds after the
port's key frame (the same key frame: the rate controller starts at the
fixture's qindex) and whose controller has counted its bytes; the P frames
run at other qindexes on JAX's jit entries of the fixture (the qindex is a
traced argument of its scans, so nothing recompiles).  The q of each P
frame, every map, the DLF level, the recon and the payload must be equal;
the CLI's --rc cbr --tbr gives the port's encoder's payloads.
"""

import os
import pickle
from contextlib import contextmanager

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.encoder import intra_encoder as jie
from svtav1_tpu import app as japp
from svtav1_tpu.encoder import me as jme
from svtav1_tpu.encoder import rate_control as jrc
from svtav1_tpu.encoder import video_encoder as jve
from svtav1_tpu.encoder import wavefront2 as jw2
from svtav1_tpu.ops import mc as jmc
from svtav1_tpu.spec import txfm as jT
from svtav1_tpu.utils.ivf import read_ivf
from svtav1_tpu.utils.y4m import Y4mInfo, Y4mWriter
from svtav1_tpu_torch import app
from svtav1_tpu_torch.cuda.inputs import moving_frames
from svtav1_tpu_torch.encoder import geometry as tgeo
from svtav1_tpu_torch.encoder import intra_encoder as tie
from svtav1_tpu_torch.encoder import me as tme
from svtav1_tpu_torch.encoder import presets as tpresets
from svtav1_tpu_torch.encoder import rate_control as trc
from svtav1_tpu_torch.encoder import video_encoder as tve
from svtav1_tpu_torch.encoder import wavefront2 as tw2
from svtav1_tpu_torch.ops import mc as tmc
from svtav1_tpu_torch.utils.obu import OBU_FRAME, parse_obus

W, H, Q = 128, 64, 100
TBR = 150            # kbps of the CBR runs: q moves every frame
BH, BW, SH, SW = H // 32, W // 32, H // 64, W // 64
N, NSB = BH * BW, SH * SW

# P-frame maps of the JAX dump (leading tile axis) and the port's last_p
MAPS = ("part", "y_mi", "y_lev", "y_smi", "y_slev", "y_stx", "part_sb",
        "y_mi_sb", "y_lev_sb", "u_lev", "v_lev", "u_slev", "v_slev",
        "u_lev_sb", "v_lev_sb", "mv_t", "mv_s", "mv_sb")


@contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread: its tensors are small (more
    threads only add overhead to them), and the test workers share the
    machine's cores."""
    with one_thread():
        yield


def _port_ipp(frames, rc=None):
    """The port's I, P, P at the fixture's configuration: (payload, recon)
    and last_p of each frame."""
    with one_thread():
        enc = tve.VideoEncoder(tie.EncoderConfig(W, H, qindex=Q), keyint=64,
                               rc=rc, device="cpu")
        port, maps = [], []
        for f in frames:
            port.append(enc.encode_frame(*f))
            maps.append(enc.last_p)
    return port, maps


def _jax_pp(frames, key, dump, rc=None):
    """The JAX VideoEncoder's two P frames after the port's key frame
    (payload, recon): its state set to what VideoEncoder.encode_frame
    leaves after it, int32 planes, as its P frames leave them (one
    motion_estimate signature); its controller has counted the key frame.
    Returns the P frames and their SVT_DUMP_DIR dumps."""
    jenc = jve.VideoEncoder(jie.EncoderConfig(W, H, qindex=Q), keyint=64,
                            rc=rc)
    jenc._dpb = tuple(np.asarray(p, np.int32) for p in key[1])
    jenc._idx, jenc._kf_at = 1, 64
    jenc._tail_src = np.asarray(frames[0][0], np.int32)[::4, ::4]
    if rc is not None:
        rc.update(len(key[0]), 1)
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
    return jax_out, dumps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    frames = moving_frames(W, H, 3)
    port, maps = _port_ipp(frames)
    jax_out, dumps = _jax_pp(frames, port[0],
                             tmp_path_factory.mktemp("pframes"))
    return dict(frames=frames, port=port, maps=maps, jax=jax_out,
                dumps=dumps)


@pytest.fixture(scope="module")
def rc_runs(runs, tmp_path_factory):
    """I, P, P under CBR on both sides (the fixture's key frame)."""
    frames = runs["frames"]
    port, maps = _port_ipp(frames, trc.RateControl(
        "cbr", qindex=Q, target_kbps=TBR, fps=30.0))
    jax_out, dumps = _jax_pp(frames, port[0],
                             tmp_path_factory.mktemp("rc_pframes"),
                             jrc.RateControl("cbr", qindex=Q,
                                             target_kbps=TBR, fps=30.0))
    return dict(frames=frames, port=port, maps=maps, jax=jax_out,
                dumps=dumps)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", MAPS)
def test_p_frame_map(runs, k, name):
    got, want = runs["maps"][k][name], runs["dumps"][k][name][0]
    assert got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("k", [1, 2])
def test_p_frame_dlf_level(runs, k):
    assert tuple(runs["maps"][k]["lf"]) == tuple(runs["dumps"][k]["lf"])


@pytest.mark.parametrize("k", [1, 2])
def test_p_frame_recon(runs, k):
    for p, (got, want) in enumerate(zip(runs["port"][k][1],
                                        runs["jax"][k][1])):
        np.testing.assert_array_equal(np.asarray(got, np.int32),
                                      np.asarray(want, np.int32),
                                      err_msg=f"plane {p}")


@pytest.mark.parametrize("k", [1, 2])
def test_p_frame_payload(runs, k):
    got, want = runs["port"][k][0], runs["jax"][k][0]
    assert any(t == OBU_FRAME for t, _, _, _ in parse_obus(got))
    assert got == want


def test_rc_key_frame_is_the_fixtures(runs, rc_runs):
    assert rc_runs["port"][0][0] == runs["port"][0][0]


def test_rc_q_sequence(runs, rc_runs):
    """Each P frame's qindex equals JAX's, and CBR moves it: P1 off the
    fixture's q, P2 off P1's."""
    got = [rc_runs["maps"][k]["q"] for k in (1, 2)]
    assert got == [rc_runs["dumps"][k]["q"] for k in (1, 2)]
    assert runs["maps"][1]["q"] == Q != got[0] != got[1]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", MAPS)
def test_rc_p_frame_map(rc_runs, k, name):
    got, want = rc_runs["maps"][k][name], rc_runs["dumps"][k][name][0]
    assert got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("k", [1, 2])
def test_rc_p_frame_dlf_recon_payload(rc_runs, k):
    assert tuple(rc_runs["maps"][k]["lf"]) == \
        tuple(rc_runs["dumps"][k]["lf"])
    for p, (got, want) in enumerate(zip(rc_runs["port"][k][1],
                                        rc_runs["jax"][k][1])):
        np.testing.assert_array_equal(np.asarray(got, np.int32),
                                      np.asarray(want, np.int32),
                                      err_msg=f"plane {p}")
    assert rc_runs["port"][k][0] == rc_runs["jax"][k][0]


def test_the_clip_takes_the_inter_path(runs):
    """The P frames code inter blocks at a panned global motion, and code
    smaller than the key frame."""
    sizes = [len(p) for p, _ in runs["port"]]
    assert max(sizes[1:]) < sizes[0], sizes
    for k in (1, 2):
        m = runs["maps"][k]
        assert m["gm"] == (-16, -24), m["gm"]
        assert (m["y_mi"] >= 13).any() or (m["y_mi_sb"] >= 13).any()
        assert m["mode_counts"][16] > 0 and \
            sum(m["mode_counts"].values()) > m["mode_counts"][16]


# ---- device-side modules at the fixture's shapes ---------------------------

@pytest.mark.parametrize("bs", [16, 32, 64])
def test_motion_estimate(runs, bs):
    """Two frames apart (a 2x pan, the patch at another velocity) and on
    noise: mvs and SADs exact.  (uint8 source, int32 reference: the P
    frame's signature.)"""
    fr = runs["frames"]
    rng = np.random.RandomState(bs)
    noise = rng.randint(0, 256, (2, 1, H, W)).astype(np.uint8)
    for src, ref in ((fr[2][0][None], fr[0][0][None].astype(np.int32)),
                     (noise[0], noise[1].astype(np.int32))):
        got = tme.motion_estimate(torch.from_numpy(src),
                                  torch.from_numpy(ref), bs)
        # long_range by keyword, as the P frame passes it (one jit entry)
        want = jme.motion_estimate(jnp.asarray(src), jnp.asarray(ref), bs,
                                   long_range=False)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def _mc_case(bs, ss, seed):
    """A padded reference and the block origins the P frame passes at this
    size; mvs at every phase, some beyond the UMV clamp."""
    rng = np.random.RandomState(seed)
    h, w = H >> ss, W >> ss
    plane = rng.randint(0, 256, (1, h, w)).astype(np.int32)
    lb = bs << ss                                 # luma block size
    n = (H // lb) * (W // lb)
    if lb == 16:                                  # z-order sub-blocks
        zi = np.arange(4 * N, dtype=np.int32)
        y0 = (zi // (BW * 4)) * 32 + ((zi % 4) >> 1) * 16
        x0 = ((zi // 4) % BW) * 32 + ((zi % 4) & 1) * 16
    else:
        bw = W // lb
        y0 = np.arange(n, dtype=np.int32) // bw * lb
        x0 = np.arange(n, dtype=np.int32) % bw * lb
    y0, x0 = (a[None].astype(np.int32) >> ss for a in (y0, x0))
    mv = rng.randint(-120, 121, (1, y0.shape[1], 2)).astype(np.int32)
    mv[0, ::3] *= 9                               # beyond the clamp
    return plane, y0, x0, mv


@pytest.mark.parametrize("bs,ss,filt,frame_h", [
    (64, 0, 0, H), (32, 0, 0, H), (16, 0, 0, H), (32, 0, 1, H),
    (32, 0, 2, H), (32, 1, 0, H), (16, 1, 0, H), (8, 1, 0, H),
    (32, 0, 0, 56), (16, 1, 0, 56)])
def test_predict_inter_blocks(bs, ss, filt, frame_h):
    plane, y0, x0, mv = _mc_case(bs, ss, 7 * bs + ss + filt)
    refp = jmc.pad_plane(jnp.asarray(plane))
    want = jmc.predict_inter_blocks(refp, jnp.asarray(y0), jnp.asarray(x0),
                                    jnp.asarray(mv), frame_h, W, bs, ss, 8,
                                    filt)
    tref = tmc.pad_plane(torch.from_numpy(plane))
    np.testing.assert_array_equal(tref.numpy(), np.asarray(refp))
    got = tmc.predict_inter_blocks(tref, torch.from_numpy(y0),
                                   torch.from_numpy(x0),
                                   torch.from_numpy(mv), frame_h, W, bs, ss,
                                   8, filt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _blocks_of(src, n):
    """[B, h, w] -> [B, h/n, w/n, n, n]."""
    B, h, w = src.shape
    return src.reshape(B, h // n, n, w // n, n).transpose(0, 1, 3, 2, 4)


def _lanes(rng, src, nE, bs):
    """Lanes of the scan's inter form: the source's blocks plus noise of
    another amplitude in each lane (z-order sub-blocks), random rates and
    masks, intra allowed wherever no lane is."""
    B, h, w = src.shape
    hs = bs // 2
    subs = _blocks_of(src, hs)
    bh, bw = h // bs, w // bs
    subs = subs.reshape(B, bh, 2, bw, 2, hs, hs).transpose(
        0, 1, 3, 2, 4, 5, 6).reshape(B, bh, bw, 4, hs, hs)
    amp = (3, 12, 60, 6, 24)        # up to the compound frame's 5 lanes

    def lanes_of(blocks):
        out = [blocks + rng.randint(-amp[e], amp[e] + 1, blocks.shape)
               for e in range(nE)]
        return np.clip(np.stack(out, 1), 0, 255).astype(np.int32)

    rate = lambda *s: rng.uniform(3.0, 40.0, s).astype(np.float32)
    okm = lambda *s: rng.rand(*s) < 0.8
    top, sub, sb = (lanes_of(_blocks_of(src, bs)), lanes_of(subs),
                    lanes_of(_blocks_of(src, 2 * bs)))
    ok_t, ok_s, ok_b = (okm(*a.shape[:-2]) for a in (top, sub, sb))
    iok = lambda ok: okm(*ok[:, 0].shape) | ~ok.any(1)
    return (top, rate(*ok_t.shape), ok_t, sub, rate(*ok_s.shape), ok_s, sb,
            rate(*ok_b.shape), ok_b, iok(ok_t), iok(ok_s), iok(ok_b))


def _port_scan(src, bs, fp, fsb, lanes, chroma, tx_search):
    L = tw2.InterLanes(*(torch.from_numpy(np.ascontiguousarray(a))
                         for a in lanes))
    return tw2.encode_plane_wavefront_part(
        torch.from_numpy(src), bs, Q, torch.from_numpy(fp),
        torch.from_numpy(fsb), chroma=chroma, tx_search=tx_search,
        inter=L)


def test_inter_scan_luma(runs):
    rng = np.random.RandomState(11)
    src = rng.randint(0, 256, (1, H, W)).astype(np.int32)
    src[:, :, :64] = runs["frames"][1][0][:, :64]
    fp, fsb = (a[None] for a in tgeo.bottom_force_masks(BH, BW, SH, SW,
                                                        H // 4))
    lanes = _lanes(rng, src, 3, 32)
    (top, r_t, ok_t, sub, r_s, ok_s, sb, r_b, ok_b, i_t, i_s, i_b) = \
        (jnp.asarray(a) for a in lanes)
    want = jw2.encode_plane_wavefront_part(
        jnp.asarray(src), 32, jT.TX_32X32, jT.TX_16X16, Q, top, r_t, sub,
        r_s, ok_t, ok_s, i_t, i_s, jnp.asarray(fp), 3, jie.CAND_MODES,
        jw2.SUB_MODES, 8, (0,), False, True, 1.0, sb_search=True,
        tx_sb=jT.TX_64X64, extra_sb=sb, extra_rate_sb=r_b, extra_ok_sb=ok_b,
        intra_ok_sb=i_b, force_sb=jnp.asarray(fsb), valid_h=None,
        lam_map=None)
    got = _port_scan(src, 32, fp, fsb, lanes, False, True)
    for k, (g, w_) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_),
                                      err_msg=f"output {k}")
    assert (got[1] >= 13).any()


def test_inter_scan_chroma():
    rng = np.random.RandomState(12)
    h, w, bh, bw = H // 2, W // 2, BH, BW
    src = rng.randint(0, 256, (2, h, w)).astype(np.int32)
    part = rng.randint(0, 2, (1, bh, bw)).astype(np.int32)
    psb = rng.randint(0, 2, (1, SH, SW)).astype(np.int32)
    lanes = list(_lanes(rng, src, 1, 16))
    # the P frame's chroma: one lane of rate 0 forced by luma, the u/v
    # halves sharing the masks, intra allowed exactly where the lane is not
    two = lambda a: np.concatenate([a, a])
    for i, j in ((0, 9), (3, 10), (6, 11)):
        lanes[i + 1] = np.zeros_like(lanes[i + 1])
        ok = lanes[i + 2][:1]
        lanes[i + 2], lanes[j] = two(ok), two(~ok[:, 0])
    (top, r_t, ok_t, sub, r_s, ok_s, sb, r_b, ok_b, i_t, i_s, i_b) = \
        (jnp.asarray(a) for a in lanes)
    want = jw2.encode_plane_wavefront_part(
        jnp.asarray(src), 16, jT.TX_16X16, jT.TX_8X8, Q, top, r_t, sub, r_s,
        ok_t, ok_s, i_t, i_s, jnp.asarray(two(part)), 1,
        jw2.CHROMA_TOP_MODES, jw2.CHROMA_SUB_MODES, 8, (0,), False, False,
        1.0, sb_search=True, tx_sb=jT.TX_32X32, extra_sb=sb,
        extra_rate_sb=r_b, extra_ok_sb=ok_b, intra_ok_sb=i_b,
        force_sb=jnp.asarray(two(psb)), valid_h=None, paired=True,
        uv_rates=True, modes_sbl=jw2.CHROMA_SB_MODES, uv_tx=True,
        lam_map=None)
    got = _port_scan(src, 16, two(part), two(psb), lanes, True, False)
    for k, (g, w_) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_),
                                      err_msg=f"output {k}")


# ---- the CLI (no JAX) -------------------------------------------------------

def _write_y4m(path, frames):
    with open(path, "wb") as f:
        wtr = Y4mWriter(f, Y4mInfo(W, H, 30, 1))
        for fr in frames:
            wtr.write_frame(*fr)


def test_cli_keyint_writes_the_encoders_payloads(runs, tmp_path):
    src, out = tmp_path / "in.y4m", tmp_path / "out.ivf"
    _write_y4m(src, runs["frames"])
    rc = app.main(["-i", str(src), "-b", str(out), "-q", str(Q),
                   "--keyint", "64", "--device", "cpu", "--stat-report"])
    assert rc == 0
    with open(out, "rb") as f:
        _, frames = read_ivf(f)
        payloads = [p for p, _ in frames]
    assert payloads == [p for p, _ in runs["port"]]


@pytest.mark.parametrize("extra,keyint,cfg", [
    (["--keyint", "64", "--preset", "12"], 64,
     tpresets.apply_preset(tie.EncoderConfig(W, H, qindex=Q), 12)),
    (["--keyint", "8", "--no-part-search"], 8,
     tie.EncoderConfig(W, H, qindex=Q, part_search=False))])
def test_cli_flat_p_path_writes_the_encoders_payloads(tmp_path, extra,
                                                       keyint, cfg):
    """The flat low-delay path (presets 11-13, --no-part-search): the
    CLI's IVF holds the port's VideoEncoder's payloads (which
    test_torch_flat_inter.py holds to JAX's)."""
    frames = moving_frames(W, H, 3)
    src, out = tmp_path / "in.y4m", tmp_path / "out.ivf"
    _write_y4m(src, frames)
    rc = app.main(["-i", str(src), "-b", str(out), "-q", str(Q),
                   "--device", "cpu", *extra])
    assert rc == 0
    with open(out, "rb") as f:
        _, got = read_ivf(f)
        got = [p for p, _ in got]
    enc = tve.VideoEncoder(cfg, keyint=keyint, device="cpu")
    want, _ = enc.encode_frames(frames)
    assert got == want
    assert sum(enc.last_p["mode_counts"].values()) > 0


def test_cli_rate_control_writes_the_encoders_payloads(rc_runs, tmp_path):
    """--rc cbr --tbr N on the partition path: the IVF holds the port's
    VideoEncoder's payloads under that controller (which rc_runs holds to
    JAX's)."""
    src, out = tmp_path / "in.y4m", tmp_path / "out.ivf"
    _write_y4m(src, rc_runs["frames"])
    rc = app.main(["-i", str(src), "-b", str(out), "-q", str(Q), "--rc",
                   "cbr", "--tbr", str(TBR), "--device", "cpu"])
    assert rc == 0
    with open(out, "rb") as f:
        _, frames = read_ivf(f)
        payloads = [p for p, _ in frames]
    assert payloads == [p for p, _ in rc_runs["port"]]


@pytest.mark.parametrize("extra", [
    ["--pyramid"], ["--rc", "cbr"], ["--pyramid", "--tf"]])
def test_cli_unported_modes_exit_2(tmp_path, extra, capsys):
    """--pyramid, with or without --tf, on the partition path (the
    compound pyramid) is ported: on a key frame, an anchor and a compound
    frame it exits 0 and writes the API's payloads.  --rc cbr without
    --tbr is refused as the JAX CLI refuses it, with its message."""
    pyramid = "--pyramid" in extra
    frames = moving_frames(W, H, 3 if pyramid else 1)
    src, out = tmp_path / "in.y4m", tmp_path / "o.ivf"
    _write_y4m(src, frames)
    rc = app.main(["-i", str(src), "-b", str(out), "--device", "cpu",
                   *extra])
    err = capsys.readouterr().err
    if pyramid:
        assert rc == 0, err
        with open(out, "rb") as f:
            _, got = read_ivf(f)
            got = [p for p, _ in got]
        enc = tve.VideoEncoder(tie.EncoderConfig(W, H, qindex=100),
                               keyint=64, pyramid=True, tf="--tf" in extra,
                               device="cpu")
        want, _ = enc.encode_frames(frames)
        tail, _ = enc.flush()
        assert got == want + tail and len(got) == 5
    else:
        assert rc == 2
        assert japp.main(["-i", str(src), "-b", str(tmp_path / "j.ivf"),
                          *extra]) == 2
        want = capsys.readouterr().err.splitlines()[-1]
        assert want == "error: cbr needs a positive --tbr"
        assert err.splitlines()[-1] == want
