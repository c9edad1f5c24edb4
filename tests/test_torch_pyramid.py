"""The port's hierarchical mini-GoP pyramid on the flat path (--pyramid
[--tf] with presets M11-M13 or --no-part-search) and its rate control,
against the JAX package at 128x64 on ``cuda/inputs.moving_frames``, on the
CPU.

One module fixture encodes each case with the port's VideoEncoder and with
the JAX VideoEncoder (``part_search=False``, ``pyramid=True``), feeding
both the same frames in the same groups, then flushing.  On both sides
every coded frame's decisions are recorded (JAX's from the arguments of
its ``encode_inter_tile``, its filter pick, its deblock levels and the
reference slot of its ``_encode_p`` header): the maps, mvs, q, reference
slot, GM vector, filter and deblock levels of each coded frame, every
payload (overlays included) and every recon (display order) must be
equal.  With --tf, each filtered anchor is compared with JAX's (a pixel
may differ by one where XLA's and torch's float32 exp round apart; the
count is printed), and JAX's ``_tf_filter`` returns the port's planes, so
the encode is held byte for byte whatever that count.

Cases: 1 + 16 frames at gop 16 (long-range ME at distances 16 and 8);
1 + 8 + 3 with flush (GoPs of 8, 2 and 1); 1 + 8 + 2 with TF; 1 + 16 under
CBR at gop 8; a scene cut inside a mini-GoP; preset 13 (no CDF update, no
filter pick).  At the fixture's shapes (jit cache hits): long-range
motion_estimate, temporal_filter_frame, RateControl over seeded updates,
the show_existing and no-show inter headers; the JAX Decoder on the
port's pyramid stream; the CLI against the JAX CLI.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu import app as japp
from svtav1_tpu.decoder.decoder import Decoder
from svtav1_tpu.encoder import headers as jhdr
from svtav1_tpu.encoder import intra_encoder as jie
from svtav1_tpu.encoder import me as jme
from svtav1_tpu.encoder import presets as jpresets
from svtav1_tpu.encoder import rate_control as jrc
from svtav1_tpu.encoder import video_encoder as jve
from svtav1_tpu.ops import tf as jtf
from svtav1_tpu.utils.y4m import Y4mInfo, Y4mWriter
from svtav1_tpu_torch import app
from svtav1_tpu_torch.cuda.inputs import moving_frames
from svtav1_tpu_torch.encoder import headers as thdr
from svtav1_tpu_torch.encoder import intra_encoder as tie
from svtav1_tpu_torch.encoder import me as tme
from svtav1_tpu_torch.encoder import presets as tpresets
from svtav1_tpu_torch.encoder import rate_control as trc
from svtav1_tpu_torch.encoder import video_encoder as tve
from svtav1_tpu_torch.ops import tf as ttf
from svtav1_tpu_torch.utils.obu import OBU_FRAME, parse_obus
from test_torch_part import one_thread

W, H, Q = 128, 64, 100
TBR = 150            # kbps: about 2/3 of what CQ q100 spends on the clip


def _cut_frames():
    """A scene cut at frame 6 (another texture, inverted: a per-pixel SAD
    above 3.5 times the clip's motion), inside the first mini-GoP of 8."""
    return moving_frames(W, H, 6) + [tuple(255 - p for p in f) for f in
                                     moving_frames(W, H, 6, seed=1)]


# label: (frames, preset, gop, tf, rc mode)
CASES = {
    "cq gop16": (lambda: moving_frames(W, H, 17), None, 16, False, None),
    "flush tail": (lambda: moving_frames(W, H, 12), None, 8, False, None),
    "tf": (lambda: moving_frames(W, H, 11), None, 8, True, None),
    "cbr gop8": (lambda: moving_frames(W, H, 17), None, 8, False, "cbr"),
    "scene cut": (_cut_frames, None, 8, False, None),
    "preset13": (lambda: moving_frames(W, H, 9), 13, 8, False, None),
}
FIELDS = ("y_mi", "y_lev", "u_lev", "v_lev", "mv_t", "gm", "filt", "lf",
          "q", "ref_slot")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_thread():
        yield


@pytest.fixture(autouse=True)
def _lambda_scale(monkeypatch):
    """Both packages read SVT_TPU_LAMBDA_SCALE: pin it."""
    monkeypatch.setenv("SVT_TPU_LAMBDA_SCALE", "1.0")


def _cfg(mod, presets, preset):
    cfg = mod.EncoderConfig(W, H, qindex=Q, part_search=False)
    return cfg if preset is None else presets.apply_preset(cfg, preset)


def _rc(mod, mode):
    return None if mode is None else mod.RateControl(
        mode, qindex=Q, target_kbps=TBR, fps=30.0)


def _encode(enc, frames):
    payloads, recons = enc.encode_frames(frames)
    p, r = enc.flush()
    return payloads + p, recons + r


def _port_run(frames, preset, gop, tf, mode):
    enc = tve.VideoEncoder(_cfg(tie, tpresets, preset), keyint=64,
                           pyramid=True, gop=gop, tf=tf, rc=_rc(trc, mode),
                           device="cpu")
    coded, filtered = [], []
    code, filt = enc._encode_p_flat, enc._tf_filter

    def spy_code(*a, **kw):
        out = code(*a, **kw)
        m = dict(enc.last_p)
        m["gm"] = tuple(m["gm"] or (0, 0))
        coded.append(m)
        return out

    def spy_filter(*a):
        filtered.append(filt(*a))
        return filtered[-1]

    enc._encode_p_flat, enc._tf_filter = spy_code, spy_filter
    payloads, recons = _encode(enc, frames)
    return dict(payloads=payloads, recons=recons, coded=coded,
                filtered=filtered)


@contextlib.contextmanager
def _jax_spies(coded):
    """Record each JAX flat P frame's decisions into a new dict of
    `coded`: the maps, mvs, q and GM its tile coder gets, its filter
    pick."""
    tile, pick = jve.encode_inter_tile, jve._pick_interp_filt

    def spy_tile(w, h, q, upd, y_mi, y_lev, u_lev, v_lev, mv, cands,
                 n_intra, **kw):
        coded[-1].update(y_mi=np.asarray(y_mi), y_lev=np.asarray(y_lev),
                         u_lev=np.asarray(u_lev), v_lev=np.asarray(v_lev),
                         mv_t=np.asarray(mv), gm=tuple(kw["gm_mv"]), q=q)
        return tile(w, h, q, upd, y_mi, y_lev, u_lev, v_lev, mv, cands,
                    n_intra, **kw)

    def spy_pick(*a, **kw):
        coded[-1]["filt"] = pick(*a, **kw)
        return coded[-1]["filt"]

    jve.encode_inter_tile, jve._pick_interp_filt = spy_tile, spy_pick
    try:
        yield
    finally:
        jve.encode_inter_tile, jve._pick_interp_filt = tile, pick


def _jax_run(frames, preset, gop, tf, mode, port_filtered):
    enc = jve.VideoEncoder(_cfg(jie, jpresets, preset), keyint=64,
                           pyramid=True, gop=gop, tf=tf, rc=_rc(jrc, mode))
    coded, tf_diff = [], []
    code, lf_levels, filt = enc._encode_p, enc._p_lf_levels, enc._tf_filter

    def spy_code(*a, hdr_extra=None, **kw):
        coded.append({"filt": 0,
                      "ref_slot": hdr_extra["ref_frame_idx"][0]})
        return code(*a, hdr_extra=hdr_extra, **kw)

    def spy_lf(q=None):
        coded[-1]["lf"] = lf_levels(q)
        return coded[-1]["lf"]

    def port_planes(*a):
        """JAX's filtered planes against the port's, then the port's."""
        want = filt(*a)
        got = port_filtered[len(tf_diff)]
        tf_diff.append([np.abs(g.astype(np.int32) - w_.astype(np.int32))
                        for g, w_ in zip(got, want)])
        return got

    enc._encode_p, enc._p_lf_levels = spy_code, spy_lf
    enc._tf_filter = port_planes
    with _jax_spies(coded):
        payloads, recons = _encode(enc, frames)
    return dict(payloads=payloads, recons=recons, coded=coded,
                tf_diff=tf_diff)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for label, (make, preset, gop, tf, mode) in CASES.items():
        frames = make()
        with one_thread():
            port = _port_run(frames, preset, gop, tf, mode)
        out[label] = dict(frames=frames, port=port, jax=_jax_run(
            frames, preset, gop, tf, mode, port["filtered"]))
    return out


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("case", CASES)
def test_coded_frame_decisions(runs, case, field):
    got, want = (runs[case][s]["coded"] for s in ("port", "jax"))
    assert len(got) == len(want) > 0
    for k, (g, w_) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g[field]),
                                      np.asarray(w_[field]),
                                      err_msg=f"coded frame {k}: {field}")


@pytest.mark.parametrize("case", CASES)
def test_payloads(runs, case):
    got, want = (runs[case][s]["payloads"] for s in ("port", "jax"))
    assert len(got) == len(want)
    for k, (g, w_) in enumerate(zip(got, want)):
        assert g == w_, f"payload {k}"


@pytest.mark.parametrize("case", CASES)
def test_recons_in_display_order(runs, case):
    got, want = (runs[case][s]["recons"] for s in ("port", "jax"))
    assert len(got) == len(want) == len(runs[case]["frames"])
    for k, (g, w_) in enumerate(zip(got, want)):
        for p in range(3):
            np.testing.assert_array_equal(np.asarray(g[p], np.int32),
                                          np.asarray(w_[p], np.int32),
                                          err_msg=f"frame {k} plane {p}")


def _frame_types(payloads):
    """(show_existing, frame_type, show_frame) of each TU's first frame
    header: frame_type and show_frame None for an overlay."""
    out = []
    for p in payloads:
        d = next(d for t, _, _, d in parse_obus(p) if t in (OBU_FRAME, 3))
        if d[0] >> 7:
            out.append((1, None, None))
        else:
            out.append((0, (d[0] >> 5) & 3, (d[0] >> 4) & 1))
    return out


@pytest.mark.parametrize("case", CASES)
def test_the_structure_is_a_pyramid(runs, case):
    """One key frame (two at the cut), a show_existing overlay for every
    no-show frame, references beyond 4 frames searched long-range."""
    r = runs[case]["port"]
    types = _frame_types(r["payloads"])
    keys = [k for k, t in enumerate(types) if t[1] == 0]
    no_show = sum(1 for t in types if t[2] == 0)
    overlays = sum(1 for t in types if t[0])
    assert keys[0] == 0 and len(keys) == (2 if case == "scene cut" else 1)
    assert no_show == overlays > 0
    assert len(types) - overlays == len(runs[case]["frames"])
    if case == "cq gop16":
        assert [m["ref_dist"] for m in r["coded"][:2]] == [16, 8]
    if case == "cbr gop8":
        # the first interior frame of each GoP of 8 (layer 1): the base q
        # moved between the GoPs
        assert r["coded"][1]["q"] != r["coded"][9]["q"]


def test_tf_planes_within_one(runs, capsys):
    """The port's filtered anchors (the key frame's and the mini-GoPs')
    against JAX's: at most one off, the count printed."""
    diffs = runs["tf"]["jax"]["tf_diff"]
    assert len(diffs) == 3               # the key frame and two anchors
    n = [int((d > 0).sum()) for f in diffs for d in f]
    with capsys.disabled():
        print(f"\nTF planes: pixels that differ from JAX's {n}")
    assert max(int(d.max()) for f in diffs for d in f) <= 1


# ---- modules at the fixture's shapes ----------------------------------------

def _far_pair():
    """A smooth texture and its crop 80 px to the right: beyond L2's +-64,
    inside L3's +-96."""
    rng = np.random.RandomState(3)
    coarse = rng.randint(0, 256, (H // 8 + 1, 256 // 8 + 1)).astype(float)
    yy, xx = np.mgrid[0:H, 0:256] / 8.0
    y0, x0 = yy.astype(int), xx.astype(int)
    fy, fx = yy - y0, xx - x0
    tex = (coarse[y0, x0] * (1 - fy) * (1 - fx) +
           coarse[y0 + 1, x0] * fy * (1 - fx) +
           coarse[y0, x0 + 1] * (1 - fy) * fx +
           coarse[y0 + 1, x0 + 1] * fy * fx)
    tex = np.clip(tex + rng.randint(-3, 4, tex.shape), 0, 255)
    tex = tex.astype(np.uint8)
    return tex[:, 80:80 + W], tex[:, :W]


@pytest.mark.parametrize("pair", ["16 apart", "8 apart", "80 px"])
def test_motion_estimate_long_range(pair):
    if pair == "80 px":
        src, ref = _far_pair()
    else:
        fr = moving_frames(W, H, 17)
        src, ref = fr[16 if pair == "16 apart" else 8][0], fr[0][0]
    got = tme.motion_estimate(torch.from_numpy(src[None]),
                              torch.from_numpy(ref[None]), 32,
                              long_range=True)
    want = jme.motion_estimate(jnp.asarray(src[None]), jnp.asarray(ref[None]),
                               32, long_range=True)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    if pair == "80 px":
        std = tme.motion_estimate(torch.from_numpy(src[None]),
                                  torch.from_numpy(ref[None]), 32)[0]
        assert not torch.equal(std, got[0]), "L3 must win somewhere"
        assert (got[0][..., 1] == 8 * 80).any()


@pytest.mark.parametrize("h,center,nbs,q", [
    (64, 4, (2, 3, 5, 6), 100), (64, 7, (6,), 70), (56, 0, (1, 2, 3), 140)])
def test_temporal_filter_frame(h, center, nbs, q, capsys):
    fr = [tuple(p.copy() for p in f) for f in moving_frames(W, h, 8)]
    got = ttf.temporal_filter_frame(fr[center], [fr[i] for i in nbs], q)
    want = jtf.temporal_filter_frame(fr[center], [fr[i] for i in nbs], q)
    d = [np.abs(g.astype(np.int32) - w_.astype(np.int32))
         for g, w_ in zip(got, want)]
    with capsys.disabled():
        print(f"\nTF {W}x{h}, {len(nbs)} neighbours, q{q}: pixels that "
              f"differ from JAX's {[int((x > 0).sum()) for x in d]}")
    assert all(g.dtype == np.uint8 and g.shape == w_.shape
               for g, w_ in zip(got, want))
    assert max(int(x.max()) for x in d) <= 1
    assert any((g != c).any() for g, c in zip(got, fr[center]))


def test_temporal_filter_without_neighbours_is_identity():
    f = moving_frames(W, H, 1)[0]
    assert ttf.temporal_filter_frame(f, [], 100) is f


@pytest.mark.parametrize("mode", ["cq", "crf", "cbr", "vbr"])
def test_rate_control(mode):
    rng = np.random.RandomState(len(mode))
    t = trc.RateControl(mode, qindex=120, target_kbps=800, fps=24.0)
    j = jrc.RateControl(mode, qindex=120, target_kbps=800, fps=24.0)
    qs = []
    for _ in range(60):
        nbytes = int(rng.randint(100, 20000))
        shown = int(rng.choice([0, 1, 1, 1, 2, 4, 8]))
        t.update(nbytes, shown)
        j.update(nbytes, shown)
        assert t.base_q == j.base_q
        qs.append(t.base_q)
    assert t.achieved_kbps() == j.achieved_kbps()
    assert (len(set(qs)) > 5) == (mode in ("cbr", "vbr"))


@pytest.mark.parametrize("args", [("abr", 100, 500), ("cbr", 100, 0),
                                  ("vbr", 100, -1)])
def test_rate_control_refuses_like_jax(args):
    msgs = []
    for mod in (trc, jrc):
        with pytest.raises(ValueError) as e:
            mod.RateControl(args[0], qindex=args[1], target_kbps=args[2])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("slot", range(8))
def test_show_existing_header(slot):
    assert thdr.assemble_show_existing(slot) == \
        jhdr.assemble_show_existing(slot)


@pytest.mark.parametrize("primary,slot,refresh", [(7, 0, 1), (0, 2, 3),
                                                  (0, 1, 5)])
def test_no_show_inter_header(primary, slot, refresh):
    kw = dict(frame_type=1, show_frame=False, primary_ref_frame=primary,
              refresh_frame_flags=1 << refresh, ref_frame_idx=(slot,) * 7,
              base_q_idx=87, filter_level=(9, 9), filter_level_u=6,
              filter_level_v=6, gm_mv={1: (-16, -24)},
              gm_prev={1: (-16, -22)} if primary == 0 else {})
    tile = bytes(range(3, 60))
    seq = dict(width=W, height=H)
    got = thdr.assemble_frame(thdr.SequenceConfig(**seq),
                              thdr.FrameConfig(**kw), tile)
    want = jhdr.assemble_frame(jhdr.SequenceConfig(**seq),
                               jhdr.FrameConfig(**kw), tile)
    assert got == want


def test_jax_decoder_decodes_the_ports_pyramid(runs):
    """The port's stream with GoPs of 8, 2 and 1: the JAX Decoder outputs
    the port's recons in display order (overlays show the no-show
    frames)."""
    r = runs["flush tail"]["port"]
    dec = Decoder()
    out = [f for f in (dec.decode_frame_obus(p) for p in r["payloads"])
           if f is not None]
    assert len(out) == len(r["recons"])
    for k, (g, w_) in enumerate(zip(out, r["recons"])):
        for p in range(3):
            np.testing.assert_array_equal(g[p], w_[p],
                                          err_msg=f"frame {k} plane {p}")


# ---- the CLI ----------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--no-part-search", "--pyramid", "--tf"],
    ["--preset", "12", "--pyramid", "--rc", "cbr", "--tbr", str(TBR)]])
def test_cli_matches_the_jax_cli(runs, tmp_path, extra):
    src = tmp_path / "in.y4m"
    with open(src, "wb") as f:
        wtr = Y4mWriter(f, Y4mInfo(W, H, 30, 1))
        for fr in runs["tf"]["frames"]:
            wtr.write_frame(*fr)
    outs = []
    for main, dev in ((app.main, ["--device", "cpu"]), (japp.main, [])):
        out = tmp_path / f"out{len(outs)}.ivf"
        assert main(["-i", str(src), "-b", str(out), "-q", str(Q), *dev,
                     *extra]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
