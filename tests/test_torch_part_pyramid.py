"""The port's compound partition pyramid (--pyramid [--tf] with the
partition search) against the JAX package at 128x64, q100, on
``cuda/inputs.moving_frames``, on the CPU.

One module fixture encodes each case with the port's VideoEncoder
(``pyramid=True``, the partition defaults) and reads the JAX side from
``tests/data/torch_part_pyramid/runs.npz`` (written by its
``make_fixtures.py``, which runs the JAX package; no JAX scan is compiled
here).  There a JAX VideoEncoder's pyramid state was set to what the port
holds after its key frame (slot 0 the port's key-frame recon, no CDF
snapshot, display index 0, anchor slot 0, the scene-cut state; the port's
key frames are held to JAX by ``test_torch_part.py``) and fed the
remaining frames; with --tf its ``_tf_filter`` returned the port's
filtered planes (``test_torch_pyramid.py`` holds the filter to JAX's).
The file keeps the MD5 of that key frame and of those planes, so a port
that no longer writes them says so before it compares.  JAX's decisions
are those of its ``SVT_DUMP_DIR`` dump and of the arguments of its
``_encode_p`` (lambda weight and map).  On every anchor and compound
frame every decision map, the 4-component mv fields, q, the DLF level,
the lambda weight and map, the recon and the payload must equal JAX's,
and so must every overlay.

Cases: gop 2 (key, anchor, one compound frame); gop 2 with TF over two
GoPs (the second anchor on the first's CDF snapshot); gop 4 with TF (an
anchor and compound frames at layers 1 and 2, lambda weights 1.0 and
1.15); gop 4 under CBR.  Also: the port's stream decodes in the JAX
Decoder and in the port's to the port's recons; the CLI's --pyramid and
--pyramid --tf on the default partition preset write the API's payloads;
and the inter scans of the anchor and of the compound frame with lambda
weights and random lambda maps (seeded inputs, ``_scan_inputs``) against
the outputs of JAX's scan on the same inputs (``scans.npz``).
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from svtav1_tpu.decoder.decoder import Decoder as JaxDecoder
from svtav1_tpu.utils.ivf import read_ivf
from svtav1_tpu.utils.y4m import Y4mInfo, Y4mWriter
from svtav1_tpu_torch import app
from svtav1_tpu_torch.cuda.inputs import moving_frames
from svtav1_tpu_torch.decoder.decoder import Decoder
from svtav1_tpu_torch.encoder import geometry as tgeo
from svtav1_tpu_torch.encoder import intra_encoder as tie
from svtav1_tpu_torch.encoder import rate_control as trc
from svtav1_tpu_torch.encoder import video_encoder as tve
from svtav1_tpu_torch.encoder import wavefront2 as tw2
from svtav1_tpu_torch.spec import mv as MV
from svtav1_tpu_torch.utils.obu import OBU_FRAME, parse_obus
from test_torch_part import one_thread
from test_torch_video import _lanes

FIX = Path(__file__).resolve().parent / "data" / "torch_part_pyramid"
W, H, Q = 128, 64, 100
TBR = 150            # kbps: q moves between the GoPs

# label: (frames, gop, tf, rc mode)
CASES = {
    "gop2": (3, 2, False, None),
    "gop2 tf": (5, 2, True, None),
    "gop4 tf": (5, 4, True, None),
    "gop4 cbr": (5, 4, False, "cbr"),
}
# the maps of the JAX dump (leading tile axis) and of the port's last_p
MAPS = ("part", "y_mi", "y_lev", "y_smi", "y_slev", "y_stx", "part_sb",
        "y_mi_sb", "y_lev_sb", "u_lev", "v_lev", "u_slev", "v_slev",
        "u_lev_sb", "v_lev_sb", "mv_t", "mv_s", "mv_sb")
FIELDS = MAPS + ("q", "lf", "comp", "lam_scale", "lam_map")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_thread():
        yield


def _rc(mod, mode):
    return None if mode is None else mod.RateControl(
        mode, qindex=Q, target_kbps=TBR, fps=30.0)


def _port_run(frames, gop, tf, mode, bit_depth=8):
    """The port's pyramid: payloads, recons, each coded P frame's last_p,
    the filtered planes and the key frame's (payload, recon)."""
    cfg = tie.EncoderConfig(W, H, qindex=Q, bit_depth=bit_depth)
    enc = tve.VideoEncoder(cfg, keyint=64, pyramid=True, gop=gop, tf=tf,
                           rc=_rc(trc, mode), device="cpu")
    coded, filtered = [], []
    code, filt = enc._encode_p_part, enc._tf_filter

    def spy_code(*a, **kw):
        out = code(*a, **kw)
        coded.append(dict(enc.last_p))
        return out

    def spy_filter(*a):
        filtered.append(filt(*a))
        return filtered[-1]

    enc._encode_p_part, enc._tf_filter = spy_code, spy_filter
    with one_thread():
        p0, r0 = enc.encode_frames(frames[:1])
        p1, r1 = enc.encode_frames(frames[1:])
        p2, r2 = enc.flush()
    return dict(payloads=p0 + p1 + p2, recons=r0 + r1 + r2, coded=coded,
                filtered=filtered, key=(p0[0], r0[0]))


def state_md5(key_payload, filtered):
    """The MD5 of the state a case's JAX side started from: the key
    frame's payload and the filtered planes of the anchors after it."""
    m = hashlib.md5(key_payload)
    for planes in filtered:
        for p in planes:
            m.update(np.ascontiguousarray(p, np.int32).tobytes())
    return m.hexdigest()


def _load(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def _jax_after_key(fix, c, port):
    """Case c's JAX side from the fixture: its payloads and recons (the
    port's key frame first) and coded-frame records (the dump, plus
    lam_scale and lam_map; a frame coded without a map has none)."""
    assert str(fix[f"{c}_state_md5"]) == state_md5(
        port["key"][0], port["filtered"][1:]), \
        "the port's key frame or TF planes changed: rewrite the fixture"
    n_pay, n_rec, n_coded = (int(x) for x in fix[f"{c}_counts"])
    payloads = [fix[f"{c}_pay_{i}"].tobytes() for i in range(n_pay)]
    recons = [tuple(fix[f"{c}_rec_{i}_{p}"] for p in range(3))
              for i in range(n_rec)]
    coded = []
    for k in range(n_coded):
        rec = {f: fix[f"{c}_coded_{k}_{f}"] for f in FIELDS
               if f"{c}_coded_{k}_{f}" in fix}
        rec.setdefault("lam_map", None)
        coded.append(rec)
    return dict(payloads=[port["key"][0]] + payloads,
                recons=[port["key"][1]] + recons, coded=coded)


@pytest.fixture(scope="module")
def runs():
    fix = _load(FIX / "runs.npz")
    out = {}
    for c, (label, (n, gop, tf, mode)) in enumerate(CASES.items()):
        frames = moving_frames(W, H, n)
        port = _port_run(frames, gop, tf, mode)
        out[label] = dict(frames=frames, port=port,
                          jax=_jax_after_key(fix, c, port))
    return out


def _eq(got, want, msg):
    if got is None or want is None:
        assert got is None and want is None, msg
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=msg)


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("case", CASES)
def test_coded_frame_decisions(runs, case, field):
    got, want = (runs[case][s]["coded"] for s in ("port", "jax"))
    assert len(got) == len(want) > 1
    for k, (g, w_) in enumerate(zip(got, want)):
        _eq(g[field], w_[field], f"coded frame {k}: {field}")


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


def _tu_kinds(payloads):
    """Each TU's first frame header: "key", "inter" (shown), "no-show"
    or "overlay"."""
    out = []
    for p in payloads:
        d = next(d for t, _, _, d in parse_obus(p) if t in (OBU_FRAME, 3))
        if d[0] >> 7:
            out.append("overlay")
        elif (d[0] >> 5) & 3 == 0:
            out.append("key")
        else:
            out.append("inter" if (d[0] >> 4) & 1 else "no-show")
    return out


@pytest.mark.parametrize("case", CASES)
def test_the_structure_is_a_compound_pyramid(runs, case):
    """A key frame, then each GoP's anchor (single reference, layer 0,
    the TPL map) and its compound interior frames, every no-show frame
    shown by an overlay; at least one compound block is coded, and the
    interior layers carry their lambda weights."""
    r = runs[case]["port"]
    kinds = _tu_kinds(r["payloads"])
    assert kinds[:3] == ["key", "no-show", "no-show"]
    assert kinds.count("no-show") == kinds.count("overlay")
    comp = [m for m in r["coded"] if m["comp"]]
    anchors = [m for m in r["coded"] if not m["comp"]]
    assert all(m["lam_map"] is not None and m["lam_scale"] == 1.0
               for m in anchors)
    assert all(m["lam_map"] is None for m in comp)
    assert sum(m["mode_counts"][MV.NEW_NEWMV] +
               m["mode_counts"][MV.NEAREST_NEARESTMV] +
               m["mode_counts"][MV.GLOBAL_GLOBALMV] for m in comp) > 0
    if CASES[case][1] == 4:
        assert sorted(m["lam_scale"] for m in comp) == [1.0, 1.15, 1.15]
    if case == "gop4 cbr":
        assert len({m["q"] for m in r["coded"]}) > 2


@pytest.mark.parametrize("decoder", ["jax", "port"])
def test_decoders_decode_the_ports_stream(runs, decoder):
    """The gop-4 stream with TF: both decoders output the port's recons
    in display order."""
    r = runs["gop4 tf"]["port"]
    dec = JaxDecoder() if decoder == "jax" else Decoder(device="cpu")
    with one_thread():
        out = [f for f in (dec.decode_frame_obus(p) for p in r["payloads"])
               if f is not None]
    assert len(out) == len(r["recons"])
    for k, (g, w_) in enumerate(zip(out, r["recons"])):
        for p in range(3):
            np.testing.assert_array_equal(np.asarray(g[p]), w_[p],
                                          err_msg=f"frame {k} plane {p}")


@pytest.mark.parametrize("case", ["gop2", "gop2 tf"])
def test_cli_pyramid_writes_the_encoders_payloads(runs, tmp_path, case):
    """--pyramid [--tf] on the default (partition) preset: the IVF holds
    the API's payloads at the CLI's defaults (gop 16: one GoP of 2 or 4,
    and the flush)."""
    frames = runs[case]["frames"]
    tf = CASES[case][2]
    src, out = tmp_path / "in.y4m", tmp_path / "out.ivf"
    with open(src, "wb") as f:
        wtr = Y4mWriter(f, Y4mInfo(W, H, 30, 1))
        for fr in frames:
            wtr.write_frame(*fr)
    with one_thread():
        assert app.main(["-i", str(src), "-b", str(out), "-q", str(Q),
                         "--device", "cpu", "--pyramid"] +
                        (["--tf"] if tf else [])) == 0
        enc = tve.VideoEncoder(tie.EncoderConfig(W, H, qindex=Q), keyint=64,
                               pyramid=True, tf=tf, device="cpu")
        want, _ = enc.encode_frames(frames)
        tail, _ = enc.flush()
    with open(out, "rb") as f:
        _, got = read_ivf(f)
        got = [p for p, _ in got]
    assert got == want + tail


# ---- the scans with a lambda weight and map, at the fixture's shapes -------

SCAN_CASES = [("luma", 3, 1.0), ("luma", 5, 1.15), ("luma", 5, 1.3),
              ("chroma", 1, 1.15)]


def _scan_inputs(form, n, scale):
    """The seeded inputs of a scan case: (src [B, h, w] int32, bs, the 12
    lane arrays, force_part, force_sb, lambda map)."""
    rng = np.random.RandomState(n * 10 + int(scale * 100))
    chroma = form == "chroma"
    B, h, w, bs = (2, H // 2, W // 2, 16) if chroma else (1, H, W, 32)
    bh, bw, sh, sw = h // bs, w // bs, h // bs // 2, w // bs // 2
    src = rng.randint(0, 256, (B, h, w)).astype(np.int32)
    lanes = list(_lanes(rng, src, n, bs))
    two = lambda a: np.concatenate([a, a])
    if chroma:
        # one lane of rate 0 forced by luma, the u/v halves sharing the
        # masks, intra allowed exactly where the lane is not
        fp = two(rng.randint(0, 2, (1, bh, bw)).astype(np.int32))
        fsb = two(rng.randint(0, 2, (1, sh, sw)).astype(np.int32))
        for i, j in ((0, 9), (3, 10), (6, 11)):
            lanes[i + 1] = np.zeros_like(lanes[i + 1])
            ok = lanes[i + 2][:1]
            lanes[i + 2], lanes[j] = two(ok), two(~ok[:, 0])
        lmap = two(rng.uniform(0.68, 1.18, (1, bh, bw)).astype(np.float32))
    else:
        fp, fsb = (a[None] for a in tgeo.bottom_force_masks(
            bh, bw, sh, sw, h // 4))
        lmap = rng.uniform(0.68, 1.18, (1, bh, bw)).astype(np.float32)
    return src, bs, lanes, fp, fsb, lmap


@pytest.mark.parametrize("form,n,scale", SCAN_CASES)
def test_scan_with_lambda_weight_and_map(form, n, scale):
    """The inter scans of the anchor (3 lanes) and of the compound frame (5
    lanes; paired U+V with 1) with a lambda weight and a random per-block
    map, against JAX's scan on the same inputs (``scans.npz``, its
    partition scan at the fixture's shapes): every output equal."""
    src, bs, lanes, fp, fsb, lmap = _scan_inputs(form, n, scale)
    chroma = form == "chroma"
    fix = _load(FIX / "scans.npz")
    c = SCAN_CASES.index((form, n, scale))
    want = [fix[f"{c}_{k}"] for k in range(int(fix[f"{c}_n"]))]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = tw2.encode_plane_wavefront_part(
        t(src), bs, Q, t(fp), t(fsb), chroma=chroma, tx_search=not chroma,
        inter=tw2.InterLanes(*(t(a) for a in lanes)), lam_scale=scale,
        lam_map=t(lmap))
    assert len(got) == len(want) == 10
    for k, (g, w_) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_),
                                      err_msg=f"output {k}")
