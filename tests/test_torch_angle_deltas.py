"""Angle deltas (presets 0-5) in the port, against the JAX package on the
CPU, with no JAX scan compiled.

- Directional prediction: every (mode, delta) with delta in -3..3 at 8, 16,
  32 and 64 and at 8 and 10 bits, the port's ``_intra_pred`` (the
  partition scan's) and ``dr_pred`` against JAX's eager ops on seeded
  edges; the CUDA kernel's host-built predictor maps against ``dr_pred``.
- Candidate lists and their rates (``expand_candidates``,
  ``rd_params_part``, the mode-rate tables) against JAX's;
  ``verify_settings`` against JAX's, with equal messages; the native flat
  coder with per-block deltas against JAX's Python flat coder.
- The JAX encoder's fixture streams (``tests/data/torch_deltas``, written
  by its ``make_streams.py``): a preset-4 key frame that codes V_PRED or
  H_PRED with a delta, preset-4 low-delay I, P, P, the flat path with
  preset 0's deltas (I, P), a 10-bit preset-4 key frame and a preset-1
  key frame.  The port's encoder, on each entry's source and
  configuration, writes the fixture's bytes and recons (their MD5s); the
  port's decoder decodes each fixture to the JAX encoder's recons, and
  ``tools/av1dec`` (libavcodec) gives the same frames where it builds.
- The decoder's repair: V_PRED / H_PRED with a non-zero delta are
  directional; with delta 0 they decode as before (as the JAX decoder).
- The partition scan's kept scans are keyed by the angle deltas.
- The CLI: presets 0-13, ``--no-cdf-update`` over a preset, and the JAX
  message for a preset with CDEF on the flat path.
"""

import hashlib
import json
import subprocess
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.encoder import intra_encoder as jie
from svtav1_tpu.encoder import presets as jpresets
from svtav1_tpu.encoder import video_encoder as jve
from svtav1_tpu.encoder import wavefront as jwf
from svtav1_tpu.ops import intra as jintra
from svtav1_tpu.ops import intra_dir as jdir
from svtav1_tpu_torch import app
from svtav1_tpu_torch.cuda import inputs
from svtav1_tpu_torch.cuda import wavefront_kernel as wk
from svtav1_tpu_torch.decoder import decoder as tdec
from svtav1_tpu_torch.ec import native
from svtav1_tpu_torch.encoder import presets as tpresets
from svtav1_tpu_torch.encoder import wavefront as twf
from svtav1_tpu_torch.encoder import wavefront2 as tw2
from svtav1_tpu_torch.encoder.intra_encoder import (CAND_MODES,
                                                    EncoderConfig,
                                                    IntraEncoder)
from svtav1_tpu_torch.encoder.video_encoder import VideoEncoder
from svtav1_tpu_torch.ops import intra_dir as tdir
from svtav1_tpu_torch.spec.cdf import CdfContext
from svtav1_tpu_torch.utils.ivf import read_ivf
from svtav1_tpu_torch.utils.y4m import Y4mInfo, Y4mWriter

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "data" / "torch_deltas"
MD5 = json.loads((FIX / "md5.json").read_text())
AV1DEC = ROOT / "tools" / "av1dec"
P0 = (-3, -2, -1, 0, 1, 2, 3)
PRESET_DELTAS = [P0, (-3, -1, 0, 1, 3), (-2, 0, 2), (0,)]


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU ops on one thread: the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ #
# directional prediction

def _edges(seed, n, bd, B=3):
    rng = np.random.RandomState(seed)
    hi = 1 << bd
    above_ext = rng.randint(0, hi, (B, 2 * n)).astype(np.int32)
    left_ext = rng.randint(0, hi, (B, 2 * n)).astype(np.int32)
    corner = rng.randint(0, hi, B).astype(np.int32)
    ha = np.array([True, False, True])[:B]
    hl = np.array([True, True, False])[:B]
    return above_ext, left_ext, corner, ha, hl


@pytest.mark.parametrize("bs", [8, 16, 32, 64])
@pytest.mark.parametrize("delta", range(-3, 4))
@pytest.mark.parametrize("mode", range(1, 9))
def test_directional_prediction(mode, delta, bs):
    """The port's _intra_pred (the partition scan's) and dr_pred against
    JAX's dr_pred (V / H at delta 0: its plain copies), 8 and 10 bits."""
    for bd in (8, 10):
        a_ext, l_ext, corner, ha, hl = _edges(
            1000 * mode + 100 * (delta + 3) + bs + bd, bs, bd)
        a, l = a_ext[:, :bs], l_ext[:, :bs]
        if delta != 0 or mode not in (jintra.V_PRED, jintra.H_PRED):
            want = jdir.dr_pred(mode, delta, jnp.asarray(a_ext),
                                jnp.asarray(l_ext), jnp.asarray(corner), bs,
                                bd)
        else:
            want = jintra.predict(mode, jnp.asarray(a), jnp.asarray(l),
                                  jnp.asarray(corner))
        t = torch.from_numpy
        got = tw2._intra_pred(mode, delta, t(a), t(l), t(corner), t(ha),
                              t(hl), bs, bd, t(a_ext), t(l_ext))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"bd {bd}")
        np.testing.assert_array_equal(
            tdir.dr_pred(mode, delta, t(a_ext), t(l_ext), t(corner), bs,
                         bd).numpy(),
            np.asarray(jdir.dr_pred(mode, delta, jnp.asarray(a_ext),
                                    jnp.asarray(l_ext), jnp.asarray(corner),
                                    bs, bd)), err_msg=f"dr_pred bd {bd}")


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("deltas", PRESET_DELTAS[:3])
def test_linear_pred_maps(deltas, bs, bd):
    """The kernel's per-(candidate, pixel) maps over [corner, above_ext,
    left_ext] give dr_pred's prediction for every directional candidate,
    V and H with a delta included (90 + 3d and 180 + 3d take the zone
    branches); the table's size at 61 candidates."""
    cands = twf.expand_candidates(CAND_MODES, deltas)
    maps = wk.linear_pred_maps(bs, cands)
    assert maps.shape == (len(cands), bs * bs)
    if deltas == P0:
        assert len(cands) == 61 and maps.nbytes == 61 * bs * bs * 4
    a_ext, l_ext, corner, _, _ = _edges(bs + bd + len(deltas), bs, bd, B=1)
    E = np.concatenate([corner, a_ext[0], l_ext[0]]).astype(np.int64)
    t = torch.from_numpy
    for ci, (mode, delta) in enumerate(cands):
        if not 1 <= mode <= 8:
            assert not maps[ci].any()
            continue
        m = maps[ci].astype(np.int64)
        i0, i1, sh = m & 0xFF, (m >> 8) & 0xFF, (m >> 16) & 0x3F
        got = np.clip((E[i0] * (32 - sh) + E[i1] * sh + 16) >> 5, 0,
                      (1 << bd) - 1).reshape(bs, bs)
        want = tdir.dr_pred(mode, delta, t(a_ext), t(l_ext), t(corner), bs,
                            bd)[0].numpy()
        np.testing.assert_array_equal(got, want, err_msg=str((mode, delta)))


# ------------------------------------------------------------------ #
# candidate lists, rates, settings, the flat coder

@pytest.mark.parametrize("deltas", PRESET_DELTAS)
def test_candidate_lists_and_rates(deltas):
    """expand_candidates and the partition scan's lists (deltas on the luma
    whole-block and SB lists only) and rd_params_part's rates against the
    JAX package's, key and inter frames; the flat wavefront's rate table;
    the bound counts every candidate."""
    assert twf.expand_candidates(CAND_MODES, deltas) == \
        jwf.expand_candidates(jie.CAND_MODES, deltas)
    top, sub, sb = tw2._mode_lists(False, deltas)
    assert top == sb == jwf.expand_candidates(jie.CAND_MODES, deltas)
    assert sub == jwf.expand_candidates(tw2.SUB_MODES, (0,))
    assert tw2._mode_lists(True) == tw2._mode_lists(True, (0,))
    n = {P0: 61, (-3, -1, 0, 1, 3): 45, (-2, 0, 2): 29, (0,): 13}[deltas]
    assert len(top) == n
    for q in (60, 100, 200):
        for kf in (True, False):
            rd = tw2.rd_params_part(q, 32, top, sub, sb, kf=kf)
            for key, c in (("rate_top", top), ("rate_sub", sub),
                           ("rate_sb", sb)):
                np.testing.assert_array_equal(
                    rd[key], jwf.intra_mode_rate_table(c, q, kf=kf),
                    err_msg=f"{key} q{q} kf {kf}")
            np.testing.assert_array_equal(
                twf.rd_params(q, 8, top, kf=kf)[3].numpy(),
                np.asarray(jwf.rd_params(q, 8, top, kf=kf)[3]))
    ops13, _ = wk.work(32, 1, 64, 128, CAND_MODES)
    ops, _ = wk.work(32, 1, 64, 128, CAND_MODES, angle_deltas=deltas)
    assert (ops > ops13) == (deltas != (0,))
    with pytest.raises(ValueError, match="chroma"):
        tw2._mode_lists(True, deltas if deltas != (0,) else (1,))


_SETTINGS = [
    {}, {"angle_deltas": P0}, {"angle_deltas": (-4, 0)},
    {"angle_deltas": (0, 4)}, {"width": 0}, {"width": 130},
    {"height": 72}, {"height": 56, "enable_cdef": True},
    {"height": 120, "part_search": False}, {"qindex": 256},
    {"qindex": -1}, {"bit_depth": 12}, {"tile_cols": 3},
    {"tile_cols": 4, "width": 128}, {"width": 4160},
    {"part_search": False, "enable_cdef": True},
]


@pytest.mark.parametrize("keyint", [64, 1, 0])
@pytest.mark.parametrize("change", range(len(_SETTINGS)))
def test_verify_settings(change, keyint):
    """The port's verify_settings accepts and rejects what JAX's does, with
    the same message."""
    def outcome(cls, verify):
        cfg = replace(cls(128, 64), **_SETTINGS[change])
        try:
            verify(cfg, keyint=keyint)
        except ValueError as e:
            return str(e)
        return None
    want = outcome(jie.EncoderConfig, jpresets.verify_settings)
    assert outcome(EncoderConfig, tpresets.verify_settings) == want
    if change in (0, 1) and keyint:
        assert want is None


@pytest.mark.parametrize("seed", range(3))
def test_native_flat_coder_with_deltas(seed):
    """The port's native flat coder with per-block luma deltas writes the
    JAX package's Python flat coder's bytes (JAX falls back to it for
    non-zero deltas) on random maps and levels."""
    rng = np.random.RandomState(seed)
    w, h = 128, 64
    bh, bw = h // 32, w // 32
    cands = twf.expand_candidates(CAND_MODES, P0)
    mi = rng.randint(0, len(cands), (bh, bw))
    y_modes = np.array([m for m, _ in cands], np.int32)[mi]
    y_deltas = np.array([d for _, d in cands], np.int32)[mi]
    uv_modes = rng.randint(0, 13, (bh, bw)).astype(np.int32)

    def levels(n, nz):
        lev = np.zeros((bh, bw, n, n), np.int32)
        m = rng.rand(bh, bw, n, n) < nz
        lev[m] = rng.randint(-9, 10, int(m.sum()))
        return lev
    y_lev, u_lev, v_lev = levels(32, 0.05), levels(16, 0.05), levels(16, 0.03)
    y_lev[0, 1] = u_lev[0, 1] = v_lev[0, 1] = 0         # a skipped block
    got = native.encode_tile_intra(w, h, True, y_modes, y_lev, u_lev, v_lev,
                                   CdfContext(100), uv_modes=uv_modes,
                                   y_deltas=y_deltas)
    jenc = jie.IntraEncoder(jie.EncoderConfig(w, h, qindex=100,
                                              part_search=False,
                                              angle_deltas=P0))
    want = jenc._encode_tile(y_modes, y_lev, u_lev, v_lev, uv_modes,
                             y_deltas)
    assert y_deltas.any() and got == want
    # delta 0 everywhere: the same bytes as without the deltas argument
    z = np.zeros_like(y_deltas)
    assert native.encode_tile_intra(
        w, h, True, y_modes, y_lev, u_lev, v_lev, CdfContext(100),
        uv_modes=uv_modes, y_deltas=z) == native.encode_tile_intra(
        w, h, True, y_modes, y_lev, u_lev, v_lev, CdfContext(100),
        uv_modes=uv_modes)


# ------------------------------------------------------------------ #
# the JAX encoder's fixtures

def _config(c):
    cfg = EncoderConfig(c["width"], c["height"], qindex=c["qindex"],
                        bit_depth=c["bit_depth"])
    if c["preset"] is not None:
        cfg = tpresets.apply_preset(cfg, c["preset"])
    ov = dict(c["overrides"])
    if "angle_deltas" in ov:
        ov["angle_deltas"] = tuple(ov["angle_deltas"])
    return replace(cfg, **ov)


def _source(entry):
    s, c = entry["source"], entry["config"]
    if s["kind"] == "stripes":
        return [inputs.stripes(c["width"], c["height"], s["deg"],
                               bd=c["bit_depth"])]
    return getattr(inputs, s["kind"])(c["width"], c["height"], s["n"],
                                      seed=s["seed"])


def _md5(planes, bd):
    dt = np.uint8 if bd == 8 else np.uint16
    m = hashlib.md5()
    for p in planes:
        m.update(np.asarray(p).astype(dt).tobytes())
    return m.hexdigest()


def _payloads(name):
    with open(FIX / f"{name}.ivf", "rb") as f:
        _, frames = read_ivf(f)
        return [p for p, _ in frames]


def test_fixtures_cover_the_slice():
    """Every fixture carries non-zero deltas; (a) a V/H block with one;
    the configurations span the paths of the slice."""
    assert all(e["deltas"]["any"] > 0 for e in MD5.values())
    assert MD5["vh_delta"]["deltas"]["vh"] > 0
    kinds = {(e["encoder"], e["config"]["preset"], e["bit_depth"])
             for e in MD5.values()}
    assert {("intra", 4, 8), ("video", 4, 8), ("video", None, 8),
            ("intra", 4, 10)} <= kinds


@pytest.mark.parametrize("name", sorted(MD5))
def test_port_encoder_matches_fixture(name):
    """The port's encoder on the fixture's source and configuration: the
    JAX encoder's payloads byte for byte and its recons."""
    entry = MD5[name]
    cfg, frames = _config(entry["config"]), _source(entry)
    if entry["encoder"] == "intra":
        payloads, recons = IntraEncoder(cfg, device="cpu").encode_frames(
            frames)
    else:
        enc = VideoEncoder(cfg, keyint=64, device="cpu")
        out = [enc.encode_frame(*f) for f in frames]
        payloads, recons = [p for p, _ in out], [r for _, r in out]
    assert payloads == _payloads(name)
    assert [_md5(r, entry["bit_depth"]) for r in recons] == entry["frames"]


@pytest.mark.parametrize("name", sorted(MD5))
def test_port_decoder_matches_fixture(name):
    """The port's decoder gives the JAX encoder's recons; (a) has a V_PRED
    or H_PRED block with a non-zero delta, which it predicts as the
    encoder did."""
    entry = MD5[name]
    dec = tdec.Decoder(device="cpu")
    vh = 0
    outs = []
    for p in _payloads(name):
        outs.append(dec.decode_frame_obus(p))
        vh += sum(1 for e in dec._intra if e[4] in (1, 2) and e[5] != 0)
    assert [_md5(o, entry["bit_depth"]) for o in outs] == entry["frames"]
    if name == "vh_delta":
        assert vh > 0


def _av1dec_md5s(path, w, h, n, bd, tmp):
    yuv = tmp / "out.yuv"
    subprocess.run([str(AV1DEC), str(path), str(yuv)], check=True,
                   capture_output=True)
    data = np.fromfile(yuv, np.uint8 if bd == 8 else np.uint16)
    fsz = w * h * 3 // 2
    assert data.size == fsz * n
    c = w * h // 4
    return [_md5((f[:w * h], f[w * h:w * h + c], f[w * h + c:]), bd)
            for f in data.reshape(n, fsz)]


@pytest.mark.parametrize("name", sorted(MD5))
def test_fixture_oracle(name, tmp_path):
    """tools/av1dec (libavcodec) decodes each fixture to the JAX encoder's
    recons, which the port's decoder gives too (above)."""
    if not AV1DEC.exists() and subprocess.run(
            f"gcc -O2 -o {AV1DEC} {AV1DEC}.c -lavformat -lavcodec -lavutil",
            shell=True, capture_output=True).returncode != 0:
        pytest.skip("libavcodec is absent: tools/av1dec does not build")
    e = MD5[name]
    c = e["config"]
    assert _av1dec_md5s(FIX / f"{name}.ivf", c["width"], c["height"],
                        len(e["frames"]), e["bit_depth"],
                        tmp_path) == e["frames"]


# ------------------------------------------------------------------ #
# the decoder's repair

def test_directional_rule():
    assert not tdec._directional(1, 0) and not tdec._directional(2, 0)
    assert all(tdec._directional(m, d) for m in (1, 2) for d in (-3, 3))
    assert all(tdec._directional(m, 0) for m in range(3, 9))
    assert not any(tdec._directional(m, 2) for m in (0, 9, 10, 11, 12))


@pytest.mark.parametrize("deg", [90, 0])
def test_vh_delta_zero_decodes_as_before(deg):
    """V_PRED / H_PRED blocks with delta 0 (vertical and horizontal
    stripes, preset 10): the port's decoder gives the recon and the JAX
    decoder's frames, as before the repair."""
    from svtav1_tpu.decoder.decoder import Decoder as JDecoder
    cfg = tpresets.apply_preset(EncoderConfig(128, 64, qindex=100), 10)
    payload, rec = IntraEncoder(cfg, device="cpu").encode_frame(
        *inputs.stripes(128, 64, deg))
    dec = tdec.Decoder(device="cpu")
    out = dec.decode_frame_obus(payload)
    assert any(e[4] in (1, 2) and e[5] == 0 for e in dec._intra)
    for a, b, r in zip(out, JDecoder().decode_frame_obus(payload), rec):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, np.asarray(r))


# ------------------------------------------------------------------ #
# the partition scan's kept scans

def test_scan_key_separates_deltas(monkeypatch):
    """Two scans of one shape with other deltas do not share a kept scan
    (on the card: its graphs); the same deltas reuse theirs, and every
    result equals a fresh scan's."""
    monkeypatch.setattr(tw2, "_KEEP", ("cuda", "cpu"))
    monkeypatch.setattr(tw2, "_SCANS", {})
    src = torch.from_numpy(inputs.stripes(64, 64, 51)[0][None].copy())
    fp = torch.full((1, 2, 2), -1, dtype=torch.int32)
    fsb = torch.full((1, 1, 1), -1, dtype=torch.int32)
    run = lambda d: tw2.encode_plane_wavefront_part(
        src, 32, 100, fp, fsb, tx_search=True, angle_deltas=d)
    outs = {d: run(d) for d in ((0,), (-2, 0, 2), (0,))}
    scans = list(tw2._SCANS.values())
    assert len(scans) == 2
    assert sorted(len(s.cands[0]) for s in scans) == [13, 29]
    assert [s.key[-1] for s in scans] == [(0,), (-2, 0, 2)]
    monkeypatch.setattr(tw2, "_KEEP", ())
    for d, out in outs.items():
        for a, b in zip(out, run(d)):
            assert torch.equal(a, b), d
    # the scan with deltas picked a candidate only it has
    assert (outs[(-2, 0, 2)][1] >= 13).any() or \
        (outs[(-2, 0, 2)][8] >= 13).any() or \
        not torch.equal(outs[(-2, 0, 2)][6], outs[(0,)][6])


# ------------------------------------------------------------------ #
# the CLI

def _y4m(path, n=2, w=128, h=64):
    with open(path, "wb") as f:
        wtr = Y4mWriter(f, Y4mInfo(w, h, 30, 1))
        for fr in inputs.moving_frames(w, h, n):
            wtr.write_frame(*fr)


def _ivf(path):
    with open(path, "rb") as f:
        _, frames = read_ivf(f)
        return [p for p, _ in frames]


@pytest.mark.parametrize("extra", [[], ["--no-cdf-update"]])
def test_cli_preset4(tmp_path, extra):
    """--preset 4 (low-delay I, P) and --no-cdf-update over it write the
    VideoEncoder's bytes at that configuration."""
    src, out = tmp_path / "in.y4m", tmp_path / "out.ivf"
    _y4m(src)
    assert app.main(["-i", str(src), "-b", str(out), "--preset", "4",
                     "--device", "cpu", *extra]) == 0
    cfg = tpresets.apply_preset(EncoderConfig(128, 64, qindex=100), 4)
    if extra:
        cfg = replace(cfg, cdf_update=False)
    want, _ = VideoEncoder(cfg, keyint=64, device="cpu").encode_frames(
        inputs.moving_frames(128, 64, 2))
    assert _ivf(out) == want


@pytest.mark.parametrize("preset", range(14))
def test_cli_every_preset(tmp_path, preset):
    """Every preset runs all-intra at a height that allows its filters and
    writes the IntraEncoder's bytes."""
    src, out = tmp_path / "in.y4m", tmp_path / "out.ivf"
    _y4m(src, n=1)
    assert app.main(["-i", str(src), "-b", str(out), "--preset",
                     str(preset), "--keyint", "1", "--device", "cpu"]) == 0
    cfg = tpresets.apply_preset(EncoderConfig(128, 64, qindex=100), preset)
    want, _ = IntraEncoder(cfg, device="cpu").encode_frames(
        inputs.moving_frames(128, 64, 1))
    assert _ivf(out) == want


def test_cli_preset0_flat_exits_with_jax_message(tmp_path, capsys):
    """--preset 0 --no-part-search keeps the preset's CDEF on the flat
    path: exit 2 with the message the JAX encoder raises."""
    src = tmp_path / "in.y4m"
    _y4m(src, n=1)
    jcfg = replace(jpresets.apply_preset(jie.EncoderConfig(128, 64), 0),
                   part_search=False)
    jpresets.verify_settings(jcfg)
    with pytest.raises(NotImplementedError) as e:
        jve.VideoEncoder(jcfg, keyint=64)
    assert app.main(["-i", str(src), "-b", str(tmp_path / "o.ivf"),
                     "--preset", "0", "--no-part-search", "--device",
                     "cpu"]) == 2
    # the settings' log line (as the JAX CLI logs it), then the error
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and err[0].startswith("Svt[info]")
    assert err[1] == f"error: {e.value}"
