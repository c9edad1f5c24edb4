"""Tile columns in the port and its multi-device module, against the JAX
package on the CPU, with no JAX scan compiled.

- ``tile_stack`` / ``tile_unstack`` (the tiles on the batch axis,
  tile-major) and the tile coder of one tile column (``TileCoder``'s
  ``mi_col_off`` / ``frame_mi_cols``) against JAX's ``TileCoder`` on
  random key and P frame maps, with the filters' side info (the CDEF
  indices and LR units sliced to the tile, the frame's CCSO flags).
- The JAX encoder's fixture streams (``tests/data/torch_tiles``, written
  by its ``make_streams.py``): a key frame with four tile columns, preset
  4 with LR and CCSO at two (I, P, P; a P frame signals LR and one CCSO),
  10-bit I, P at two, the compound pyramid (gop 2, TF) at two; and
  ``tests/data/torch_dec/two_tiles.ivf`` (low-delay I, P at two).  The
  port's encoder, on each entry's source and configuration, writes the
  fixture's bytes and recons (their MD5s); the port's decoder decodes each
  fixture to the JAX encoder's recons, and ``tools/av1dec`` (libavcodec)
  gives the same frames for the standard streams where it builds.
- The flat path with tiles and the other tile settings raise as JAX's
  encoder and ``verify_settings`` raise, with the same messages.
- ``parallel.mesh`` on ``["cpu", "cpu"]``: the GOP-parallel and
  tile-parallel encodes equal their serial encodes byte for byte (flat
  and partition GOPs), the encode and pipeline steps their one-device
  runs, and both equal the JAX module's functions on two CPU devices (the
  fixture's ``mesh`` entry: bytes, recon MD5s, totals); ``make_mesh``
  refuses more devices than exist.
"""

import hashlib
import json
import subprocess
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from svtav1_tpu.encoder import intra_encoder as jie
from svtav1_tpu.encoder import presets as jpresets
from svtav1_tpu.encoder import tile_codec as jtc
from svtav1_tpu_torch.cuda import inputs
from svtav1_tpu_torch.decoder import decoder as tdec
from svtav1_tpu_torch.encoder import presets as tpresets
from svtav1_tpu_torch.encoder import tile_codec as ttc
from svtav1_tpu_torch.encoder import wavefront2 as tw2
from svtav1_tpu_torch.encoder.geometry import pad64
from svtav1_tpu_torch.encoder.intra_encoder import (CAND_MODES,
                                                    EncoderConfig,
                                                    IntraEncoder,
                                                    tile_stack,
                                                    tile_unstack)
from svtav1_tpu_torch.encoder.video_encoder import VideoEncoder
from svtav1_tpu_torch.encoder.wavefront import expand_candidates
from svtav1_tpu_torch.parallel import mesh
from svtav1_tpu_torch.utils.ivf import read_ivf
from test_torch_inter_ops import _filter_syntax, _inter_maps
from test_torch_part_ops import _decision_maps

ROOT = Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "data" / "torch_tiles"
DEC = ROOT / "tests" / "data" / "torch_dec"
AV1DEC = ROOT / "tools" / "av1dec"
MD5 = json.loads((FIX / "md5.json").read_text())
STREAMS = sorted(k for k, e in MD5.items()
                 if e["encoder"] not in ("cli", "mesh"))
# the JAX mesh functions' outputs on two host CPU devices
MESH = MD5["mesh"]
# the decoder fixture with two tile columns: the JAX VideoEncoder at
# 256x64, q100, on two frames of _tile_clip
TWO_TILES = dict(json.loads((DEC / "md5.json").read_text())["two_tiles"],
                 encoder="video", source=dict(kind="tile_clip", n=2, seed=5),
                 config=dict(width=256, height=64, qindex=100, bit_depth=8,
                             tile_cols=2, preset=None, overrides={}))
ENTRIES = dict(MD5, two_tiles=TWO_TILES)
NAMES = STREAMS + ["two_tiles"]


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU ops on one thread: the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ #
# the tiles on the batch axis

@pytest.mark.parametrize("T", [1, 2, 4])
def test_tile_stack_round_trip(T):
    """tile_stack puts tile t of frame b at t * n + b (numpy and tensors,
    any width axis); tile_unstack puts the frame back together."""
    rng = np.random.RandomState(T)
    a = rng.randint(0, 255, (3, 8, 16 * T, 2))
    s = tile_stack(a, T, axis=2)
    assert s.shape == (3 * T, 8, 16, 2)
    for t in range(T):
        np.testing.assert_array_equal(s[t * 3:(t + 1) * 3],
                                      a[:, :, 16 * t:16 * (t + 1)])
    ta = torch.from_numpy(a)
    assert torch.equal(tile_stack(ta, T, axis=2), torch.from_numpy(s))
    assert torch.equal(tile_unstack(tile_stack(ta, T, axis=2), T), ta)
    planes = rng.randint(0, 255, (2, 16, 64 * T)).astype(np.uint8)
    np.testing.assert_array_equal(tile_stack(planes, T),
                                  tile_stack(planes, T, axis=2))


def _tile_maps(d, t, T, w):
    """Maps of tile t of T of a frame of width w (32x32- and SB-grid maps
    sliced by column)."""
    bw_t, sw_t = w // 32 // T, w // 64 // T
    out = {}
    for k, a in d.items():
        n = sw_t if k in ("part_sb", "mi_sb", "lev_sb_y", "lev_sb_u",
                          "lev_sb_v", "uv_sb", "mv_sb") else bw_t
        out[k] = a[:, t * n:(t + 1) * n]
    return out


def _code_tile(side, d, tw, ph, h, t, kf, filt, update):
    """One tile's bytes and adapted CDFs from the port's or JAX's coder."""
    cands = expand_candidates(CAND_MODES)
    cands_sub = expand_candidates(tw2.SUB_MODES)
    sw_t = tw // 64
    sl = slice(t * sw_t, (t + 1) * sw_t)
    kw = dict(true_h=h, mi_col_off=t * tw // 4,
              frame_mi_cols=filt["w"] // 4, cdef_bits=filt["cdef_bits"],
              cdef_idx=filt["cdef_idx"][:, sl], kf=kf)
    if not kf:
        kw["gm_mv"] = (8, -16)
    mv = (lambda k: None) if kf else (lambda k: d[k])
    if side == "port":
        c = ttc.TileCoder(tw, ph, 100, update, **kw)
    else:
        c = jtc.TileCoder(tw, ph, 100, update, **kw)
    c.ccso_info = filt["ccso"]
    c.set_lr(filt["lr_types"], [
        None if u is None else {k: a[:, sl] for k, a in u.items()}
        for u in filt["lr_units"]])
    maps = (d["part"], d["mi_top"], d["lev_top_y"], d["lev_top_u"],
            d["lev_top_v"], d["mi_sub"], d["lev_sub_y"], d["lev_sub_u"],
            d["lev_sub_v"])
    if side == "port":
        return c.encode(*maps, cands, cands_sub, d["stx_sub"], d["part_sb"],
                        d["mi_sb"], d["lev_sb_y"], d["lev_sb_u"],
                        d["lev_sb_v"], d["uv_top"], d["uv_sub"], d["uv_sb"],
                        mv_top=mv("mv_top"), mv_sub=mv("mv_sub"),
                        mv_sb=mv("mv_sb"))
    return c.encode(*maps, mv("mv_top"), mv("mv_sub"), cands, cands_sub,
                    len(cands), len(cands_sub), stx_sub=d["stx_sub"],
                    part_sb=d["part_sb"], mi_sb=d["mi_sb"],
                    lev_sb_y=d["lev_sb_y"], lev_sb_u=d["lev_sb_u"],
                    lev_sb_v=d["lev_sb_v"], mv_sb=mv("mv_sb"),
                    uv_top=d["uv_top"], uv_sub=d["uv_sub"], uv_sb=d["uv_sb"])


@pytest.mark.parametrize("kf", [True, False])
@pytest.mark.parametrize("w,h,T,seed,update", [
    (512, 64, 2, 0, True), (512, 120, 4, 1, True), (256, 56, 2, 2, False),
    (1024, 64, 4, 3, True)])
def test_tile_coder_tile_columns(w, h, T, seed, update, kf):
    """Every tile of a frame with T tile columns, each coded by its own
    coder with its placement, the CDEF indices and LR units of its
    superblock columns and the frame's CCSO flags (a 256x256 unit starts
    inside tiles after the first): the port's and JAX's bytes and CDFs
    are equal."""
    ph = pad64(h)
    d = (_decision_maps if kf else _inter_maps)(w, h, seed)
    filt = dict(_filter_syntax(w, h, seed), w=w)
    tw = w // T
    for t in range(T):
        dt = _tile_maps(d, t, T, w)
        got, got_cdf = _code_tile("port", dt, tw, ph, h, t, kf, filt, update)
        want, want_cdf = _code_tile("jax", dt, tw, ph, h, t, kf, filt,
                                    update)
        assert len(got) > 20 and got == want, f"tile {t}"
        for k in want_cdf._t:
            np.testing.assert_array_equal(np.asarray(got_cdf._t[k]),
                                          np.asarray(want_cdf._t[k]))


# ------------------------------------------------------------------ #
# the JAX encoder's fixtures

def _tile_clip(w, h, n, seed=5):
    """tests/data/torch_dec/make_streams.py::tile_clip (the two_tiles
    fixture's source)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = np.clip(120 + 70 * np.sin((xx + yy + 5 * t) / 9.0) +
                    (rng.randint(-40, 41, (h, w)) * ((xx // 32) % 2)), 0,
                    255).astype(np.uint8)
        u = np.clip(120 + 30 * np.sin((xx[::2, ::2] + 2 * t) / 30.0), 0,
                    255).astype(np.uint8)
        v = np.clip(130 + 30 * np.cos((yy[::2, ::2] + t) / 20.0), 0,
                    255).astype(np.uint8)
        out.append((y, u, v))
    return out


def _config(c):
    cfg = EncoderConfig(c["width"], c["height"], qindex=c["qindex"],
                        bit_depth=c["bit_depth"], tile_cols=c["tile_cols"])
    if c["preset"] is not None:
        cfg = tpresets.apply_preset(cfg, c["preset"])
    return replace(cfg, **c["overrides"])


def _source(entry):
    s, c = entry["source"], entry["config"]
    make = _tile_clip if s["kind"] == "tile_clip" else getattr(inputs,
                                                               s["kind"])
    return make(c["width"], c["height"], s["n"], seed=s["seed"])


def _md5(planes, bd):
    dt = np.uint8 if bd == 8 else np.uint16
    m = hashlib.md5()
    for p in planes:
        m.update(np.asarray(p).astype(dt).tobytes())
    return m.hexdigest()


def _payloads(name):
    path = (DEC if name == "two_tiles" else FIX) / f"{name}.ivf"
    with open(path, "rb") as f:
        return [p for p, _ in read_ivf(f)[1]]


def test_fixtures_cover_the_slice():
    """Four and two tile columns; the LR/CCSO entry's P frames signal LR and
    CCSO; the kinds of frame: key, low-delay P, compound pyramid, 10-bit."""
    assert {"key_t4", "p4_lr_ccso", "ten_bit_t2", "pyramid_t2"} <= set(MD5)
    assert MD5["key_t4"]["config"]["tile_cols"] == 4
    e = MD5["p4_lr_ccso"]
    assert e["config"]["preset"] == 4 and e["frame_types"] == [0, 1, 1]
    assert any(k > 0 for k in e["seen"]["lr"])
    assert any(k > 0 for k in e["seen"]["ccso"])
    assert MD5["pyramid_t2"]["frame_types"] == [0, 1, 1, "overlay",
                                                "overlay"]
    assert MD5["ten_bit_t2"]["bit_depth"] == 10
    assert all(ENTRIES[n]["config"]["tile_cols"] > 1 for n in NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_port_encoder_matches_fixture(name):
    """The port's encoder on the fixture's source and configuration: the
    JAX encoder's payloads byte for byte and its recons."""
    entry = ENTRIES[name]
    c, frames = entry["config"], _source(entry)
    cfg = _config(c)
    if entry["encoder"] == "intra":
        payloads, recons = IntraEncoder(cfg, device="cpu").encode_frames(
            frames)
    elif entry["encoder"] == "video":
        enc = VideoEncoder(cfg, keyint=64, device="cpu")
        out = [enc.encode_frame(*f) for f in frames]
        payloads, recons = [p for p, _ in out], [r for _, r in out]
    else:
        enc = VideoEncoder(cfg, keyint=64, pyramid=True, gop=c["gop"],
                           tf=c["tf"], device="cpu")
        payloads, recons = enc.encode_frames(frames)
        tail = enc.flush()
        payloads, recons = payloads + tail[0], recons + tail[1]
    assert payloads == _payloads(name)
    assert [_md5(r, entry["bit_depth"]) for r in recons] == entry["frames"]


@pytest.mark.parametrize("name", NAMES)
def test_port_decoder_matches_fixture(name):
    """The port's decoder (CCSO syntax on for the CCSO stream) gives the
    JAX encoder's recons in display order."""
    entry = ENTRIES[name]
    ccso = entry["config"]["overrides"].get("enable_ccso", False)
    dec = tdec.Decoder(ccso=ccso, device="cpu")
    outs = [o for o in map(dec.decode_frame_obus, _payloads(name))
            if o is not None]
    assert [_md5(o, entry["bit_depth"]) for o in outs] == entry["frames"]


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


@pytest.mark.parametrize("name", [n for n in NAMES if not ENTRIES[n][
    "config"]["overrides"].get("enable_ccso")])
def test_fixture_oracle(name, tmp_path):
    """tools/av1dec (libavcodec) decodes each standard fixture to the JAX
    encoder's recons (a CCSO stream is not standard AV1)."""
    if not AV1DEC.exists() and subprocess.run(
            f"gcc -O2 -o {AV1DEC} {AV1DEC}.c -lavformat -lavcodec -lavutil",
            shell=True, capture_output=True).returncode != 0:
        pytest.skip("libavcodec is absent: tools/av1dec does not build")
    e = ENTRIES[name]
    c = e["config"]
    assert _av1dec_md5s((DEC if name == "two_tiles" else FIX) /
                        f"{name}.ivf", c["width"], c["height"],
                        len(e["frames"]), e["bit_depth"],
                        tmp_path) == e["frames"]


# ------------------------------------------------------------------ #
# the settings

_TILE_CONFIGS = [
    dict(part_search=False, tile_cols=2), dict(tile_cols=3),
    dict(tile_cols=0), dict(tile_cols=4, width=192), dict(tile_cols=2),
    dict(tile_cols=8, width=512), dict(tile_cols=2, bit_depth=10),
    dict(tile_cols=2, enable_cdef=True, enable_lr=True, enable_ccso=True)]


@pytest.mark.parametrize("change", range(len(_TILE_CONFIGS)))
def test_encoder_tile_settings_like_jax(change):
    """IntraEncoder and VideoEncoder accept the tile settings JAX's accept,
    and raise its errors with its messages (the flat path with tiles, a
    count that is not a power of two, widths the tiles do not divide)."""
    def outcome(cfg_cls, make):
        cfg = replace(cfg_cls(256, 64), **_TILE_CONFIGS[change])
        try:
            make(cfg)
        except (ValueError, NotImplementedError) as e:
            return type(e).__name__, str(e)
        return None
    want = outcome(jie.EncoderConfig, jie.IntraEncoder)
    assert outcome(EncoderConfig,
                   lambda c: IntraEncoder(c, device="cpu")) == want
    assert outcome(EncoderConfig,
                   lambda c: VideoEncoder(c, device="cpu")) == want
    assert (want is None) == (change >= 4)


@pytest.mark.parametrize("change", [
    {"tile_cols": 2}, {"tile_cols": 4}, {"tile_cols": 4, "width": 128},
    {"tile_cols": 2, "width": 192}, {"tile_cols": 6}, {"tile_cols": 64},
    {"width": 4160}, {"width": 4160, "tile_cols": 2}])
def test_verify_settings_tiles(change):
    """verify_settings' tile checks (a power of two, SB-aligned equal
    widths; tiles mandatory above 4096) give JAX's outcome and message."""
    def outcome(cls, verify):
        try:
            verify(replace(cls(256, 64), **change))
        except ValueError as e:
            return str(e)
        return None
    assert outcome(EncoderConfig, tpresets.verify_settings) == \
        outcome(jie.EncoderConfig, jpresets.verify_settings)


# ------------------------------------------------------------------ #
# parallel.mesh

CPU2 = ["cpu", "cpu"]


def _bytes_entry(data):
    return dict(md5=hashlib.md5(data).hexdigest(), bytes=len(data))


def _recon_entry(rec, dtype):
    a = rec.cpu().numpy().astype(dtype)
    return dict(md5=hashlib.md5(a.tobytes()).hexdigest(),
                shape=list(a.shape))


@pytest.mark.parametrize("part_search", [False, True])
def test_sharded_video_encode_bytes(part_search):
    """Key-aligned GOP chunks on two devices (threads), every chunk after
    the first without a sequence header: the serial encode's bytes, and
    the JAX module's (sharded and serial)."""
    got = mesh.sharded_video_encode_bytes(CPU2, part_search=part_search)
    want = mesh.sharded_video_encode_bytes(CPU2, shard=False,
                                           part_search=part_search)
    assert len(got) > 200 and got == want
    assert _bytes_entry(got) == MESH["video"][str(part_search)]


@pytest.mark.parametrize("n_tiles", [2, 4])
def test_sharded_tile_encode_bytes(n_tiles):
    """A key frame's tile columns scanned on the mesh's devices (a host
    thread each): the one-device payload and the JAX module's, which the
    port's decoder reads."""
    got = mesh.sharded_tile_encode_bytes(CPU2, n_tiles=n_tiles)
    want = mesh.sharded_tile_encode_bytes(CPU2, n_tiles=n_tiles,
                                          shard=False)
    assert len(got) > 500 and got == want
    assert _bytes_entry(got) == MESH["tiles"][str(n_tiles)]
    assert tdec.Decoder(device="cpu").decode_frame_obus(got) is not None


@pytest.mark.parametrize("tile_parallel", [1, 2])
def test_sharded_steps(tile_parallel):
    """The encode and pipeline steps split over two devices: the one-call
    recon and levels, the per-device sums adding up to the one-call sum;
    and both equal to the JAX module's on a mesh of the same grid (its
    float32 analysis total to a relative 1e-6: the sums are associated
    differently)."""
    rec, total = mesh.sharded_encode_step(CPU2, tile_parallel)
    rec1, total1 = mesh.sharded_encode_step(CPU2, tile_parallel, shard=False)
    assert torch.equal(rec, rec1)
    assert rec.shape == (2 // tile_parallel, 64 * tile_parallel, 128)
    assert total == pytest.approx(total1, rel=1e-6) and total > 0
    want = MESH["encode_step"][str(tile_parallel)]
    assert _recon_entry(rec, np.uint8) == dict(md5=want["md5"],
                                               shape=want["shape"])
    assert total == pytest.approx(want["total"], rel=1e-6)
    rec, bits = mesh.sharded_pipeline_step(CPU2, tile_parallel)
    rec1, bits1 = mesh.sharded_pipeline_step(CPU2, tile_parallel,
                                             shard=False)
    assert torch.equal(rec, rec1) and bits == bits1 > 0
    want = MESH["pipeline_step"][str(tile_parallel)]
    assert _recon_entry(rec, np.int32) == dict(md5=want["md5"],
                                               shape=want["shape"])
    assert bits == want["bits"]


def test_make_mesh_counts_devices():
    """make_mesh takes CUDA devices only, and refuses more than exist."""
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested {n + 1} devices, have "
                                         f"{n}"):
        mesh.make_mesh(n + 1)
    if n == 0:
        with pytest.raises(ValueError, match="have 0"):
            mesh.make_mesh()


def test_threads_share_one_scan_shape(monkeypatch):
    """Threads (more than the cores) scanning one kept shape take turns on
    its static buffers: each call's outputs equal its serial run's (a call
    that read another's filled inputs would differ).  The CPU keeps no
    scan, so the test keeps them here as the card does."""
    import os
    import sys
    import threading
    monkeypatch.setattr(tw2, "_KEEP", ("cuda", "cpu"))
    monkeypatch.setattr(tw2, "_SCANS", {})
    n = (os.cpu_count() or 4) + 1
    rng = np.random.RandomState(7)
    srcs = [torch.from_numpy(rng.randint(0, 256, (1, 64, 64)).astype(
        np.uint8)) for _ in range(n)]
    free = torch.full((1, 2, 2), -1, dtype=torch.int32)
    free_sb = torch.full((1, 1, 1), -1, dtype=torch.int32)
    scan = lambda k: tw2.encode_plane_wavefront_part(
        srcs[k], 32, 60 + 10 * k, free, free_sb, tx_search=True)
    want = [scan(k) for k in range(n)]
    assert len(tw2._SCANS) == 1
    got = [None] * n
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda k=k: got.__setitem__(
            k, scan(k))) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    for k in range(n):
        assert all(torch.equal(a, b) for a, b in zip(got[k], want[k])), k
