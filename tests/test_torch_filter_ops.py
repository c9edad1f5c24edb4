"""The port's in-loop filter ops and searches against the reference
goldens (``golden_cdef``, ``golden_ccso``, ``golden_restoration``: the
cases of ``tests/test_cdef.py``, ``test_ccso.py`` and
``test_restoration.py``) and against the JAX package on the same inputs
(numpy seeds, 64x64 or 128x64 planes), on the CPU.  Every comparison is
exact.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.ec import lr_syntax as jlrs
from svtav1_tpu.ec.range_coder import RangeDecoder
from svtav1_tpu.encoder import cdef_search as jcds
from svtav1_tpu.ops import ccso as jccso
from svtav1_tpu.ops import cdef as jcdef
from svtav1_tpu.ops import lr_frame as jlrf
from svtav1_tpu.ops import restoration as jrest
from svtav1_tpu.spec import cdf as jcdf
from svtav1_tpu_torch.cuda.inputs import banded_frames, edge_frames
from svtav1_tpu_torch.ec import lr_syntax as tlrs
from svtav1_tpu_torch.ec.range_coder import RangeEncoder
from svtav1_tpu_torch.encoder import cdef_search as tcds
from svtav1_tpu_torch.encoder import intra_encoder as tie
from svtav1_tpu_torch.ops import ccso as tccso
from svtav1_tpu_torch.ops import cdef as tcdef
from svtav1_tpu_torch.ops import lr_frame as tlrf
from svtav1_tpu_torch.ops import restoration as trest
from svtav1_tpu_torch.spec import cdf as tcdf

DATA = Path(__file__).parent / "data"
T = torch.from_numpy


def _golden(name):
    return np.load(DATA / f"golden_{name}.npz")


# ---- goldens ------------------------------------------------------------

def test_find_dir_golden():
    d = _golden("cdef")
    dirs, var = tcdef.find_dir(T(d["fd_blocks"].astype(np.int32)))
    np.testing.assert_array_equal(dirs.numpy(), d["fd_dirs"])
    np.testing.assert_array_equal(var.numpy(), d["fd_vars"])


@pytest.mark.parametrize("case", range(36))
def test_cdef_filter_golden(case):
    d = _golden("cdef")
    src = d[f"f{case}_src"].astype(np.int32)      # 12x12, block at (2, 2)
    pri, sec, dd, pdmp, sdmp = (int(v) for v in d[f"f{case}_cfg"])
    got = tcdef.cdef_filter_plane(T(src[None]), torch.full((1, 1, 1), dd),
                                  pri, sec, pdmp, sdmp)[0]
    np.testing.assert_array_equal(got.numpy(), d[f"f{case}_dst"])


@pytest.mark.parametrize("case", range(48))
def test_ccso_filter_golden(case):
    d = _golden("ccso")
    sup, scale, mbl, eclf, bo, thr = (int(v) for v in d[f"c{case}_cfg"])
    got = tccso.ccso_filter_plane(
        T(d[f"c{case}_dst"].astype(np.int32)[None]),
        T(d[f"c{case}_luma"].astype(np.int32)[None]), d[f"c{case}_lut"],
        filter_support=sup, quant_step=thr, max_band_log2=mbl,
        edge_clf=eclf, bo_only=bool(bo), y_uv_scale=scale)[0]
    np.testing.assert_array_equal(got.numpy(), d[f"c{case}_out"])


def test_restoration_tables_golden():
    d = _golden("restoration")
    np.testing.assert_array_equal(trest.X_BY_XPLUS1, d["xbyx"])
    np.testing.assert_array_equal(trest.ONE_BY_X, d["onebyx"])


@pytest.mark.parametrize("case", range(42))
def test_sgr_golden(case):
    d = _golden("restoration")
    w, h, eps, xq0, xq1 = (int(v) for v in d[f"s{case}_cfg"])
    got = trest.apply_sgr(T(d[f"s{case}_ext"].astype(np.int32)[None]), eps,
                          xq0, xq1)[0]
    np.testing.assert_array_equal(got.numpy(), d[f"s{case}_dst"])


@pytest.mark.parametrize("case", range(12))
def test_wiener_golden(case):
    d = _golden("restoration")
    ext = d[f"w{case}_ext"].astype(np.int32)
    # the C reads +-7 borders but the taps cover +-3
    win = ext[4:ext.shape[0] - 4, 4:ext.shape[1] - 4]
    got = trest.wiener_filter(T(win[None]), d[f"w{case}_fx"],
                              d[f"w{case}_fy"])[0]
    np.testing.assert_array_equal(got.numpy(), d[f"w{case}_dst"])


# ---- CDEF against JAX ---------------------------------------------------

def _wrap_blocks():
    """Blocks of 10-bit values read with coeff_shift 0 (as the golden's
    find_dir call reads its blocks): 0/1023 checkerboards, stripes and
    random patterns, and random 10-bit blocks.  Their direction costs pass
    2**31, where the reference's int32 costs wrap (8-bit values stay
    below: at most 64 * 128**2 * 840)."""
    rng = np.random.RandomState(3)
    blocks = [np.indices((8, 8)).sum(0) % 2 * 1023,
              np.tile([0, 1023], (8, 4)), np.tile([[0], [1023]], (4, 8))]
    blocks += [rng.randint(0, 2, (8, 8)) * 1023 for _ in range(40)]
    blocks += [rng.randint(0, 1024, (8, 8)) for _ in range(40)]
    return np.stack(blocks).astype(np.int32)


def _unwrapped_find_dir(blocks):
    """find_dir with exact int64 costs (no wraparound)."""
    x = blocks.reshape(-1, 64).astype(np.int64) - 128
    p2 = (x @ tcdef._partial_mats_np().astype(np.int64)).reshape(
        -1, 8, 15) ** 2
    div = tcdef._DIV_TABLE
    full = lambda d: ((p2[:, d, :7] * div[1:8]).sum(-1) +
                      (p2[:, d, 8:15] * div[1:8][::-1]).sum(-1) +
                      p2[:, d, 7] * div[8])
    odd = lambda d: (p2[:, d, 3:8].sum(-1) * div[8] +
                     ((p2[:, d, 0:3] + p2[:, d, 8:11][:, ::-1]) *
                      div[2:8:2]).sum(-1))
    costs = np.stack([full(0), odd(1), p2[:, 2, :8].sum(-1) * div[8], odd(3),
                      full(4), odd(5), p2[:, 6, :8].sum(-1) * div[8], odd(7)],
                     -1)
    return costs, costs.argmax(-1)


def test_find_dir_wraps_like_jax():
    blocks = _wrap_blocks()
    costs, dirs = _unwrapped_find_dir(blocks)
    assert (costs >= 2 ** 31).any(), "no cost wraps int32"
    got = tcdef.find_dir(T(blocks))
    want = jcdef.find_dir(jnp.asarray(blocks))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the wrap decides some directions: exact costs would pick others
    assert (dirs != got[0].numpy()).any()


def _planes(seed, h=64, w=128):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(128 + 60 * np.sin((xx + 2 * yy) / 5.0) +
                rng.randint(-20, 21, (h, w)), 0, 255)
    u = rng.randint(60, 200, (h // 2, w // 2))
    v = np.clip(128 + 50 * np.sign(np.sin(xx[::2, ::2] / 3.0)) +
                rng.randint(-9, 10, (h // 2, w // 2)), 0, 255)
    return tuple(p.astype(np.int32) for p in (y, u, v))


@pytest.mark.parametrize("seed", [0, 1])
def test_find_dir_plane(seed):
    y = _planes(seed)[0]
    got = tcdef.find_dir_plane(T(y))
    want = jcdef.find_dir_plane(jnp.asarray(y))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("block,damping", [(8, 3), (8, 6), (4, 4)])
def test_cdef_filter_plane_map(block, damping):
    rng = np.random.RandomState(block + damping)
    plane = _planes(damping, 32, 64)[0]
    bh, bw = 32 // block, 64 // block
    dmap = rng.randint(0, 8, (bh, bw)).astype(np.int32)
    pri = rng.choice([0, 1, 3, 4, 7, 12, 15], (bh, bw)).astype(np.int32)
    sec = rng.choice([0, 1, 2, 4], (bh, bw)).astype(np.int32)
    got = tcdef.cdef_filter_plane_map(tcdef.pad_plane(T(plane)), T(dmap),
                                      T(pri), T(sec), damping, damping - 1,
                                      block)
    want = jcdef.cdef_filter_plane_map(jcdef.pad_plane(plane), dmap, pri,
                                       sec, damping, damping - 1, block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _skip8(seed, h=64, w=128):
    return np.random.RandomState(seed).rand(h // 8, w // 8) < 0.3


@pytest.mark.parametrize("damping", [3, 4, 6])
def test_cdef_apply_frame(damping):
    y, u, v = _planes(damping)
    rng = np.random.RandomState(damping)
    skip = _skip8(damping)
    idx = rng.randint(0, 4, skip.shape)
    tabs = [np.array(t, np.int32) for t in ([0, 3, 6, 12], [0, 1, 2, 4],
                                             [2, 0, 8, 4], [4, 1, 0, 2])]
    got = tcdef.cdef_apply_frame(T(y), T(u), T(v), T(skip), T(idx), *map(
        T, tabs), damping)
    want = jcdef.cdef_apply_frame(y, u, v, skip, idx, *tabs, damping)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _src_rec(seed, h=64, w=64):
    src = _planes(seed, h, w)
    rng = np.random.RandomState(seed + 10)
    rec = tuple(np.clip(p + rng.randint(-6, 7, p.shape), 0, 255)
                .astype(np.int32) for p in src)
    return src, rec


def test_cdef_candidate_sse():
    src, rec = _src_rec(0)
    skip = _skip8(0, 64, 64)
    got = tcds.cdef_candidate_sse(tuple(map(T, src)), tuple(map(T, rec)),
                                  T(skip), tcds.CAND_PAIRS, 4)
    want = jcds.cdef_candidate_sse(
        *src, *rec, jnp.asarray(skip),
        jnp.asarray(np.array(jcds.CAND_PAIRS, np.int32)), jnp.int32(4))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed,qindex", [(1, 60), (2, 100), (3, 200)])
def test_cdef_search_frame(seed, qindex):
    src, rec = _src_rec(seed)
    skip = _skip8(seed, 64, 64)
    lam = 0.035 * 400.0 * qindex / 16.0
    got = tcds.cdef_search_frame(tuple(map(T, src)), tuple(map(T, rec)),
                                 skip, qindex, lam)
    want = jcds.cdef_search_frame(src, rec, skip, qindex, lam)
    np.testing.assert_array_equal(got.pop("idx_map"), want.pop("idx_map"))
    assert got == want
    filt = tcdef.cdef_apply_params(tuple(map(T, rec)), skip, dict(
        got, idx_map=np.zeros((1, 1), np.int32)))
    wfilt = jcdef.cdef_apply_params(rec, skip, dict(
        want, idx_map=np.zeros((1, 1), np.int32)))
    for g, w in zip(filt, wfilt):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_skip8(seed):
    rng = np.random.RandomState(seed)
    bh, bw = 4, 6
    def lev(*s):                     # about half the blocks coded
        a = np.zeros(s, np.int32)
        a[..., 0, 0] = rng.rand(*s[:-2]) < 0.5
        return a
    args = (rng.randint(0, 2, (bh, bw)), lev(bh, bw, 32, 32),
            lev(bh, bw, 16, 16), lev(bh, bw, 16, 16), lev(bh, bw, 4, 16, 16),
            lev(bh, bw, 4, 8, 8), lev(bh, bw, 4, 8, 8),
            rng.randint(0, 2, (bh // 2, bw // 2)),
            *(lev(bh // 2, bw // 2, 32, 32) for _ in range(3)))
    got = tcds.build_skip8(*args)
    np.testing.assert_array_equal(got, jcds.build_skip8(*args))
    assert got.any() and not got.all()


# ---- CCSO ---------------------------------------------------------------

def _ccso_info(seed, uh, uw):
    rng = np.random.RandomState(seed)
    planes = []
    for p in range(3):
        lut = np.zeros(128, np.int32)
        lut[:16] = rng.choice(tccso.CCSO_OFFSETS, 16)
        planes.append(None if p == seed % 3 else dict(
            quant_idx=int(rng.randint(4)), support=int(rng.randint(6)),
            edge_clf=int(rng.randint(2)), max_band_log2=0, bo_only=0,
            lut=lut, flags=rng.rand(uh, uw) < 0.6))
    return {"planes": planes}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ccso_apply_frame(seed):
    src, rec = _src_rec(seed, 64, 512)
    info = _ccso_info(seed, 1, 2)
    got = tccso.ccso_apply_frame(tuple(map(T, rec)), T(src[0]), info)
    want = jccso.ccso_apply_frame(rec, src[0], info)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- loop restoration ---------------------------------------------------

@pytest.mark.parametrize("eps", range(16))
def test_apply_sgr(eps):
    rng = np.random.RandomState(eps)
    ext = rng.randint(0, 256, (2, 22, 38)).astype(np.int32)
    xq = rng.randint(-96, 32), rng.randint(-32, 96)
    got = trest.apply_sgr(T(ext), eps, *xq)
    want = jrest.apply_sgr(jnp.asarray(ext), eps, *xq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_boxsum_wraps_like_jax():
    """At 256x256 the JAX package's int32 cumulative sums of squared
    pixels wrap; their differences (the box sums) still come out right,
    and the port's int64 sums give the same SGR output."""
    rng = np.random.RandomState(9)
    ext = rng.randint(200, 256, (262, 262)).astype(np.int32)
    assert (ext.astype(np.int64) ** 2).sum() >= 2 ** 31
    for r in (1, 2):
        got = trest._boxsum(T(ext * ext), r)
        want = jrest._boxsum(jnp.asarray(ext * ext), r)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = trest.apply_sgr(T(ext), 0, -20, 40)
    want = jrest.apply_sgr(jnp.asarray(ext), 0, -20, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wiener_filter_batched():
    """One call with a kernel per window equals the JAX filter per window."""
    rng = np.random.RandomState(5)
    ext = rng.randint(0, 256, (3, 20, 30)).astype(np.int32)
    taps = [(rng.randint(-5, 11), rng.randint(-23, 9), rng.randint(-17, 47))
            for _ in range(6)]
    kh = np.stack([tlrf._wiener_kernel(t) for t in taps[:3]])
    kv = np.stack([tlrf._wiener_kernel(t) for t in taps[3:]])
    got = trest.wiener_filter(T(ext), T(kh), T(kv))
    for i in range(3):
        want = jrest.wiener_filter(jnp.asarray(ext[i]), kh[i], kv[i])
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def _lr_units(kinds, seed):
    rng = np.random.RandomState(seed)
    uw = len(kinds)
    return {"type": np.array([kinds], np.int32),
            "eps": rng.randint(0, 16, (1, uw)).astype(np.int32),
            "xqd": np.stack([rng.randint(-96, 32, (1, uw)),
                             rng.randint(-32, 96, (1, uw))], -1)
            .astype(np.int32),
            "taps_v": np.stack([rng.randint(-5, 11, (1, uw)),
                                rng.randint(-23, 9, (1, uw)),
                                rng.randint(-17, 47, (1, uw))], -1)
            .astype(np.int32),
            "taps_h": np.stack([rng.randint(-5, 11, (1, uw)),
                                rng.randint(-23, 9, (1, uw)),
                                rng.randint(-17, 47, (1, uw))], -1)
            .astype(np.int32)}


@pytest.mark.parametrize("kinds", [((2, 1), (0, 2), None),
                                   ((1, 0), None, (1, 2))])
def test_lr_apply_frame(kinds):
    """NONE, SGR and Wiener units (and a plane left alone) at 128x64."""
    src, cdef = _src_rec(7, 64, 128)
    db = _src_rec(8, 64, 128)[1]
    infos = [None if k is None else _lr_units(k, p)
             for p, k in enumerate(kinds)]
    got = tlrf.lr_apply_frame(tuple(map(T, cdef)), tuple(map(T, db)), infos)
    want = jlrf.lr_apply_frame(cdef, db, infos)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(4))
def test_lr_unit_writer_roundtrip(seed):
    """The port's LR unit writer, read back by the JAX package's reader."""
    rng = np.random.RandomState(seed)
    enc = RangeEncoder()
    cdf = tcdf.CdfContext(100, update=True)
    refs = [tlrs.default_ref_state() for _ in range(3)]
    written = []
    for _ in range(30):
        p = int(rng.randint(3))
        ftype = int(rng.randint(1, 4))
        utype = int(rng.choice({1: [0, 1], 2: [0, 2], 3: [0, 1, 2]}[ftype]))
        unit = {"eps": int(rng.randint(16)),
                "xqd": [int(rng.randint(-96, 32)), int(rng.randint(-32, 96))],
                "taps_v": [0 if p and i == 0 else
                           int(rng.randint(jlrs.WIENER_TAP_MIN[i],
                                           jlrs.WIENER_TAP_MAX[i] + 1))
                           for i in range(3)],
                "taps_h": [0 if p and i == 0 else
                           int(rng.randint(jlrs.WIENER_TAP_MIN[i],
                                           jlrs.WIENER_TAP_MAX[i] + 1))
                           for i in range(3)]}
        r0, r1 = jlrs.SGR_R[unit["eps"]]
        if r0 == 0:                  # as the search sets them
            unit["xqd"][0] = 0
        if r1 == 0:
            unit["xqd"][1] = min(95, max(-32, 128 - unit["xqd"][0]))
        tlrs.write_lr_unit(enc, cdf, ftype, utype, unit, refs[p], p > 0)
        written.append((p, ftype, utype, unit))
    dec = RangeDecoder(enc.done())
    jcdf_ = jcdf.CdfContext(100, update=True)
    jrefs = [jlrs.default_ref_state() for _ in range(3)]
    for p, ftype, utype, unit in written:
        t, eps, xqd, tv, th = jlrs.read_lr_unit(dec, jcdf_, ftype, jrefs[p],
                                                p > 0)
        assert t == utype
        if t == jlrs.RESTORE_SGRPROJ:
            assert (eps, list(xqd)) == (unit["eps"], unit["xqd"])
        elif t == jlrs.RESTORE_WIENER:
            assert list(tv) == unit["taps_v"] and list(th) == unit["taps_h"]


def test_filtered_cell_crop_fires_every_tool(monkeypatch):
    """The filtered cell's frames (the first frames of the banded and the
    edge clip), cut to 128x64 at q100, turn on CDEF (a nonzero strength),
    CCSO (a plane on) and LR (a plane on) in the port on the CPU."""
    got = {}
    for name in ("cdef_search_frame", "ccso_search_frame",
                 "lr_search_frame"):
        def kept(*a, _fn=getattr(tie, name), _name=name, **kw):
            out = _fn(*a, **kw)
            got.setdefault(_name, []).append(out)
            return out
        monkeypatch.setattr(tie, name, kept)
    w, h = 128, 64
    frames = [tuple(np.ascontiguousarray(p[:h >> (k > 0), :w >> (k > 0)])
                    for k, p in enumerate(f))
              for f in (banded_frames(1920, 1088, 1)[0],
                        edge_frames(1920, 1088, 1)[0])]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        enc = tie.IntraEncoder(tie.EncoderConfig(
            w, h, qindex=100, enable_cdef=True, enable_lr=True,
            enable_ccso=True), device="cpu")
        payloads, _ = enc.host_finish(enc.device_encode(frames))
    finally:
        torch.set_num_threads(n)
    assert len(payloads) == 2 and all(payloads)
    assert any(s != (0, 0) for c in got["cdef_search_frame"]
               for s in c["y_strengths"] + c["uv_strengths"])
    assert any(o is not None and any(p is not None for p in o["planes"])
               for o in got["ccso_search_frame"])
    assert any(any(types) for types, _ in got["lr_search_frame"])
