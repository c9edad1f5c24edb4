"""The port's ops at 10 bits against the JAX package's on the same inputs
(numpy seeds, pixels in [0, 1023]), on the CPU.

Normative ops are held exactly: the forward and inverse transforms of
every (tx size, tx type) the encoder's scans use, with residuals in
+-1023; the quantizer, the dequantizer and quantize_dq_opt with tx_gain;
the 13 intra predictors at 8, 16, 32 and 64; uniform and partition
deblocking and the DLF search's SSE; CDEF, CCSO, SGR and Wiener apply;
motion compensation under each interpolation filter.  The filter searches
(CDEF, CCSO, LR) must make the same choices on fixed inputs.  Temporal
filtering is held to one step, as at 8 bits (float32 exp).  The plain
wavefront (luma, paired U+V, the mixed form with inter lanes) is held to
JAX's at 128x64 under ``test_torch_wavefront._agree``.  For the CUDA
kernel's 10-bit form (which runs only on the card): its constants
(tx_params at bd=10) drive the generated transform networks, compiled by
gcc, to the port's inv_txfm2d, and its quantizer's reciprocal division is
exact over every numerator a 10-bit block can make.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.encoder import cdef_search as jcds
from svtav1_tpu.encoder import ccso_search as jccs
from svtav1_tpu.encoder import lr_search as jlrs
from svtav1_tpu.encoder import wavefront as jwf
from svtav1_tpu.encoder.intra_encoder import CAND_MODES
from svtav1_tpu.ops import ccso as jccso
from svtav1_tpu.ops import cdef as jcdef
from svtav1_tpu.ops import deblock as jdb
from svtav1_tpu.ops import intra as jintra
from svtav1_tpu.ops import intra_dir as jdir
from svtav1_tpu.ops import lr_frame as jlrf
from svtav1_tpu.ops import mc as jmc
from svtav1_tpu.ops import quant as jq
from svtav1_tpu.ops import restoration as jrest
from svtav1_tpu.ops import tf as jtf
from svtav1_tpu.ops import transforms as jtx
from svtav1_tpu.spec import tables as jtbl
from svtav1_tpu.spec import txfm as jT
from svtav1_tpu_torch.cuda import wavefront_kernel as wk
from svtav1_tpu_torch.cuda.inputs import moving_frames10, plane_src10
from svtav1_tpu_torch.encoder import ccso_search as tccs
from svtav1_tpu_torch.encoder import cdef_search as tcds
from svtav1_tpu_torch.encoder import intra_encoder as tie
from svtav1_tpu_torch.encoder import lr_search as tlrs
from svtav1_tpu_torch.encoder import wavefront as twf
from svtav1_tpu_torch.ops import ccso as tccso
from svtav1_tpu_torch.ops import cdef as tcdef
from svtav1_tpu_torch.ops import deblock as tdb
from svtav1_tpu_torch.ops import intra, intra_dir, quant, transforms
from svtav1_tpu_torch.ops import lr_frame as tlrf
from svtav1_tpu_torch.ops import mc as tmc
from svtav1_tpu_torch.ops import restoration as trest
from svtav1_tpu_torch.ops import tf as ttf
from test_torch_part import one_thread
from test_torch_wavefront import _agree, _net, _rshift, nets_lib  # noqa

BD = 10
PEAK = (1 << BD) - 1
T = torch.from_numpy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_thread():
        yield


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


def _planes(seed, h=64, w=128):
    """Luma with sharp edges and noise, two chroma planes: int32 in
    [0, 1023]."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(512 + 280 * np.sign(np.sin((xx + 2 * yy) / 6.0)) +
                rng.randint(-80, 81, (h, w)), 0, PEAK)
    u = rng.randint(240, 800, (h // 2, w // 2))
    v = np.clip(512 + 200 * np.sign(np.sin(xx[::2, ::2] / 3.0)) +
                rng.randint(-36, 37, (h // 2, w // 2)), 0, PEAK)
    return tuple(p.astype(np.int32) for p in (y, u, v))


def _src_rec(seed, h=64, w=128):
    src = _planes(seed, h, w)
    rng = np.random.RandomState(seed + 10)
    rec = tuple(np.clip(p + rng.randint(-24, 25, p.shape), 0, PEAK)
                .astype(np.int32) for p in src)
    return src, rec


# ---- transforms ----------------------------------------------------------

# the scans' (tx_size, tx_type): chroma 8x8 with the implied uv types, the
# five searched 16x16 luma types and 16x16 chroma's, 32x32 and 64x64 DCT
TX_CASES = ([(jT.TX_8X8, t) for t in (0, 1, 2, 3)] +
            [(jT.TX_16X16, t) for t in (0, 3, 1, 2, 9)] +
            [(jT.TX_32X32, 0), (jT.TX_64X64, 0)])


@pytest.mark.parametrize("tx_size,tx_type", TX_CASES)
def test_transforms_10bit(tx_size, tx_type):
    n = jT.TX_W[tx_size]
    rng = np.random.RandomState(tx_size * 16 + tx_type)
    res = rng.randint(-PEAK, PEAK + 1, (4, n, n)).astype(np.int32)
    res[0] = PEAK * np.sign(rng.randn(n, n))           # the extremes
    res[1] = PEAK
    got = transforms.fwd_txfm2d(T(res), tx_size, tx_type, BD)
    _eq(got, jtx.fwd_txfm2d(res, tx_size, tx_type, BD), "fwd")
    # dequantized coefficients up to the dequantizer's range, 2^17
    coef = np.zeros((4, n, n), np.int32)
    m = min(n, 32)
    coef[:, :m, :m] = rng.randint(-1 << 17, 1 << 17, (4, m, m)) >> \
        rng.randint(0, 12, (4, m, m))
    coef[0, :m, :m] = np.asarray(got)[0, :m, :m]
    pred = rng.randint(0, PEAK + 1, (4, n, n)).astype(np.int32)
    inv = transforms.inv_txfm2d(T(coef), tx_size, tx_type, BD)
    want = jtx.inv_txfm2d(coef, tx_size, tx_type, BD)
    _eq(inv, want, "inv")
    _eq(transforms.add_residual_clip(T(pred), inv, BD),
        jtx.add_residual_clip(pred, want, BD), "recon")


# ---- quantizer -----------------------------------------------------------

@pytest.mark.parametrize("qindex", [0, 100, 255])
@pytest.mark.parametrize("tx_size", [jT.TX_8X8, jT.TX_16X16, jT.TX_32X32,
                                     jT.TX_64X64])
def test_quant_10bit(tx_size, qindex):
    g = quant.tx_gain(tx_size, BD)
    assert g == jq.tx_gain(tx_size, BD)
    n = jT.TX_W[tx_size]
    rng = np.random.RandomState(qindex * 8 + tx_size)
    coeffs = (rng.randint(-12000, 12001, (4, n, n)) *
              (rng.rand(4, n, n) < 0.4)).astype(np.int32)
    dc, ac = jtbl.qindex_to_dq(qindex, BD)
    lev = quant.quantize_dq(T(coeffs), tx_size, dc, ac, BD)
    _eq(lev, jq.quantize_dq(coeffs, tx_size, dc, ac, BD), "quantize")
    big = rng.randint(-(1 << 15) + 1, 1 << 15, (4, n, n)).astype(np.int32)
    _eq(quant.dequantize_dq(T(big), tx_size, dc, ac, BD),
        jq.dequantize_dq(big, tx_size, dc, ac, BD), "dequantize")
    lam = np.float32(twf._lambda(qindex))
    got = quant.quantize_dq_opt(T(coeffs), tx_size, dc, ac,
                                torch.tensor(lam), BD)
    jit_opt = jax.jit(jq.quantize_dq_opt, static_argnums=(1, 5))
    want = jit_opt(jnp.asarray(coeffs), tx_size, jnp.int32(dc),
                   jnp.int32(ac), jnp.float32(lam), BD)
    _eq(got, want, "quantize_dq_opt")


# ---- intra predictors ----------------------------------------------------

@pytest.mark.parametrize("n", [8, 16, 32, 64])
@pytest.mark.parametrize("mode", range(13))
def test_predictors_10bit(mode, n):
    rng = np.random.RandomState(13 * n + mode)
    above_ext = rng.randint(0, PEAK + 1, (3, 2 * n)).astype(np.int32)
    left_ext = rng.randint(0, PEAK + 1, (3, 2 * n)).astype(np.int32)
    corner = rng.randint(0, PEAK + 1, 3).astype(np.int32)
    if mode in intra_dir.MODE_ANGLE and mode not in (intra.V_PRED,
                                                     intra.H_PRED):
        got = intra_dir.dr_pred(mode, 0, T(above_ext), T(left_ext),
                                T(corner), n, BD)
        _eq(got, jdir.dr_pred(mode, 0, above_ext, left_ext, corner, n, BD))
        return
    above, left = above_ext[:, :n], left_ext[:, :n]
    for ha, hl in ((True, True), (True, False), (False, True),
                   (False, False)):
        if mode != intra.DC_PRED and not (ha and hl):
            continue
        got = intra.predict(mode, T(above), T(left), T(corner), ha, hl,
                            bd=BD)
        _eq(got, jintra.predict(mode, above, left, corner, ha, hl, bd=BD),
            f"{ha} {hl}")
        assert int(got.max()) > 255 or mode != intra.DC_PRED or \
            not (ha or hl)


# ---- deblocking ----------------------------------------------------------

@pytest.mark.parametrize("spacing,taps,valid_h", [
    (32, 14, False), (32, 14, True), (16, 6, False), (16, 6, True)])
def test_deblock_uniform_10bit(spacing, taps, valid_h):
    rng = np.random.RandomState(spacing + valid_h)
    plane = plane_src10(spacing, 2, 4 * spacing, 4 * spacing).astype(
        np.int32)
    plane += 24 * ((np.arange(4 * spacing)[None, None] // (spacing // 2))
                   % 3)
    plane = np.clip(plane + rng.randint(-3, 4, plane.shape), 0, PEAK)
    vh = 4 * spacing - spacing // 4 if valid_h else None
    got = tdb.deblock_plane_uniform(T(plane), spacing, taps, 30, 26, bd=BD,
                                    valid_h=vh)
    _eq(got, jdb.deblock_plane_uniform(plane, spacing, taps, 30, 26, bd=BD,
                                       valid_h=vh))
    assert not np.array_equal(got.numpy(), plane)


@pytest.mark.parametrize("spacing,taps,valid_h,with_sb", [
    (32, 14, False, True), (32, 14, True, False), (16, 6, False, False),
    (16, 6, True, True)])
def test_deblock_part_10bit(spacing, taps, valid_h, with_sb):
    rng = np.random.RandomState(spacing + 2 * valid_h + with_sb)
    B, h, w = 2, 4 * spacing, 4 * spacing
    yy, xx = np.mgrid[0:h, 0:w]
    hs = spacing // 2
    plane = np.stack([np.clip(480 + 160 * np.sin((xx + 9 * b) / 13.0) +
                              32 * ((xx // hs + yy // hs) % 3) +
                              rng.randint(-12, 13, (h, w)), 0, PEAK)
                      for b in range(B)]).astype(np.int32)
    part = rng.randint(0, 2, (B, 4, 4)).astype(np.int32)
    psb = rng.randint(0, 2, (B, 2, 2)).astype(np.int32) if with_sb else None
    vh = h - hs // 2 if valid_h else None
    t_psb = None if psb is None else T(psb)
    got = tdb.deblock_plane_part(T(plane), T(part), spacing, taps, 22, 17,
                                 bd=BD, part_sb=t_psb, valid_h=vh)
    _eq(got, jdb.deblock_plane_part(plane, part, spacing, taps, 22, 17,
                                    bd=BD, part_sb=psb, valid_h=vh))
    assert not np.array_equal(got.numpy(), plane)
    src = np.clip(plane + rng.randint(-24, 25, plane.shape), 0, PEAK)
    levels = [0, 6, 22]
    sse = tdb.dlf_sse_part(T(plane), T(src), T(part), levels, spacing, taps,
                           bd=BD, part_sb=t_psb, valid_h=vh)
    want = jdb.dlf_sse_part(plane, src, part, jnp.asarray(levels, jnp.int32),
                            spacing, taps, bd=BD, part_sb=psb, valid_h=vh)
    _eq(sse, want)


# ---- CDEF -----------------------------------------------------------------

def _skip8(seed, h=64, w=128):
    return np.random.RandomState(seed).rand(h // 8, w // 8) < 0.3


@pytest.mark.parametrize("damping", [3, 4, 6])
def test_cdef_apply_frame_10bit(damping):
    y, u, v = _planes(damping)
    rng = np.random.RandomState(damping)
    skip = _skip8(damping)
    idx = rng.randint(0, 4, skip.shape)
    tabs = [np.array(t, np.int32) for t in ([0, 3, 6, 12], [0, 1, 2, 4],
                                             [2, 0, 8, 4], [4, 1, 0, 2])]
    got = tcdef.cdef_apply_frame(T(y), T(u), T(v), T(skip), T(idx), *map(
        T, tabs), damping, BD)
    want = jcdef.cdef_apply_frame(y, u, v, skip, idx, *tabs, damping, BD)
    for g, w in zip(got, want):
        _eq(g, w)
    assert any(not np.array_equal(g.numpy(), p) for g, p in zip(got,
                                                                (y, u, v)))


@pytest.mark.parametrize("seed,qindex", [(1, 60), (2, 100), (3, 200)])
def test_cdef_search_frame_10bit(seed, qindex):
    src, rec = _src_rec(seed, 64, 64)
    skip = _skip8(seed, 64, 64)
    lam = 0.035 * 400.0 * qindex / 16.0
    got = tcds.cdef_search_frame(tuple(map(T, src)), tuple(map(T, rec)),
                                 skip, qindex, lam, BD)
    want = jcds.cdef_search_frame(src, rec, skip, qindex, lam, BD)
    _eq(got.pop("idx_map"), want.pop("idx_map"))
    assert got == want


# ---- CCSO -----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ccso_apply_frame_10bit(seed):
    src, rec = _src_rec(seed, 64, 512)
    rng = np.random.RandomState(seed)
    planes = []
    for p in range(3):
        lut = np.zeros(128, np.int32)
        lut[:16] = rng.choice(tccso.CCSO_OFFSETS, 16)
        planes.append(None if p == seed % 3 else dict(
            quant_idx=int(rng.randint(4)), support=int(rng.randint(6)),
            edge_clf=int(rng.randint(2)), max_band_log2=0, bo_only=0,
            lut=lut, flags=rng.rand(1, 2) < 0.6))
    info = {"planes": planes}
    got = tccso.ccso_apply_frame(tuple(map(T, rec)), T(src[0]), info, BD)
    want = jccso.ccso_apply_frame(rec, src[0], info, BD)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("seed", [4, 5])
def test_ccso_search_frame_10bit(seed):
    src, rec = _src_rec(seed, 64, 128)
    pre = np.clip(rec[0] + np.random.RandomState(seed).randint(
        -8, 9, rec[0].shape), 0, PEAK)
    lam = tie._lambda(100)             # the searches' 8-bit-step lambda
    got = tccs.ccso_search_frame(src, rec, pre, lam, BD)
    want = jccs.ccso_search_frame(src, rec, pre, lam, BD)
    assert (got is None) == (want is None)
    assert got is not None, "the case must turn CCSO on"
    for g, w in zip(got["planes"], want["planes"]):
        assert (g is None) == (w is None)
        if g is not None:
            for k in g:
                _eq(g[k], w[k], k)


# ---- loop restoration -----------------------------------------------------

@pytest.mark.parametrize("eps", range(0, 16, 3))
def test_apply_sgr_10bit(eps):
    rng = np.random.RandomState(eps)
    ext = rng.randint(0, PEAK + 1, (2, 22, 38)).astype(np.int32)
    xq = rng.randint(-96, 32), rng.randint(-32, 96)
    got = trest.apply_sgr(T(ext), eps, *xq, bit_depth=BD)
    want = jrest.apply_sgr(jnp.asarray(ext), eps, *xq, bit_depth=BD)
    _eq(got, want)


def test_wiener_filter_10bit():
    rng = np.random.RandomState(5)
    ext = rng.randint(0, PEAK + 1, (3, 20, 30)).astype(np.int32)
    taps = [(rng.randint(-5, 11), rng.randint(-23, 9), rng.randint(-17, 47))
            for _ in range(6)]
    kh = np.stack([tlrf._wiener_kernel(t) for t in taps[:3]])
    kv = np.stack([tlrf._wiener_kernel(t) for t in taps[3:]])
    got = trest.wiener_filter(T(ext), T(kh), T(kv), BD)
    for i in range(3):
        want = jrest.wiener_filter(jnp.asarray(ext[i]), kh[i], kv[i], BD)
        _eq(got[i], want)


def test_lr_search_and_apply_10bit():
    """The frame search's choices (types, SGR eps / xqd, Wiener taps) and
    the filtered planes."""
    src, rec = _src_rec(7, 64, 128)
    db = _src_rec(8, 64, 128)[1]
    lam = tie._lambda(100)
    got_t, got_u = tlrs.lr_search_frame(tuple(map(T, src)),
                                        tuple(map(T, rec)), lam, BD)
    want_t, want_u = jlrs.lr_search_frame(src, rec, lam, BD)
    assert tuple(got_t) == tuple(want_t)
    assert any(got_t), "the case must turn LR on"
    for g, w in zip(got_u, want_u):
        assert (g is None) == (w is None)
        if g is not None:
            for k in g:
                _eq(g[k], w[k], k)
    got = tlrf.lr_apply_frame(tuple(map(T, rec)), tuple(map(T, db)), got_u,
                              BD)
    want = jlrf.lr_apply_frame(rec, db, want_u, BD)
    for g, w in zip(got, want):
        _eq(g, w)


# ---- motion compensation and temporal filtering ---------------------------

@pytest.mark.parametrize("bs,ss,filt", [
    (32, 0, 0), (32, 0, 1), (32, 0, 2), (16, 0, 0), (64, 0, 0), (16, 1, 0),
    (16, 1, 1), (8, 1, 2)])
def test_predict_inter_blocks_10bit(bs, ss, filt):
    h, w = 64 >> ss, 128 >> ss
    plane = plane_src10(bs + filt, 1, h, w).astype(np.int32)
    rng = np.random.RandomState(7 * bs + ss + filt)
    lb = bs << ss
    n = (64 // lb) * (128 // lb) if lb <= 64 else 1
    bw = 128 // lb
    y0 = (np.arange(n) // bw * lb)[None].astype(np.int32) >> ss
    x0 = (np.arange(n) % bw * lb)[None].astype(np.int32) >> ss
    mv = rng.randint(-120, 121, (1, n, 2)).astype(np.int32)
    mv[0, ::3] *= 9
    refp = jmc.pad_plane(jnp.asarray(plane))
    want = jmc.predict_inter_blocks(refp, jnp.asarray(y0), jnp.asarray(x0),
                                    jnp.asarray(mv), 64, 128, bs, ss, BD,
                                    filt)
    got = tmc.predict_inter_blocks(tmc.pad_plane(T(plane)), T(y0), T(x0),
                                   T(mv), 64, 128, bs, ss, BD, filt)
    _eq(got, want)
    assert int(got.max()) > 255


def test_temporal_filter_frame_10bit(capsys):
    fr = moving_frames10(128, 64, 5)
    got = ttf.temporal_filter_frame(fr[2], [fr[1], fr[3], fr[4]], 100, BD)
    want = jtf.temporal_filter_frame(fr[2], [fr[1], fr[3], fr[4]], 100, BD)
    d = [np.abs(g.astype(np.int32) - w_.astype(np.int32))
         for g, w_ in zip(got, want)]
    with capsys.disabled():
        print(f"\nTF 10-bit 128x64, 3 neighbours: pixels that differ from "
              f"JAX's {[int((x > 0).sum()) for x in d]}")
    assert all(g.dtype == np.uint16 and g.shape == w_.shape
               for g, w_ in zip(got, want))
    assert max(int(x.max()) for x in d) <= 1
    assert any((g != c).any() for g, c in zip(got, fr[2]))


# ---- the plain wavefront --------------------------------------------------

def _src10(seed, B, h, w):
    return plane_src10(seed, B, h, w)


WF_CASES = {
    "luma": (0, 2, 64, 128, 32, jT.TX_32X32, 100, {}),
    "valid_h": (1, 1, 64, 128, 32, jT.TX_32X32, 120, {"valid_h": 56}),
    "chroma": (2, 4, 32, 64, 16, jT.TX_16X16, 100,
               {"paired": True, "kf": "uv", "uv_tx": True}),
}


@pytest.mark.parametrize("label", list(WF_CASES))
def test_wavefront_10bit_matches_jax(label, monkeypatch):
    monkeypatch.delenv("SVT_TPU_LAMBDA_SCALE", raising=False)
    seed, B, h, w, bs, txs, q, kw = WF_CASES[label]
    src = _src10(seed, B, h, w)
    ref = jwf.encode_plane_wavefront(src.astype(np.int32), bs, txs, q,
                                     CAND_MODES, BD, **kw)
    got = twf.encode_plane_wavefront(T(src.astype(np.int16)), bs, txs, q,
                                     CAND_MODES, BD, **kw)
    _agree(ref, [a.numpy() for a in got], label)
    assert int(got[2].max()) > 255


@pytest.mark.parametrize("bs,n_extra,modes,vh", [
    (32, 2, CAND_MODES, None), (32, 2, CAND_MODES, 56), (16, 1, (0,), None)])
def test_mixed_wavefront_10bit_matches_jax(bs, n_extra, modes, vh):
    """The flat P frame's form: n_extra inter lanes (the source plus noise,
    or noise), random rates and masks."""
    h, w = (64, 128) if bs == 32 else (32, 64)
    rng = np.random.RandomState(bs + n_extra)
    src = _src10(bs, 1, h, w)
    bh, bw = h // bs, w // bs
    blk = src.reshape(1, bh, bs, bw, bs).transpose(0, 1, 3, 2, 4)
    preds = np.stack([np.clip(blk.astype(np.int32) + rng.randint(
        -12 - 48 * e, 13 + 48 * e, blk.shape), 0, PEAK)
        for e in range(n_extra)], 1)
    bad = rng.rand(1, 1, bh, bw, 1, 1) < 0.4
    preds = np.where(bad, rng.randint(0, PEAK + 1, preds.shape),
                     preds).astype(np.int32)
    rate = rng.uniform(4, 30, (1, n_extra, bh, bw)).astype(np.float32)
    ok = rng.rand(1, n_extra, bh, bw) < 0.8
    iok = rng.rand(1, bh, bw) < 0.8
    tx = jT.TX_32X32 if bs == 32 else jT.TX_16X16
    want = jwf.encode_plane_wavefront_mixed(
        jnp.asarray(src.astype(np.int32)), bs, tx, 100, jnp.asarray(preds),
        jnp.asarray(rate), jnp.asarray(ok), jnp.asarray(iok), n_extra,
        modes, BD, (0,), valid_h=vh)
    got = twf.encode_plane_wavefront_mixed(
        T(src.astype(np.int16)), bs, tx, 100, T(preds), T(rate), T(ok),
        T(iok), n_extra, modes, BD, valid_h=vh)
    _agree([np.asarray(a) for a in want], [a.numpy() for a in got],
           f"bs {bs}")
    n_intra = len(twf.expand_candidates(modes))
    assert (got[0].numpy() >= n_intra).any()


def test_rd_params_10bit_match_jax():
    """The steps are 10-bit's; the lambda stays the 8-bit ac step's."""
    cands = twf.expand_candidates(CAND_MODES)
    for q in (60, 100, 200):
        ref = twf.rd_from_numpy(*[np.asarray(a) for a in
                                  jwf.rd_params(q, BD, cands)])
        got = twf.rd_params(q, BD, cands)
        for r, g in zip(ref, got):
            assert torch.equal(r, g)
        assert int(got[1]) == jtbl.qindex_to_dq(q, BD)[1]
        assert float(got[2]) == float(twf.rd_params(q, 8, cands)[2])


# ---- the CUDA kernel's 10-bit constants -----------------------------------

@pytest.mark.parametrize("tx_size,tx_type", [
    (jT.TX_32X32, jT.DCT_DCT), (jT.TX_16X16, jT.DCT_DCT),
    (jT.TX_16X16, jT.ADST_DCT), (jT.TX_16X16, jT.DCT_ADST),
    (jT.TX_16X16, jT.ADST_ADST)])
def test_kernel_constants_10bit(tx_size, tx_type, nets_lib):
    """The kernel's 2D flow at bd=10 (tx_params: the dequantizer clamp,
    the row network's 18-bit and the column network's 16-bit clamps, the
    row output and residual clamps) over the generated networks equals
    the port's fwd_txfm2d / inv_txfm2d / add_residual_clip at bd=10."""
    bs = jT.TX_W[tx_size]
    rk, ck = (wk._KIND_NAME[k] for k in wk._kinds_of(tx_type))
    p = wk.tx_params(bs, BD)
    assert (p["row_hi"], p["col_hi"]) == ((1 << 17) - 1, (1 << 15) - 1)
    assert (p["base"], p["pix_max"], p["dq_hi"]) == (512, PEAK, (1 << 17) - 1)
    rng = np.random.RandomState(tx_type)
    resid = rng.randint(-PEAK, PEAK + 1, (4, bs, bs)).astype(np.int32)
    resid[0] = PEAK * np.sign(rng.randn(bs, bs))
    v = _rshift(resid.astype(np.int64), p["fwd_s0"])
    col, row = (("net_fwd_dct32",) * 2 if bs == 32 else
                (f"net_fwd_col_{ck}{bs}", f"net_fwd_row_{rk}{bs}"))
    v = _net(nets_lib, col, v, True)
    v = _rshift(v, p["fwd_s1"])
    v = _net(nets_lib, row, v, False)
    v = _rshift(v, p["fwd_s2"])
    _eq(v, transforms.fwd_txfm2d(T(resid), tx_size, tx_type, BD))
    coef = np.clip(v * rng.randint(1, 5, v.shape), p["dq_lo"], p["dq_hi"])
    u = _net(nets_lib, f"net_inv_{rk}{bs}", coef, False, p["row_lo"],
             p["row_hi"])
    u = np.clip(_rshift(u, p["inv_s0"]), p["mid_lo"], p["mid_hi"])
    u = _net(nets_lib, f"net_inv_{ck}{bs}", u, True, p["col_lo"],
             p["col_hi"])
    u = np.clip(_rshift(u, p["inv_s1"]), p["res_lo"], p["res_hi"])
    want = transforms.inv_txfm2d(T(coef.astype(np.int32)), tx_size, tx_type,
                                 BD)
    _eq(u, want)
    pred = rng.randint(0, PEAK + 1, u.shape)
    _eq(np.clip(pred + u, 0, p["pix_max"]),
        transforms.add_residual_clip(T(pred.astype(np.int32)), want, BD))


@pytest.mark.parametrize("bs", [16, 32])
def test_kernel_reciprocals_hold_at_10bit(bs):
    """The quantizer's numerator (|coeff| << qshift) + rounding stays below
    2^31 for every 10-bit residual block (the largest forward coefficient
    of the DCT, bounded by the transform's row sums of |weights|), so the
    reciprocal division is exact; checked at each qindex's steps."""
    tx = wk._TX_OF_BS[bs]
    n2 = bs * bs
    # the forward transform's weights, measured on scaled impulses
    eye = np.eye(n2, dtype=np.int32).reshape(n2, bs, bs) * 1024
    m = transforms.fwd_txfm2d(T(eye), tx, jT.DCT_DCT, BD).numpy()
    m = m.reshape(n2, n2).astype(np.float64) / 1024.0
    bound = int(np.ceil(PEAK * np.abs(m).sum(0).max())) + n2
    qshift = wk.tx_params(bs, BD)["qshift"]
    rng = np.random.RandomState(bs)
    for q in range(256):
        for d in jtbl.qindex_to_dq(q, BD):
            d = int(d)
            n_max = (bound << qshift) + ((d * 48) >> 7)
            assert n_max < 2 ** 31
            mul, sh = wk.reciprocal(d)
            n = np.concatenate([rng.randint(0, n_max + 1, 200),
                                [0, d - 1, d, n_max]]).astype(object)
            assert all((int(x) * mul) >> sh == int(x) // d for x in n)
