"""The modules of the port's partition path, one test function per module,
against the JAX package and the reference goldens: spec tables, transforms
at 8..64 with the searched tx types, quantize_dq_opt / tx_gain,
predictors at n = 8 and 64, partition deblock and DLF SSE, geometry, the
wavefront's rate tables, CDF adaptation, the range encoder, the
coefficient writer and the tile coder on random decision maps.  Every
comparison is exact.
"""

from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.ec import coeffs as jcoeffs
from svtav1_tpu.ec import range_coder as jrc
from svtav1_tpu.encoder import geometry as jgeo
from svtav1_tpu.encoder import tile_codec as jtc
from svtav1_tpu.encoder import wavefront2 as jw2
from svtav1_tpu.ops import deblock as jdb
from svtav1_tpu.ops import intra as jintra
from svtav1_tpu.ops import intra_dir as jdir
from svtav1_tpu.ops import quant as jq
from svtav1_tpu.ops import transforms as jtx
from svtav1_tpu.spec import cdf as jcdf
from svtav1_tpu.spec import tables as jtbl
from svtav1_tpu.spec import txfm as jT
from svtav1_tpu_torch.ec import coeffs as tcoeffs
from svtav1_tpu_torch.ec import range_coder as trc
from svtav1_tpu_torch.encoder import geometry as tgeo
from svtav1_tpu_torch.encoder import intra_encoder as tie
from svtav1_tpu_torch.encoder import tile_codec as ttc
from svtav1_tpu_torch.encoder import wavefront2 as tw2
from svtav1_tpu_torch.encoder.wavefront import _lambda, expand_candidates
from svtav1_tpu_torch.ops import deblock, intra, intra_dir, quant, transforms
from svtav1_tpu_torch.spec import cdf as tcdf
from svtav1_tpu_torch.spec import tables as ttbl
from svtav1_tpu_torch.spec import txfm as tT

DATA = Path(__file__).parent / "data"


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


# ---- spec ----------------------------------------------------------------

_NETS = [(k, n, d, c) for k, n in (("dct", 8), ("dct", 64), ("adst", 8))
         for d in ("fwd", "inv") for c in (10, 11, 12, 13)]


@pytest.mark.parametrize("case", [f"{k}{n}_{d}_c{c}" for k, n, d, c in _NETS]
                         + ["sizes", "scans", "shifts", "uv_tx_type"])
def test_spec(case):
    sizes = (jT.TX_8X8, jT.TX_16X16, jT.TX_32X32, jT.TX_64X64)
    if case == "sizes":
        for txs in sizes:
            assert ttbl.txsize_sqr(txs) == jtbl.txsize_sqr(txs)
            assert ttbl.txs_ctx(txs) == jtbl.txs_ctx(txs)
            assert ttbl.adjusted_tx_wh(txs) == jtbl.adjusted_tx_wh(txs)
            assert ttbl.tx_scale_shift(txs) == jtbl.tx_scale_shift(txs)
        for name in ("TX_8X8", "TX_64X64", "IDTX", "IDTX_1D", "NEW_SQRT2",
                     "NEW_SQRT2_BITS"):
            assert getattr(tT, name) == getattr(jT, name), name
    elif case == "scans":
        for txs, types in ((jT.TX_8X8, (0,)), (jT.TX_16X16, (0, 1, 2, 3, 9)),
                           (jT.TX_32X32, (0,)), (jT.TX_64X64, (0,))):
            for tt in types:
                _eq(ttbl.scan(txs, tt), jtbl.scan(txs, tt), f"{txs} {tt}")
    elif case == "shifts":
        for n in (8, 16, 32, 64):
            assert tT.FWD_SHIFT[(n, n)] == jT.FWD_SHIFT[(n, n)]
            assert tT.INV_SHIFT[(n, n)] == jT.INV_SHIFT[(n, n)]
    elif case == "uv_tx_type":
        for m in range(13):
            for txs in sizes:
                assert tT.uv_intra_tx_type(m, txs) == \
                    jT.uv_intra_tx_type(m, txs)
    else:
        kind, n, direction, cos = next(
            c for c in _NETS if f"{c[0]}{c[1]}_{c[2]}_c{c[3]}" == case)
        got = tT.compiled_stages(kind, n, direction, cos)
        want = jT.compiled_stages(kind, n, direction, cos)
        assert len(got) == len(want)
        for sg, sw in zip(got, want):
            for a, b in zip(sg, sw):
                assert a.dtype == b.dtype
                _eq(a, b)


# ---- transforms ----------------------------------------------------------

# the partition path's (tx_size, tx_type): chroma 8x8 with the implied uv
# types, the five searched 16x16 luma types, 32x32 and 64x64 DCT
TX_CASES = ([(jT.TX_8X8, t) for t in (0, 1, 2, 3)] +
            [(jT.TX_16X16, t) for t in (0, 3, 1, 2, 9)] +
            [(jT.TX_32X32, 0), (jT.TX_64X64, 0)])


@pytest.fixture(scope="module")
def golden_txfm():
    return np.load(DATA / "golden_txfm.npz")


@pytest.mark.parametrize("direction", ["fwd", "inv"])
@pytest.mark.parametrize("tx_size,tx_type", TX_CASES)
def test_transforms(golden_txfm, tx_size, tx_type, direction):
    n = jT.TX_W[tx_size]
    key = f"{direction}_8_{tx_size}_{tx_type}"
    rng = np.random.RandomState(tx_size * 16 + tx_type)
    if direction == "fwd":
        res = golden_txfm[key + "_res"].astype(np.int32)
        _eq(transforms.fwd_txfm2d(_t(res), tx_size, tx_type),
            golden_txfm[key + "_coef"], key)
        rnd = rng.randint(-255, 256, (4, n, n)).astype(np.int32)
        _eq(transforms.fwd_txfm2d(_t(rnd), tx_size, tx_type),
            jtx.fwd_txfm2d(rnd, tx_size, tx_type, 8), key)
        return
    coeff = golden_txfm[key + "_coeff"]
    full = np.zeros((coeff.shape[0], n, n), np.int32)
    full[:, :coeff.shape[1], :coeff.shape[2]] = coeff
    pred = golden_txfm[key + "_pred"].astype(np.int32)
    res = transforms.inv_txfm2d(_t(full), tx_size, tx_type)
    _eq(transforms.add_residual_clip(_t(pred), res),
        golden_txfm[key + "_recon"].astype(np.int32), key)
    rnd = np.zeros((4, n, n), np.int32)
    m = min(n, 32)
    rnd[:, :m, :m] = rng.randint(-600, 601, (4, m, m))
    _eq(transforms.inv_txfm2d(_t(rnd), tx_size, tx_type),
        jtx.inv_txfm2d(rnd, tx_size, tx_type, 8), key)


# ---- quantizer -----------------------------------------------------------

@pytest.mark.parametrize("qindex", [0, 100, 255])
@pytest.mark.parametrize("tx_size", [jT.TX_8X8, jT.TX_16X16, jT.TX_32X32,
                                     jT.TX_64X64])
def test_quant(tx_size, qindex):
    g = quant.tx_gain(tx_size)
    assert g == jq.tx_gain(tx_size)                # bit for bit
    assert np.float32(g) == g
    n = jT.TX_W[tx_size]
    rng = np.random.RandomState(qindex * 8 + tx_size)
    coeffs = (rng.randint(-3000, 3001, (4, n, n)) *
              (rng.rand(4, n, n) < 0.4)).astype(np.int32)
    dc, ac = jtbl.qindex_to_dq(qindex, 8)
    lam = np.float32(_lambda(qindex))
    got = quant.quantize_dq_opt(_t(coeffs), tx_size, dc, ac, _t(lam))
    # one XLA compilation per size (eager, every op would compile alone)
    jit_opt = jax.jit(jq.quantize_dq_opt, static_argnums=(1, 5))
    want = jit_opt(jnp.asarray(coeffs), tx_size, jnp.int32(dc),
                   jnp.int32(ac), jnp.float32(lam), 8)
    _eq(got, want)
    assert (np.asarray(got) != 0).any()


# ---- predictors at 8 and 64 ---------------------------------------------

_GOLDEN_NAME = {
    intra.V_PRED: "v_predictor", intra.H_PRED: "h_predictor",
    intra.SMOOTH_PRED: "smooth_predictor",
    intra.SMOOTH_V_PRED: "smooth_v_predictor",
    intra.SMOOTH_H_PRED: "smooth_h_predictor",
    intra.PAETH_PRED: "paeth_predictor"}
_DC_VARIANTS = {(True, True): "dc_predictor", (False, True):
                "dc_left_predictor", (True, False): "dc_top_predictor",
                (False, False): "dc_128_predictor"}


@pytest.fixture(scope="module")
def golden_intra():
    return np.load(DATA / "golden_intra.npz")


@pytest.mark.parametrize("n", [8, 64])
@pytest.mark.parametrize("mode", range(13))
def test_predictors(golden_intra, mode, n):
    g = golden_intra
    if mode in intra_dir.MODE_ANGLE and mode not in _GOLDEN_NAME:
        key = f"dr_{n}_{mode}_0"
        a = g[key + "_a"].astype(np.int32)
        l = g[key + "_l"].astype(np.int32)
        ae, le, cn = a[:, 1:2 * n + 1], l[:, 1:2 * n + 1], a[:, 0]
        got = intra_dir.dr_pred(mode, 0, _t(ae), _t(le), _t(cn), n)
        _eq(got, g[key + "_o"].astype(np.int32), key)
        _eq(got, jdir.dr_pred(mode, 0, ae, le, cn, n), key)
        return
    names = (_DC_VARIANTS if mode == intra.DC_PRED
             else {(True, True): _GOLDEN_NAME[mode]})
    for (ha, hl), name in names.items():
        key = f"{name}_{n}x{n}"
        above_ext = g[key + "_above"].astype(np.int32)
        left = g[key + "_left"].astype(np.int32)
        above, tl = above_ext[:, 1:], above_ext[:, 0]
        got = intra.predict(mode, _t(above), _t(left), _t(tl), ha, hl)
        _eq(got, g[key + "_out"].astype(np.int32), key)
        _eq(got, jintra.predict(mode, above, left, tl, ha, hl), key)


# ---- partition deblock and the DLF search -------------------------------

@pytest.mark.parametrize("spacing,taps,valid_h,with_sb", [
    (32, 14, False, True), (32, 14, True, False), (16, 6, False, False),
    (16, 6, True, True)])
def test_deblock_part(spacing, taps, valid_h, with_sb):
    rng = np.random.RandomState(spacing + 2 * valid_h + with_sb)
    B, h, w = 2, 4 * spacing, 4 * spacing
    yy, xx = np.mgrid[0:h, 0:w]
    hs = spacing // 2
    plane = np.stack([np.clip(120 + 40 * np.sin((xx + 9 * b) / 13.0) +
                              8 * ((xx // hs + yy // hs) % 3) +
                              rng.randint(-3, 4, (h, w)), 0, 255)
                      for b in range(B)]).astype(np.int32)
    part = rng.randint(0, 2, (B, 4, 4)).astype(np.int32)
    psb = rng.randint(0, 2, (B, 2, 2)).astype(np.int32) if with_sb else None
    vh = h - hs // 2 if valid_h else None
    t_psb = None if psb is None else _t(psb)
    got = deblock.deblock_plane_part(_t(plane), _t(part), spacing, taps, 22,
                                     17, part_sb=t_psb, valid_h=vh)
    _eq(got, jdb.deblock_plane_part(plane, part, spacing, taps, 22, 17,
                                    part_sb=psb, valid_h=vh))
    assert not np.array_equal(got.numpy(), plane)
    # the DLF search's exact SSE, against the JAX deblock at each level
    # (the level is traced there: one compilation)
    src = np.clip(plane + rng.randint(-6, 7, plane.shape), 0, 255)
    levels = [0, 6, 22]
    sse = deblock.dlf_sse_part(_t(plane), _t(src), _t(part), levels, spacing,
                               taps, part_sb=t_psb, valid_h=vh)
    rows = h if vh is None else vh
    want = [int(((np.asarray(jdb.deblock_plane_part(
        plane, part, spacing, taps, lvl, lvl, part_sb=psb, valid_h=vh)) -
        src)[:, :rows].astype(np.int64) ** 2).sum()) for lvl in levels]
    assert sse.dtype == torch.int64
    _eq(sse, want)


# ---- geometry, rate tables, configurations -------------------------------

@pytest.mark.parametrize("height", [64, 56, 48, 32, 24, 16, 1080, 120, 112])
def test_bottom_force_masks(height):
    ph = tgeo.pad64(height)
    shape = (ph // 32, 256 // 32, ph // 64, 256 // 64, height // 4)
    for a, b in zip(tgeo.bottom_force_masks(*shape),
                    jgeo.bottom_force_masks(*shape)):
        assert a.dtype == b.dtype
        _eq(a, b)


@pytest.mark.parametrize("qindex", [0, 60, 100, 200, 255])
def test_rate_tables(qindex):
    _eq(tw2.txt_rate_table(qindex), jw2.txt_rate_table(qindex))
    for bs in (32, 16):
        assert tw2.partition_bits(qindex, bs) == jw2.partition_bits(qindex,
                                                                    bs)
        assert tw2.partition_bits_sb(qindex, 2 * bs) == \
            jw2.partition_bits_sb(qindex, 2 * bs)
    for name in ("SUB_MODES", "CHROMA_TOP_MODES", "CHROMA_SUB_MODES",
                 "CHROMA_SB_MODES", "TX_SEARCH_TYPES"):
        assert getattr(tw2, name) == getattr(jw2, name), name


@pytest.mark.parametrize("change", [
    {"tile_cols": 2}, {"enable_cdef": True}, {"angle_deltas": (-2, 0, 2)},
    {"enable_lr": True}, {"bit_depth": 10}])
def test_partition_config_raises(change):
    cfg = replace(tie.EncoderConfig(128, 64), **change)
    assert cfg.part_search
    if cfg.bit_depth == 10:
        # ported: the partition path takes 10-bit
        # (tests/test_torch_10bit_intra.py holds it to JAX)
        assert tie.IntraEncoder(cfg, device="cpu").seq.bit_depth == 10
        return
    if cfg.angle_deltas != (0,):
        # ported: the partition path takes angle deltas
        # (tests/test_torch_angle_deltas.py)
        assert tie.IntraEncoder(cfg, device="cpu").cfg.angle_deltas == \
            (-2, 0, 2)
        return
    if cfg.enable_cdef or cfg.enable_lr:
        # the filters are ported; like the JAX package, they need a height
        # that is a multiple of 64
        with pytest.raises(ValueError, match="non-SB-aligned heights"):
            tie.IntraEncoder(replace(cfg, height=56), device="cpu")
        return
    # ported: the partition path takes tile columns
    # (tests/test_torch_tiles.py holds them to JAX)
    enc = tie.IntraEncoder(cfg, device="cpu")
    assert enc.cfg.tile_cols == 2 and enc.tile_devices is None


# ---- CDF adaptation, range encoder, coefficient writer -------------------

_CDF_TABLES = ("partition_cdf", "skip_cdfs", "kf_y_cdf", "uv_mode_cdf",
               "angle_delta_cdf", "intra_ext_tx_cdf", "coeff_base_cdf",
               "coeff_br_cdf", "txb_skip_cdf", "eob_flag_cdf256")


@pytest.mark.parametrize("qindex,update", [(100, True), (30, True),
                                           (200, False)])
def test_cdf_adaptation(qindex, update):
    got = tcdf.CdfContext(qindex, update=update)
    want = jcdf.CdfContext(qindex, update=update)
    rng = np.random.RandomState(qindex)
    for _ in range(400):
        name = _CDF_TABLES[rng.randint(len(_CDF_TABLES))]
        arr = getattr(want, name)
        row = tuple(rng.randint(s) for s in arr.shape[:-1])
        nsyms = arr.shape[-1] - 1
        ns = None
        if rng.rand() < 0.3 and nsyms > 2:
            ns = rng.randint(2, nsyms + 1)
        sym = rng.randint((ns or nsyms))
        got.update(getattr(got, name)[row], sym, ns)
        want.update(arr[row], sym, ns)
    snap_g, snap_w = got.snapshot(), want.snapshot()
    assert got._t.keys() == want._t.keys()
    for k in want._t:
        _eq(got._t[k], want._t[k], k)
        _eq(snap_g._t[k], snap_w._t[k], k)
        _eq(got.clone()._t[k], want._t[k], k)


@pytest.mark.parametrize("seed", range(4))
def test_range_encoder(seed):
    rng = np.random.RandomState(seed)
    cdf = jcdf.CdfContext(100)
    got, want = trc.RangeEncoder(), jrc.RangeEncoder()
    for _ in range(3000):
        r = rng.rand()
        if r < 0.5:
            t = cdf.kf_y_cdf[rng.randint(5)][rng.randint(5)]
            s = rng.randint(13)
            got.encode_symbol(s, t)
            want.encode_symbol(s, t)
        elif r < 0.8:
            v, f = int(rng.randint(2)), int(rng.randint(1, 32768))
            got.encode_bool(v, f)
            want.encode_bool(v, f)
        else:
            v = int(rng.randint(1 << 12))
            got.encode_literal(v, 12)
            want.encode_literal(v, 12)
        assert got.tell() == want.tell()
    assert got.done() == want.done()


_COEF_CASES = ([(jT.TX_8X8, 0, 1)] +
               [(jT.TX_16X16, t, 0) for t in (0, 3, 1, 2, 9)] +
               [(jT.TX_16X16, 0, 1), (jT.TX_32X32, 0, 0),
                (jT.TX_32X32, 0, 1), (jT.TX_64X64, 0, 0)])


@pytest.mark.parametrize("tx_size,tx_type,plane_type", _COEF_CASES)
def test_write_coeffs(tx_size, tx_type, plane_type):
    w, h = jtbl.adjusted_tx_wh(tx_size)
    rng = np.random.RandomState(tx_size * 32 + tx_type * 2 + plane_type)
    got_e, want_e = trc.RangeEncoder(), jrc.RangeEncoder()
    got_c = tcdf.CdfContext(100, update=True)
    want_c = jcdf.CdfContext(100, update=True)
    for k in range(6):
        lev = (rng.randint(-3, 4, (h, w)) * (rng.rand(h, w) < 0.3))
        lev[rng.rand(h, w) < 0.02] = rng.randint(-60, 61)
        if k == 0:
            lev[:] = 0
        lev = lev.astype(np.int32)
        args = (lev, tx_size, tx_type, plane_type, 7 + k % 3, k % 3)
        kw = dict(intra_mode=int(rng.randint(13)))
        assert tcoeffs.write_coeffs_txb(got_e, got_c, *args, **kw) == \
            jcoeffs.write_coeffs_txb(want_e, want_c, *args, **kw)
    assert tcoeffs.tx_set_params(tx_size, False) == \
        jcoeffs.tx_set_params(tx_size, False)
    assert tcoeffs.EXT_TX_IND == jcoeffs.EXT_TX_IND
    assert got_e.done() == want_e.done()
    for k in want_c._t:
        _eq(got_c._t[k], want_c._t[k], k)


# ---- tile coder on random decision maps ---------------------------------

def _decision_maps(w, h, seed):
    """Random partition-path outputs at padded size (w, pad64(h)): sparse
    levels with a few large ones, SB NONE and 32x32 NONE / SPLIT mixed,
    the bottom force masks applied."""
    ph = tgeo.pad64(h)
    bh, bw, sh, sw = ph // 32, w // 32, ph // 64, w // 64
    rng = np.random.RandomState(seed)
    fp, fsb = tgeo.bottom_force_masks(bh, bw, sh, sw, h // 4)
    part = np.where(fp < 0, rng.randint(0, 2, (bh, bw)), fp).astype(np.int32)
    part_sb = np.where(fsb < 0, rng.randint(0, 2, (sh, sw)),
                       fsb).astype(np.int32)
    part_sb.flat[0] = 0                       # one SB NONE at least

    def lev(*shape):
        a = rng.randint(-2, 3, shape) * (rng.rand(*shape) < 0.05)
        a[rng.rand(*shape) < 0.003] = rng.randint(-40, 41)
        a[rng.rand(*shape[:-2]) < 0.3] = 0   # some all-zero txbs
        return a.astype(np.int32)

    return dict(
        part=part, mi_top=rng.randint(0, 13, (bh, bw)),
        lev_top_y=lev(bh, bw, 32, 32), lev_top_u=lev(bh, bw, 16, 16),
        lev_top_v=lev(bh, bw, 16, 16), mi_sub=rng.randint(0, 10, (bh, bw, 4)),
        lev_sub_y=lev(bh, bw, 4, 16, 16), lev_sub_u=lev(bh, bw, 4, 8, 8),
        lev_sub_v=lev(bh, bw, 4, 8, 8), stx_sub=rng.randint(0, 5, (bh, bw, 4)),
        part_sb=part_sb, mi_sb=rng.randint(0, 13, (sh, sw)),
        lev_sb_y=lev(sh, sw, 32, 32), lev_sb_u=lev(sh, sw, 32, 32),
        lev_sb_v=lev(sh, sw, 32, 32), uv_top=rng.randint(0, 13, (bh, bw)),
        uv_sub=rng.choice(tw2.SUB_MODES, (bh, bw, 4)),
        uv_sb=rng.choice(tw2.SUB_MODES, (sh, sw)))


@pytest.mark.parametrize("w,h,seed,update", [
    (128, 64, 0, True), (128, 64, 1, False), (128, 56, 2, True),
    (192, 56, 3, True), (128, 48, 4, True), (128, 120, 5, True)])
def test_tile_coder(w, h, seed, update):
    d = _decision_maps(w, h, seed)
    ph = tgeo.pad64(h)
    cands = expand_candidates(tie.CAND_MODES)
    cands_sub = expand_candidates(tw2.SUB_MODES)
    got, got_cdf = ttc.TileCoder(w, ph, 100, update, true_h=h).encode(
        d["part"], d["mi_top"], d["lev_top_y"], d["lev_top_u"],
        d["lev_top_v"], d["mi_sub"], d["lev_sub_y"], d["lev_sub_u"],
        d["lev_sub_v"], cands, cands_sub, d["stx_sub"], d["part_sb"],
        d["mi_sb"], d["lev_sb_y"], d["lev_sb_u"], d["lev_sb_v"],
        d["uv_top"], d["uv_sub"], d["uv_sb"])
    want, want_cdf = jtc.TileCoder(w, ph, 100, update, kf=True,
                                   true_h=h).encode(
        d["part"], d["mi_top"], d["lev_top_y"], d["lev_top_u"],
        d["lev_top_v"], d["mi_sub"], d["lev_sub_y"], d["lev_sub_u"],
        d["lev_sub_v"], None, None, cands, cands_sub, len(cands),
        len(cands_sub), stx_sub=d["stx_sub"], part_sb=d["part_sb"],
        mi_sb=d["mi_sb"], lev_sb_y=d["lev_sb_y"], lev_sb_u=d["lev_sb_u"],
        lev_sb_v=d["lev_sb_v"], uv_top=d["uv_top"], uv_sub=d["uv_sub"],
        uv_sb=d["uv_sb"])
    assert len(got) > 100
    assert got == want
    for k in want_cdf._t:
        _eq(got_cdf._t[k], want_cdf._t[k], k)
