"""The PyTorch port's normative ops against the JAX package and the
reference goldens: transforms, quantizer, intra predictors, deblocking.
Every comparison is exact (integer ops)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.ops import deblock as jdb
from svtav1_tpu.ops import intra as jintra
from svtav1_tpu.ops import intra_dir as jdir
from svtav1_tpu.ops import quant as jq
from svtav1_tpu.ops import transforms as jtx
from svtav1_tpu.spec import tables as tbl
from svtav1_tpu.spec import txfm as T
from svtav1_tpu_torch.ops import deblock, intra, intra_dir, quant, transforms

DATA = Path(__file__).parent / "data"

# (tx_size, tx_type) of the flat path: luma 32x32 DCT, chroma 16x16 with
# the four implied uv types
TX_CASES = [(T.TX_32X32, T.DCT_DCT), (T.TX_16X16, T.DCT_DCT),
            (T.TX_16X16, T.ADST_DCT), (T.TX_16X16, T.DCT_ADST),
            (T.TX_16X16, T.ADST_ADST)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


@pytest.fixture(scope="module")
def golden_txfm():
    return np.load(DATA / "golden_txfm.npz")


@pytest.mark.parametrize("tx_size,tx_type", TX_CASES)
def test_fwd_txfm2d(golden_txfm, tx_size, tx_type):
    key = f"fwd_8_{tx_size}_{tx_type}"
    res = golden_txfm[key + "_res"].astype(np.int32)
    _eq(transforms.fwd_txfm2d(_t(res), tx_size, tx_type),
        golden_txfm[key + "_coef"], key)
    n = T.TX_W[tx_size]
    rnd = np.random.RandomState(tx_size * 16 + tx_type).randint(
        -255, 256, (8, n, n)).astype(np.int32)
    _eq(transforms.fwd_txfm2d(_t(rnd), tx_size, tx_type),
        jtx.fwd_txfm2d(rnd, tx_size, tx_type, 8))


@pytest.mark.parametrize("tx_size,tx_type", TX_CASES)
def test_inv_txfm2d(golden_txfm, tx_size, tx_type):
    key = f"inv_8_{tx_size}_{tx_type}"
    n = T.TX_W[tx_size]
    coeff = golden_txfm[key + "_coeff"]
    full = np.zeros((coeff.shape[0], n, n), np.int32)
    full[:, :coeff.shape[1], :coeff.shape[2]] = coeff
    pred = golden_txfm[key + "_pred"].astype(np.int32)
    res = transforms.inv_txfm2d(_t(full), tx_size, tx_type)
    _eq(transforms.add_residual_clip(_t(pred), res),
        golden_txfm[key + "_recon"].astype(np.int32), key)
    # dequantized coefficients of seeded residuals, as the wavefront makes
    rng = np.random.RandomState(100 + tx_size * 16 + tx_type)
    resid = rng.randint(-255, 256, (8, n, n)).astype(np.int32)
    dc, ac = tbl.qindex_to_dq(60, 8)
    lev = jq.quantize_dq(jtx.fwd_txfm2d(resid, tx_size, tx_type, 8), tx_size,
                         dc, ac)
    dq = np.asarray(jq.dequantize_dq(lev, tx_size, dc, ac))
    pred = rng.randint(0, 256, (8, n, n)).astype(np.int32)
    want = jtx.add_residual_clip(pred, jtx.inv_txfm2d(dq, tx_size, tx_type,
                                                      8))
    got = transforms.add_residual_clip(
        _t(pred), transforms.inv_txfm2d(_t(dq), tx_size, tx_type))
    _eq(got, want)


@pytest.mark.parametrize("tx_size", [T.TX_16X16, T.TX_32X32])
@pytest.mark.parametrize("qindex", [0, 100, 255])
def test_quantize_dequantize(qindex, tx_size):
    n = T.TX_W[tx_size]
    rng = np.random.RandomState(qindex + tx_size)
    coeffs = (rng.randint(-4000, 4001, (6, n, n)) *
              (rng.rand(6, n, n) < 0.5)).astype(np.int32)
    dc, ac = tbl.qindex_to_dq(qindex, 8)
    lev = quant.quantize_dq(_t(coeffs), tx_size, dc, ac)
    jlev = np.asarray(jq.quantize_dq(jnp.asarray(coeffs), tx_size,
                                     jnp.int32(dc), jnp.int32(ac)))
    _eq(lev, jlev, "quantize")
    _eq(quant.dequantize_dq(lev, tx_size, dc, ac),
        jq.dequantize_dq(jnp.asarray(jlev), tx_size, jnp.int32(dc),
                         jnp.int32(ac)), "dequantize")


_GOLDEN_NAME = {
    intra.V_PRED: "v_predictor", intra.H_PRED: "h_predictor",
    intra.SMOOTH_PRED: "smooth_predictor",
    intra.SMOOTH_V_PRED: "smooth_v_predictor",
    intra.SMOOTH_H_PRED: "smooth_h_predictor",
    intra.PAETH_PRED: "paeth_predictor"}
_DC_VARIANTS = {(True, True): "dc_predictor", (False, True):
                "dc_left_predictor", (True, False): "dc_top_predictor",
                (False, False): "dc_128_predictor"}


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("mode", range(13))
def test_predictors(mode, n):
    g = np.load(DATA / "golden_intra.npz")
    if mode in intra_dir.MODE_ANGLE and mode not in _GOLDEN_NAME:
        key = f"dr_{n}_{mode}_0"
        a = g[key + "_a"].astype(np.int32)
        l = g[key + "_l"].astype(np.int32)
        ae, le, cn = a[:, 1:2 * n + 1], l[:, 1:2 * n + 1], a[:, 0]
        got = intra_dir.dr_pred(mode, 0, _t(ae), _t(le), _t(cn), n)
        _eq(got, g[key + "_o"].astype(np.int32), key)
        _eq(got, jdir.dr_pred(mode, 0, ae, le, cn, n), key)
        return
    names = ({k: v for k, v in _DC_VARIANTS.items()}
             if mode == intra.DC_PRED else {(True, True): _GOLDEN_NAME[mode]})
    for (ha, hl), name in names.items():
        key = f"{name}_{n}x{n}"
        above_ext = g[key + "_above"].astype(np.int32)
        left = g[key + "_left"].astype(np.int32)
        above, tl = above_ext[:, 1:], above_ext[:, 0]
        got = intra.predict(mode, _t(above), _t(left), _t(tl), ha, hl)
        _eq(got, g[key + "_out"].astype(np.int32), key)
        _eq(got, jintra.predict(mode, above, left, tl, ha, hl), key)


@pytest.mark.parametrize("tap", [6, 14])
def test_filter_core_golden(tap):
    d = np.load(DATA / "golden_deblock.npz")
    for case in range(40):
        strip = d[f"v{tap}_{case}_in"].astype(np.int32)
        lvl = int(d[f"v{tap}_{case}_lvl"][0])
        mblim, lim, thr = deblock.thresholds(lvl)
        full = strip.copy()
        full[:, 9:23] = deblock._filter_core(_t(strip[:, 9:23]), tap, mblim,
                                             lim, thr).numpy()
        _eq(full, d[f"v{tap}_{case}_out"].astype(np.int32), f"{tap} {case}")


@pytest.mark.parametrize("level", [(20, 17), (0, 0)])
@pytest.mark.parametrize("valid_h", [False, True])
@pytest.mark.parametrize("spacing,taps", [(32, 14), (16, 6)])
def test_deblock_plane_uniform(spacing, taps, valid_h, level):
    rng = np.random.RandomState(spacing + taps)
    h, w = 4 * spacing, 6 * spacing
    yy, xx = np.mgrid[0:h, 0:w]
    plane = np.stack([np.clip(120 + 40 * np.sin((xx + 9 * b) / 13.0) +
                              8 * ((xx // spacing + yy // spacing) % 3) +
                              rng.randint(-3, 4, (h, w)), 0, 255)
                      for b in range(2)]).astype(np.int32)
    vh = h - spacing + spacing // 4 if valid_h else None
    lv, lh = level
    got = deblock.deblock_plane_uniform(_t(plane), spacing, taps, lv, lh,
                                        valid_h=vh)
    want = jdb.deblock_plane_uniform(plane, spacing, taps, lv, lh,
                                     valid_h=vh)
    _eq(got, want)
    if lv:
        assert not np.array_equal(np.asarray(got), plane)
