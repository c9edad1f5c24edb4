"""The port's copies of the JAX package's host modules against the
originals on the same inputs: spec tables, transform networks, default
CDFs, frame geometry, header and container writers, the native tile coder,
the film grain estimator, presets, the subexp and loop-restoration unit
writers, the CDEF set selection, the CCSO search, the mv spec and the
subpel filter table, and chip_smoke.py's synthetic clip.  One test
function per module, one case per input.
"""

import io
from pathlib import Path

import numpy as np
import pytest

import bench
import chip_smoke
from svtav1_tpu.ec import lr_syntax as jlrs
from svtav1_tpu.ec import native as jnative
from svtav1_tpu.ec import subexp as jsubexp
from svtav1_tpu.ec.range_coder import RangeEncoder as JRangeEncoder
from svtav1_tpu.encoder import ccso_search as jccs
from svtav1_tpu.encoder import cdef_search as jcds
from svtav1_tpu.encoder import geometry as jgeo
from svtav1_tpu.encoder import headers as jhdr
from svtav1_tpu.encoder import noise_model as jnoise
from svtav1_tpu.encoder import presets as jpre
from svtav1_tpu.encoder.intra_encoder import EncoderConfig
from svtav1_tpu.spec import cdf as jcdf
from svtav1_tpu.spec import mv as jmv
from svtav1_tpu.spec import tables as jtbl
from svtav1_tpu.spec import txfm as jT
from svtav1_tpu.utils import bitio as jbitio
from svtav1_tpu.utils import ivf as jivf
from svtav1_tpu.utils import obu as jobu
from svtav1_tpu.utils import y4m as jy4m
from svtav1_tpu_torch.ec import lr_syntax as tlrs
from svtav1_tpu_torch.ec import native as tnative
from svtav1_tpu_torch.ec import subexp as tsubexp
from svtav1_tpu_torch.ec.range_coder import RangeEncoder as TRangeEncoder
from svtav1_tpu_torch.encoder import ccso_search as tccs
from svtav1_tpu_torch.encoder import cdef_search as tcds
from svtav1_tpu_torch.encoder import geometry as tgeo
from svtav1_tpu_torch.encoder import headers as thdr
from svtav1_tpu_torch.encoder import noise_model as tnoise
from svtav1_tpu_torch.encoder import presets as tpre
from svtav1_tpu_torch.spec import cdf as tcdf
from svtav1_tpu_torch.spec import mv as tmv
from svtav1_tpu_torch.spec import tables as ttbl
from svtav1_tpu_torch.spec import txfm as tT
from svtav1_tpu_torch.utils import bitio as tbitio
from svtav1_tpu_torch.utils import ivf as tivf
from svtav1_tpu_torch.utils import obu as tobu
from svtav1_tpu_torch.utils import y4m as ty4m

ROOT = Path(__file__).resolve().parent.parent
TXS = (jT.TX_16X16, jT.TX_32X32)


@pytest.mark.parametrize("case", [
    "scan16", "scan32", "scale_shift", "sqr_up", "dq8"])
def test_tables(case):
    if case.startswith("scan"):
        txs = jT.TX_16X16 if case == "scan16" else jT.TX_32X32
        np.testing.assert_array_equal(ttbl.scan(txs, jT.DCT_DCT),
                                      jtbl.scan(txs, jT.DCT_DCT))
    elif case == "scale_shift":
        assert [ttbl.tx_scale_shift(t) for t in TXS] == \
            [jtbl.tx_scale_shift(t) for t in TXS]
    elif case == "sqr_up":
        assert [ttbl.txsize_sqr_up(t) for t in TXS] == \
            [jtbl.txsize_sqr_up(t) for t in TXS]
    else:
        for q in (-3, 0, 1, 50, 100, 120, 200, 255, 300):
            assert ttbl.qindex_to_dq(q, 8) == jtbl.qindex_to_dq(q, 8), q


_NETS = [(k, n, d, c) for k, n in (("dct", 16), ("dct", 32), ("adst", 16))
         for d in ("fwd", "inv") for c in (10, 11, 12, 13)]


@pytest.mark.parametrize("case", [f"{k}{n}_{d}_c{c}" for k, n, d, c in _NETS]
                         + ["constants", "uv_tx_type"])
def test_txfm(case):
    if case == "constants":
        for name in ("TX_16X16", "TX_32X32", "DCT_DCT", "ADST_ADST", "DCT_1D",
                     "ADST_1D", "INV_COS_BIT", "FWD_COS_BIT_COL",
                     "FWD_COS_BIT_ROW", "VTX_TAB", "HTX_TAB", "MODE_BTF",
                     "MODE_ADD_CLAMP", "MODE_LIN"):
            assert getattr(tT, name) == getattr(jT, name), name
        for n in (16, 32):
            assert tT.FWD_SHIFT[(n, n)] == jT.FWD_SHIFT[(n, n)]
            assert tT.INV_SHIFT[(n, n)] == jT.INV_SHIFT[(n, n)]
        for bd in (8, 10, 12):
            for col in (False, True):
                assert tT.opt_range(bd, col) == jT.opt_range(bd, col)
        return
    if case == "uv_tx_type":
        for m in range(13):
            for txs in TXS:
                assert tT.uv_intra_tx_type(m, txs) == \
                    jT.uv_intra_tx_type(m, txs)
        return
    kind, n, direction, cos = next(
        c for c in _NETS if f"{c[0]}{c[1]}_{c[2]}_c{c[3]}" == case)
    got = tT.compiled_stages(kind, n, direction, cos)
    want = jT.compiled_stages(kind, n, direction, cos)
    assert len(got) == len(want)
    for sg, sw in zip(got, want):
        for a, b in zip(sg, sw):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("qindex", [0, 20, 21, 60, 100, 120, 121, 255])
def test_cdf(qindex):
    got, want = tcdf.CdfContext(qindex), jcdf.CdfContext(qindex)
    assert got._t.keys() <= want._t.keys()
    for k, v in got._t.items():
        assert v.dtype == want._t[k].dtype, k
        np.testing.assert_array_equal(v, want._t[k], err_msg=k)


@pytest.mark.parametrize("height", [64, 56, 1080, 72, 104, 48, 32, 60, 120])
def test_geometry(height):
    """The port's geometry is the JAX package's, but for the flat path at
    m = 12 (height % 64 == 48), which the port codes with its edge strip
    and the JAX package rejects."""
    assert tgeo.pad64(height) == jgeo.pad64(height)
    assert tgeo.height_m(height) == jgeo.height_m(height)
    for part in (False, True):
        for extras in (False, True):
            errs = []
            for mod in (tgeo, jgeo):
                try:
                    mod.check_dims(128, height, part, inloop_extras=extras)
                    errs.append(None)
                except ValueError as e:
                    errs.append(str(e))
            if not part and height % 64 == 48:
                # the edge strip: accepted by the port (the in-loop
                # filters' SB alignment apart)
                assert errs[1] is not None and "16x8" in errs[1]
                assert (errs[0] is None) == (not extras), (height, extras)
                continue
            assert errs[0] == errs[1], (height, part, extras)
    if height % 64 in (8, 40):
        with pytest.raises(ValueError, match="16x8"):
            tgeo.check_dims(128, height, False)
    if height % 64 == 48:
        tgeo.check_dims(128, height, False)
    rng = np.random.RandomState(height)
    plane = rng.randint(0, 256, (2, height, 64)).astype(np.uint8)
    ph = tgeo.pad64(height)
    np.testing.assert_array_equal(tgeo.pad_plane_bottom(plane, ph),
                                  jgeo.pad_plane_bottom(plane, ph))


def _grain_params():
    return dict(
        grain_seed=1234, num_y_points=2, scaling_points_y=[(0, 20),
                                                           (255, 40)],
        chroma_scaling_from_luma=0, num_cb_points=1,
        scaling_points_cb=[(128, 30)], num_cr_points=1,
        scaling_points_cr=[(64, 25)], scaling_shift=9, ar_coeff_lag=2,
        ar_coeffs_y=list(range(-6, 6)), ar_coeffs_cb=list(range(-6, 7)),
        ar_coeffs_cr=list(range(6, -7, -1)), ar_coeff_shift=7,
        grain_scale_shift=0, cb_mult=128, cb_luma_mult=192, cb_offset=256,
        cr_mult=120, cr_luma_mult=180, cr_offset=250, overlap_flag=1,
        clip_to_restricted_range=0)


_HDR_CASES = {
    "plain": ({}, {}, True, b""),
    "not_first": ({}, {}, False, b""),
    "lf_q200": ({}, dict(base_q_idx=200, filter_level=(20, 18),
                         filter_level_u=9, filter_level_v=7,
                         disable_cdf_update=False), True, b""),
    "metadata": ({}, {}, True, jobu.wrap_obu(jobu.OBU_METADATA, b"\x01ab")),
    "film_grain": (dict(film_grain_params_present=True),
                   dict(film_grain=_grain_params()), True, b""),
    "grain_off": (dict(film_grain_params_present=True), {}, False, b""),
    "1080p": (dict(width=1920, height=1080), {}, True, b""),
    "filters": (dict(enable_cdef=True, enable_restoration=True,
                     ccso_fork_mode=True),
                dict(cdef_damping=5, cdef_bits=2,
                     cdef_y_strengths=((0, 0), (3, 1), (12, 4), (6, 2)),
                     cdef_uv_strengths=((1, 0), (0, 4), (8, 2), (2, 1)),
                     lr_frame_types=(3, 2, 1), ccso={"planes": [
                         dict(quant_idx=2, support=4, edge_clf=0,
                              max_band_log2=0, bo_only=0,
                              lut=np.array([0, 3, -1, 0, 7, -10, 1, 0] * 16,
                                           np.int32)), None, None]}),
                True, b""),
    "filters_off": (dict(enable_cdef=True, enable_restoration=True,
                         ccso_fork_mode=True), {}, False, b""),
}


@pytest.mark.parametrize("label", list(_HDR_CASES))
def test_headers(label):
    seq_kw, fr_kw, first, metadata = _HDR_CASES[label]
    seq_kw = dict(dict(width=128, height=64), **seq_kw)
    tile = bytes(range(7, 90))
    got = thdr.assemble_key_frame(thdr.SequenceConfig(**seq_kw),
                                  thdr.FrameConfig(**fr_kw), tile, first,
                                  metadata)
    want = jhdr.assemble_key_frame(jhdr.SequenceConfig(**seq_kw),
                                   jhdr.FrameConfig(**fr_kw), tile, first,
                                   metadata)
    assert got == want
    assert thdr.CCSO_OFFSETS == (0, 1, -1, 3, -3, 7, -7, -10)


@pytest.mark.parametrize("case", range(6))
def test_subexp(case):
    rng = np.random.RandomState(case)
    for _ in range(40):
        ref, v = rng.randint(-256, 257, 2)
        wt, wj = tbitio.BitWriter(), jbitio.BitWriter()
        tsubexp.write_signed_subexp_bits(wt, -256, 257, int(ref), int(v))
        jsubexp.write_signed_subexp_bits(wj, -256, 257, int(ref), int(v))
        wt.byte_align()
        wj.byte_align()
        assert wt.data() == wj.data()


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_subexp_range_coder(k):
    rng = np.random.RandomState(k)
    et, ej = TRangeEncoder(), JRangeEncoder()
    for _ in range(60):
        low = int(rng.randint(-100, 0))
        high = low + int(rng.randint(2, 200))
        ref, v = (int(a) for a in rng.randint(low, high, 2))
        tsubexp.write_signed_refsubexpfin(et, low, high, k, ref, v)
        jsubexp.write_signed_refsubexpfin(ej, low, high, k, ref, v)
        n = int(rng.randint(1, 70))
        val = int(rng.randint(n))
        tsubexp.write_quniform(et, n, val)
        jsubexp.write_quniform(ej, n, val)
    assert et.done() == ej.done()


@pytest.mark.parametrize("seed", range(3))
def test_lr_unit_writer(seed):
    out = []
    for mod, enc, cdf in ((tlrs, TRangeEncoder(), tcdf.CdfContext(80, True)),
                          (jlrs, JRangeEncoder(), jcdf.CdfContext(80, True))):
        r = np.random.RandomState(seed)
        refs = [mod.default_ref_state() for _ in range(3)]
        for _ in range(40):
            p, ftype = int(r.randint(3)), int(r.randint(4))
            unit = {"eps": int(r.randint(16)),
                    "xqd": [int(r.randint(-96, 32)), int(r.randint(-32, 96))],
                    "taps_v": [int(r.randint(-5, 11)), int(r.randint(-23, 9)),
                               int(r.randint(-17, 47))],
                    "taps_h": [int(r.randint(-5, 11)), int(r.randint(-23, 9)),
                               int(r.randint(-17, 47))]}
            mod.write_lr_unit(enc, cdf, ftype, int(r.randint(3)), unit,
                              refs[p], p > 0)
        out.append((enc.done(), refs))
    assert out[0] == out[1]
    assert tlrs.SGR_R == jlrs.SGR_R
    for name in ("WIENER_TAP_MIN", "WIENER_TAP_MAX", "SGRPROJ_PRJ_MIN0",
                 "SGRPROJ_PRJ_MAX0", "SGRPROJ_PRJ_MIN1", "SGRPROJ_PRJ_MAX1"):
        assert getattr(tlrs, name) == getattr(jlrs, name), name


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_greedy_dual(n):
    rng = np.random.RandomState(n)
    my = rng.randint(0, 5000, (12, 32)).astype(np.float64)
    muv = rng.randint(0, 3000, (12, 32)).astype(np.float64)
    got, want = tcds._greedy_dual(my, muv, n), jcds._greedy_dual(my, muv, n)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert tcds.CAND_PAIRS == jcds.CAND_PAIRS


@pytest.mark.parametrize("seed", [0, 1])
def test_ccso_search(seed):
    """A plane with an injected per-edge-class error (as
    tests/test_ccso_e2e.py builds it): both searches turn CCSO on."""
    rng = np.random.RandomState(11 + seed)
    h, w = 128, 192
    y = rng.randint(0, 256, (h, w)).astype(np.int32)
    u = rng.randint(60, 200, (h // 2, w // 2)).astype(np.int32)
    v = rng.randint(60, 200, (h // 2, w // 2)).astype(np.int32)
    ext = np.pad(y.astype(np.int64), 5, mode="edge")
    cls = jccs._classify(ext, h, w, 0, seed, 16)
    rec_y = np.clip(y - np.array([3, 0, -3, 1, 0, -1, 7, 0, -7])[cls], 0,
                    255).astype(np.int32)
    args = ((y, u, v), (rec_y, u, v), rec_y, 40.0)
    got, want = tccs.ccso_search_frame(*args), jccs.ccso_search_frame(*args)
    assert want is not None and want["planes"][0] is not None
    for pg, pw in zip(got["planes"], want["planes"]):
        assert (pg is None) == (pw is None)
        if pw is not None:
            assert pg.keys() == pw.keys()
            for k in pw:
                np.testing.assert_array_equal(pg[k], pw[k], err_msg=k)


@pytest.mark.parametrize("case", ["128x64_q100", "128x64_q30_update",
                                  "128x56_q200"])
def test_native_coder(case):
    size, q = case.split("_")[:2]
    w, h = map(int, size.split("x"))
    q = int(q[1:])
    update = case.endswith("update")
    ph = tgeo.pad64(h)
    rng = np.random.RandomState(q)
    y_modes = rng.randint(0, 13, (ph // 32, w // 32)).astype(np.int32)
    uv_modes = rng.randint(0, 13, (ph // 32, w // 32)).astype(np.int32)
    levels = [np.where(rng.rand(ph // s, w // s, s, s) < 0.1,
                       rng.randint(-40, 41, (ph // s, w // s, s, s)),
                       0).astype(np.int32)
              for s in (32, 16, 16)]
    got = tnative.encode_tile_intra(w, ph, update, y_modes, *levels,
                                    tcdf.CdfContext(q), true_h=h,
                                    uv_modes=uv_modes)
    want = jnative.encode_tile_intra(w, ph, update, y_modes, *levels,
                                     jcdf.CdfContext(q), true_h=h,
                                     uv_modes=uv_modes)
    assert got == want and len(got) > 10


@pytest.mark.parametrize("seed", [0, 1])
def test_noise_model(seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:128, 0:128]
    y = np.clip(100 + 30 * np.sin(xx / 40.0) + rng.normal(0, 4 + seed,
                                                         (128, 128)), 0, 255)
    u = np.clip(120 + rng.normal(0, 3, (64, 64)), 0, 255)
    v = np.clip(130 + rng.normal(0, 3, (64, 64)), 0, 255)
    frame = [a.astype(np.uint8) for a in (y, u, v)]
    got = tnoise.estimate_grain_params(*frame, strength=1.5)
    want = jnoise.estimate_grain_params(*frame, strength=1.5)
    assert got is not None
    assert got == want


@pytest.mark.parametrize("case", ["obu", "ivf", "y4m", "leb128"])
def test_utils(case):
    if case == "obu":
        data = (jobu.wrap_obu(jobu.OBU_TEMPORAL_DELIMITER, b"") +
                jobu.wrap_obu(jobu.OBU_FRAME, bytes(300)) +
                jobu.wrap_obu(jobu.OBU_METADATA, b"xyz", temporal_id=1))
        assert list(tobu.parse_obus(data)) == list(jobu.parse_obus(data))
        for t in (tobu.OBU_SEQUENCE_HEADER, tobu.OBU_FRAME):
            assert tobu.wrap_obu(t, b"ab" * 70) == jobu.wrap_obu(t, b"ab" * 70)
    elif case == "ivf":
        outs = []
        for mod in (tivf, jivf):
            f = io.BytesIO()
            wtr = mod.IvfWriter(f, 1920, 1080, 1, 30)
            for k in range(3):
                wtr.write_frame(bytes([k]) * (10 + k), k)
            wtr.finalize()
            outs.append(f.getvalue())
        assert outs[0] == outs[1]
    elif case == "y4m":
        f = io.BytesIO()
        wtr = jy4m.Y4mWriter(f, jy4m.Y4mInfo(64, 32, 25, 1))
        rng = np.random.RandomState(0)
        for _ in range(2):
            wtr.write_frame(rng.randint(0, 256, (32, 64)).astype(np.uint8),
                            rng.randint(0, 256, (16, 32)).astype(np.uint8),
                            rng.randint(0, 256, (16, 32)).astype(np.uint8))
        rt = ty4m.Y4mReader(io.BytesIO(f.getvalue()))
        rj = jy4m.Y4mReader(io.BytesIO(f.getvalue()))
        assert vars(rt.info) == vars(rj.info)
        for ft, fj in zip(rt.frames(), rj.frames()):
            for a, b in zip(ft, fj):
                np.testing.assert_array_equal(a, b)
    else:
        for v in (0, 1, 127, 128, 300, 1 << 20, (1 << 35) + 5):
            enc = tbitio.leb128_encode(v)
            assert enc == jbitio.leb128_encode(v)
            assert tbitio.leb128_decode(enc) == jbitio.leb128_decode(enc)


@pytest.mark.parametrize("preset", range(14))
def test_presets(preset):
    cfg = EncoderConfig(1920, 1080)
    assert tpre.apply_preset(cfg, preset) == jpre.apply_preset(cfg, preset)


@pytest.mark.parametrize("w,h,n,seed", [(64, 32, 3, 0), (128, 64, 2, 5)])
def test_synth_frames(w, h, n, seed):
    got = chip_smoke.synth_frames(w, h, n, seed)
    want = bench.synth_frames(w, h, n, seed)
    assert len(got) == len(want) == n
    for fg, fw in zip(got, want):
        for a, b in zip(fg, fw):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["mv", "interp_filters"])
def test_inter_spec(case):
    if case == "interp_filters":
        want = np.load(ROOT / "svtav1_tpu/spec/data/interp_filters.npz")
        got = np.load(ROOT / "svtav1_tpu_torch/spec/data/interp_filters.npz")
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
        return
    for name in ("NEARESTMV", "NEARMV", "GLOBALMV", "NEWMV", "MV_JOINTS",
                 "MV_CLASSES", "CLASS0_SIZE", "MV_FP_SIZE", "MV_BORDER",
                 "REF_CAT_LEVEL", "MAX_REF_MV_STACK_SIZE",
                 "MAX_MV_REF_CANDIDATES", "MVREF_ROW_COLS", "GLOBALMV_OFFSET",
                 "REFMV_OFFSET", "NEWMV_CTX_MASK", "GLOBALMV_CTX_MASK",
                 "REFMV_CTX_MASK", "INTRA_FRAME", "LAST_FRAME"):
        assert getattr(tmv, name) == getattr(jmv, name), name
    for mode in range(17):
        assert tmv.has_newmv(mode) == jmv.has_newmv(mode)
        assert tmv.has_nearmv(mode) == jmv.has_nearmv(mode)
    for z in list(range(0, 300)) + [4095, 8191, 8192, 20000]:
        assert tmv.get_mv_class(z) == jmv.get_mv_class(z)
    for r in range(-20, 21):
        for c in (-9, -1, 0, 1, 7):
            for hp in (False, True):
                for fi in (False, True):
                    assert tmv.lower_mv_precision(r, c, hp, fi) == \
                        jmv.lower_mv_precision(r, c, hp, fi)
            assert tmv.mv_joint(r, c) == jmv.mv_joint(r, c)
            assert tmv.clamp_mv_ref(r * 100, c * 300, 4, 4, 3, 5, 16, 32) \
                == jmv.clamp_mv_ref(r * 100, c * 300, 4, 4, 3, 5, 16, 32)
