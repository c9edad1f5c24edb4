"""The host-side modules of the port's low-delay inter path against the JAX
package, and its interpolation kernels against the reference golden: the
subpel kernels and the normative 2D filter (``golden_convolve.npz``),
``downsample2x``, ``find_mv_stack`` on random mi grids, the inter-mode
writers on random symbol sequences, ``choose_inter_mode`` and the tile
coder's inter branch on random decision maps with mvs, alone and with the
in-loop filters' syntax.  Every comparison
is exact; no JAX jit is compiled here (the device-side modules are held
to JAX in ``test_torch_video.py``, at its fixture's shapes).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.ec import inter_modes as jim
from svtav1_tpu.ec import mvpred as jmvp
from svtav1_tpu.ec.range_coder import RangeEncoder as JRangeEncoder
from svtav1_tpu.encoder import tile_codec as jtc
from svtav1_tpu.encoder import tile_inter as jti
from svtav1_tpu.ops import convolve as jconv
from svtav1_tpu.ops import metrics as jmetrics
from svtav1_tpu.spec import cdf as jcdf
from svtav1_tpu_torch.ec import inter_modes as tim
from svtav1_tpu_torch.ec import mvpred as tmvp
from svtav1_tpu_torch.ec.range_coder import RangeEncoder as TRangeEncoder
from svtav1_tpu_torch.encoder import geometry as tgeo
from svtav1_tpu_torch.encoder import intra_encoder as tie
from svtav1_tpu_torch.encoder import tile_codec as ttc
from svtav1_tpu_torch.encoder import wavefront2 as tw2
from svtav1_tpu_torch.encoder.wavefront import expand_candidates
from svtav1_tpu_torch.ops import convolve as tconv
from svtav1_tpu_torch.ops import mc as tmc
from svtav1_tpu_torch.ops import metrics as tmetrics
from svtav1_tpu_torch.spec import cdf as tcdf
from test_torch_part import one_thread

DATA = Path(__file__).parent / "data"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread: the scans here are small, and the
    test workers share the machine's cores (more threads crawl under
    their load)."""
    with one_thread():
        yield


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


# ---- interpolation kernels and the 2D filter -----------------------------

@pytest.mark.parametrize("filt", [0, 1, 2, 3])
def test_kernels(filt):
    got = tconv.kernels(filt)
    assert got.dtype == np.int32 and got.shape == (16, 8)
    _eq(got, jconv.kernels(filt))
    assert (tconv.FILTER_BITS, tconv.ROUND0, tconv.ROUND1) == \
        (jconv.FILTER_BITS, jconv.ROUND0, jconv.ROUND1)


@pytest.mark.parametrize("first", [0, 15, 30, 45])
def test_interp_golden(first):
    """interp_block_dyn with the phase-selected kernels against the
    reference's svt_av1_convolve_2d_sr_c outputs (15 cases a block
    size)."""
    d = np.load(DATA / "golden_convolve.npz")
    for n in range(first, first + 15):
        w, h, fx, fy, sx, sy = (int(v) for v in d[f"c{n}_cfg"])
        src = d[f"c{n}_src"].astype(np.int32)
        window = torch.from_numpy(src[8 - 3:8 + h + 4, 8 - 3:8 + w + 4])
        kx = torch.from_numpy(tconv.kernels(fx)[sx])
        ky = torch.from_numpy(tconv.kernels(fy)[sy])
        got = tmc.interp_block_dyn(window[None], kx[None], ky[None])[0]
        _eq(got, d[f"c{n}_dst"].astype(np.int32), f"case {n}")


@pytest.mark.parametrize("shape", [(1, 64, 128), (2, 34, 18)])
def test_downsample2x(shape):
    rng = np.random.RandomState(sum(shape))
    x = rng.randint(0, 256, shape).astype(np.int32)
    _eq(tmetrics.downsample2x(torch.from_numpy(x)),
        jmetrics.downsample2x(jnp.asarray(x)))


def test_pad_plane():
    x = np.random.RandomState(1).randint(0, 256, (2, 9, 13)).astype(np.int32)
    _eq(tmc.pad_plane(torch.from_numpy(x), 5), np.pad(
        x, ((0, 0), (5, 5), (5, 5)), mode="edge"))


# ---- mv stacks on random mi grids ----------------------------------------

_POOL = [(0, 0), (-16, -24), (8, -16), (10, -22), (-4, 6), (40, 2),
         (-6, -6), (2, 0)]


def _random_grids(mi_rows, mi_cols, seed):
    """The same random grid of square blocks (16/32/64 px, LAST or intra,
    mvs from a small pool so that neighbours repeat) as a port and a JAX
    MiGrid."""
    rng = np.random.RandomState(seed)
    tg = tmvp.MiGrid(mi_rows, mi_cols)
    jg = jmvp.MiGrid(mi_rows, mi_cols)
    for r0 in range(0, mi_rows, 16):
        for c0 in range(0, mi_cols, 16):
            stack = [(r0, c0, 16)]
            while stack:
                r, c, n = stack.pop()
                if r >= mi_rows or c >= mi_cols:
                    continue
                if n > 4 and rng.rand() < 0.6:
                    h = n // 2
                    stack += [(r, c, h), (r, c + h, h), (r + h, c, h),
                              (r + h, c + h, h)]
                    continue
                inter = rng.rand() < 0.8
                mode = (int(rng.choice([13, 14, 15, 16])) if inter
                        else int(rng.randint(0, 13)))
                mv = _POOL[rng.randint(len(_POOL))] if inter else (0, 0)
                for g in (tg, jg):
                    g.set_block(r, c, n, n, int(inter), mode, *mv)
    return tg, jg


@pytest.mark.parametrize("seed", range(6))
def test_find_mv_stack(seed):
    mi_rows, mi_cols = (16, 32) if seed % 2 else (30, 48)
    tg, jg = _random_grids(mi_rows, mi_cols, seed)
    gm = _POOL[seed % len(_POOL)]
    rng = np.random.RandomState(100 + seed)
    n = 0
    for _ in range(60):
        bw4 = int(rng.choice([4, 8, 16]))
        r = int(rng.randint(0, (mi_rows + bw4 - 1) // bw4)) * bw4
        c = int(rng.randint(0, mi_cols // bw4)) * bw4
        got = tmvp.find_mv_stack(tg, r, c, bw4, bw4, gm_mv=gm)
        want = jmvp.find_mv_stack(jg, r, c, bw4, bw4, gm_mv=gm)
        for k in ("stack", "num_found", "mode_context", "nearest_mv",
                  "near_mv", "ref_list"):
            assert getattr(got, k) == getattr(want, k), (k, r, c, bw4)
        # choose_inter_mode against the same stack, for several mvs
        for mv in [got.nearest_mv, got.near_mv, gm, _POOL[n % 8], (6, -2)]:
            assert ttc.choose_inter_mode(mv, got, gm) == \
                jti.choose_inter_mode(mv, want, gm)
        n += got.num_found
    assert n > 0


# ---- inter-mode writers ---------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_inter_writers(seed):
    """A random sequence of every writer's symbols through both coders:
    equal bytes and equal adapted CDFs."""
    rng = np.random.RandomState(seed)
    q = (40, 100, 160, 230)[seed]
    te, tc = TRangeEncoder(), tcdf.CdfContext(q, update=bool(seed % 3))
    je, jc = JRangeEncoder(), jcdf.CdfContext(q, update=bool(seed % 3))
    nb = lambda: [None, True, False][rng.randint(3)]
    ref = lambda: [None, 1][rng.randint(2)]
    for _ in range(300):
        op = rng.randint(6)
        if op == 0:
            a, l, v = nb(), nb(), bool(rng.randint(2))
            assert tim.intra_inter_ctx(a, l) == jim.intra_inter_ctx(a, l)
            tim.write_is_inter(te, tc, tim.intra_inter_ctx(a, l), v)
            jim.write_is_inter(je, jc, jim.intra_inter_ctx(a, l), v)
        elif op == 1:
            a, l = ref(), ref()
            _eq(tim.neighbor_ref_counts(a, l), jim.neighbor_ref_counts(a, l))
            tim.write_ref_frame_last(te, tc, tim.neighbor_ref_counts(a, l))
            jim.write_ref_frame_last(je, jc, jim.neighbor_ref_counts(a, l))
        elif op == 2:
            mode = int(rng.choice([13, 14, 15, 16]))
            ctx = int(rng.randint(0, 6)) | (int(rng.randint(0, 6)) << 4)
            tim.write_inter_mode(te, tc, mode, ctx)
            jim.write_inter_mode(je, jc, mode, ctx)
        elif op == 3:
            mode = int(rng.choice([14, 16]))
            k = int(rng.randint(1, 5))
            stack = [(0, 0, int(w)) for w in sorted(
                rng.choice([2, 4, 8, 640, 642, 700], k), reverse=True)]
            assert [tim.drl_ctx(stack, i) for i in range(k - 1)] == \
                [jim.drl_ctx(stack, i) for i in range(k - 1)]
            tim.write_drl_idx(te, tc, mode, stack, k)
            jim.write_drl_idx(je, jc, mode, stack, k)
        elif op == 4:
            big = 2 * int(rng.choice([1, 8, 100, 3000]))
            mv = tuple(2 * int(v) for v in rng.randint(-big, big + 1, 2))
            pred = tuple(2 * int(v) for v in rng.randint(-40, 41, 2))
            tim.write_mv(te, tc, mv, pred)
            jim.write_mv(je, jc, mv, pred)
        else:
            mode = int(rng.randint(0, 13))
            tim.write_y_mode_inter(te, tc, mode)
            jim.write_y_mode_inter(je, jc, mode)
    assert te.done() == je.done()
    for k in jc._t:
        _eq(tc._t[k], jc._t[k], k)


# ---- the tile coder's inter branch on random maps --------------------------

def _inter_maps(w, h, seed):
    """Random P-frame decision maps at (w, pad64(h)): intra candidates and
    the three lanes mixed at every depth, mvs from a small pool."""
    ph = tgeo.pad64(h)
    bh, bw, sh, sw = ph // 32, w // 32, ph // 64, w // 64
    rng = np.random.RandomState(seed)
    fp, fsb = tgeo.bottom_force_masks(bh, bw, sh, sw, h // 4)
    part = np.where(fp < 0, rng.randint(0, 2, (bh, bw)), fp).astype(np.int32)
    part_sb = np.where(fsb < 0, rng.randint(0, 2, (sh, sw)),
                       fsb).astype(np.int32)
    part_sb.flat[0] = 0

    def lev(*shape):
        a = rng.randint(-2, 3, shape) * (rng.rand(*shape) < 0.05)
        a[rng.rand(*shape) < 0.003] = rng.randint(-40, 41)
        a[rng.rand(*shape[:-2]) < 0.4] = 0
        return a.astype(np.int32)

    def mi(n_intra, *shape):
        inter = rng.rand(*shape) < 0.7
        return np.where(inter, n_intra + rng.randint(0, 3, shape),
                        rng.randint(0, n_intra, shape)).astype(np.int32)

    def mvs(*shape):
        # few distinct mvs, so that stacks often hold the block's own
        return np.array(_POOL[:3], np.int32)[rng.randint(0, 3, shape)]

    return dict(
        part=part, mi_top=mi(13, bh, bw),
        lev_top_y=lev(bh, bw, 32, 32), lev_top_u=lev(bh, bw, 16, 16),
        lev_top_v=lev(bh, bw, 16, 16), mi_sub=mi(10, bh, bw, 4),
        lev_sub_y=lev(bh, bw, 4, 16, 16), lev_sub_u=lev(bh, bw, 4, 8, 8),
        lev_sub_v=lev(bh, bw, 4, 8, 8), stx_sub=rng.randint(0, 5, (bh, bw, 4)),
        part_sb=part_sb, mi_sb=mi(13, sh, sw),
        lev_sb_y=lev(sh, sw, 32, 32), lev_sb_u=lev(sh, sw, 32, 32),
        lev_sb_v=lev(sh, sw, 32, 32), uv_top=rng.randint(0, 13, (bh, bw)),
        uv_sub=rng.choice(tw2.SUB_MODES, (bh, bw, 4)),
        uv_sb=rng.choice(tw2.SUB_MODES, (sh, sw)), mv_top=mvs(bh, bw),
        mv_sub=mvs(bh, bw, 4), mv_sb=mvs(sh, sw))


def _filter_syntax(w, h, seed):
    """Random in-loop filter side info of a P frame at (w, pad64(h)): a
    CDEF strength index a SB, CCSO flags a 256x256 unit on two planes, and
    LR units a SB under one frame type a plane (NONE, WIENER, SGRPROJ or
    SWITCHABLE)."""
    ph = tgeo.pad64(h)
    sh, sw = ph // 64, w // 64
    rng = np.random.RandomState(seed)
    cdef_bits = int(rng.randint(1, 4))
    cdef_idx = rng.randint(0, 1 << cdef_bits, (sh, sw)).astype(np.int32)
    uh, uw = -(-ph // 256), -(-w // 256)
    ccso = {"planes": [None if p == seed % 3 else
                       {"flags": rng.rand(uh, uw) < 0.6} for p in range(3)]}
    lr_types = tuple(int(t) for t in rng.permutation(4)[:3])
    kinds = {1: [0, 1], 2: [0, 2], 3: [0, 1, 2]}
    taps = lambda: np.stack([rng.randint(-5, 11, (sh, sw)),
                             rng.randint(-23, 9, (sh, sw)),
                             rng.randint(-17, 47, (sh, sw))], -1)
    lr_units = [None if t == 0 else {
        "type": rng.choice(kinds[t], (sh, sw)).astype(np.int32),
        "eps": rng.randint(0, 16, (sh, sw)).astype(np.int32),
        "xqd": np.stack([rng.randint(-96, 32, (sh, sw)),
                         rng.randint(-32, 96, (sh, sw))], -1).astype(np.int32),
        "taps_v": taps().astype(np.int32), "taps_h": taps().astype(np.int32)}
        for t in lr_types]
    return dict(cdef_bits=cdef_bits, cdef_idx=cdef_idx, ccso=ccso,
                lr_types=lr_types, lr_units=lr_units)


def _code_both(d, w, h, update, gm, t_init=None, j_init=None, filt=None):
    """The port's and the JAX package's inter TileCoder on the same maps,
    with the filter side info of _filter_syntax when filt is given."""
    ph = tgeo.pad64(h)
    cands = expand_candidates(tie.CAND_MODES)
    cands_sub = expand_candidates(tw2.SUB_MODES)
    cdef = (dict(cdef_bits=filt["cdef_bits"], cdef_idx=filt["cdef_idx"])
            if filt else {})
    tc = ttc.TileCoder(w, ph, 100, update, true_h=h, kf=False,
                       cdf_init=t_init, gm_mv=gm, **cdef)
    jc = jtc.TileCoder(w, ph, 100, update, kf=False, cdf_init=j_init,
                       true_h=h, gm_mv=gm, **cdef)
    if filt:
        for c in (tc, jc):
            c.ccso_info = filt["ccso"]
            c.set_lr(filt["lr_types"], filt["lr_units"])
    got = tc.encode(
        d["part"], d["mi_top"], d["lev_top_y"], d["lev_top_u"],
        d["lev_top_v"], d["mi_sub"], d["lev_sub_y"], d["lev_sub_u"],
        d["lev_sub_v"], cands, cands_sub, d["stx_sub"], d["part_sb"],
        d["mi_sb"], d["lev_sb_y"], d["lev_sb_u"], d["lev_sb_v"],
        d["uv_top"], d["uv_sub"], d["uv_sb"], mv_top=d["mv_top"],
        mv_sub=d["mv_sub"], mv_sb=d["mv_sb"])
    want = jc.encode(
        d["part"], d["mi_top"], d["lev_top_y"], d["lev_top_u"],
        d["lev_top_v"], d["mi_sub"], d["lev_sub_y"], d["lev_sub_u"],
        d["lev_sub_v"], d["mv_top"], d["mv_sub"], cands, cands_sub,
        len(cands), len(cands_sub), stx_sub=d["stx_sub"],
        part_sb=d["part_sb"], mi_sb=d["mi_sb"], lev_sb_y=d["lev_sb_y"],
        lev_sb_u=d["lev_sb_u"], lev_sb_v=d["lev_sb_v"], mv_sb=d["mv_sb"],
        uv_top=d["uv_top"], uv_sub=d["uv_sub"], uv_sb=d["uv_sb"])
    return got, want, tc.mode_counts


@pytest.mark.parametrize("w,h,seed,update,gm", [
    (128, 64, 0, True, (0, 0)), (128, 64, 1, False, (-16, -24)),
    (192, 56, 2, True, (8, -16)), (128, 120, 3, True, (-16, -24)),
    (256, 128, 4, True, (0, 0))])
def test_tile_coder_inter(w, h, seed, update, gm):
    """Two P frames on the CDF chain (the second seeded with the first's
    end-of-frame snapshot): equal bytes and CDFs, three of the four inter
    modes coded at least."""
    counts = dict.fromkeys((13, 14, 15, 16), 0)
    t_init = j_init = None
    for k in range(2):
        d = _inter_maps(w, h, 10 * seed + k)
        (got, got_cdf), (want, want_cdf), mc = _code_both(
            d, w, h, update, gm, t_init, j_init)
        assert len(got) > 50
        assert got == want, f"frame {k}"
        for key in want_cdf._t:
            _eq(got_cdf._t[key], want_cdf._t[key], key)
        t_init, j_init = got_cdf.snapshot(), want_cdf.snapshot()
        for m, n in mc.items():
            counts[m] += n
    assert sum(n > 0 for n in counts.values()) >= 3, counts


@pytest.mark.parametrize("w,h,seed,update,gm", [
    (128, 64, 5, True, (0, 0)), (192, 56, 6, False, (8, -16)),
    (256, 128, 7, True, (-16, -24)), (320, 192, 8, True, (0, 0))])
def test_tile_coder_inter_filters(w, h, seed, update, gm):
    """The filter syntax inside P frames (the CDEF literal at a SB's first
    non-skip block, the CCSO flags, the LR units at SB start around inter
    blocks), on two frames of the CDF chain: equal bytes and CDFs."""
    t_init = j_init = None
    for k in range(2):
        d = _inter_maps(w, h, 10 * seed + k)
        filt = _filter_syntax(w, h, 10 * seed + k)
        (got, got_cdf), (want, want_cdf), _ = _code_both(
            d, w, h, update, gm, t_init, j_init, filt)
        assert got == want, f"frame {k}"
        for key in want_cdf._t:
            _eq(got_cdf._t[key], want_cdf._t[key], key)
        t_init, j_init = got_cdf.snapshot(), want_cdf.snapshot()


# ---- the compound syntax ----------------------------------------------------

def _nb_info(rng):
    """A random neighbour as ref_mode_ctx reads it: None (unavailable) or
    (is_inter, ref0, ref1), ref1 0 for single-reference and intra."""
    k = rng.randint(4)
    if k == 0:
        return None
    if k == 1:
        return (False, 0, 0)
    if k == 2:
        return (True, int(rng.choice([1, 7])), 0)
    return (True, 1, 7)


@pytest.mark.parametrize("seed", range(4))
def test_compound_writers(seed):
    """A random sequence of the compound writers' symbols (comp_mode, the
    LAST+ALTREF pair, the compound modes) on random neighbour contexts
    through both coders: equal contexts, bytes and adapted CDFs."""
    rng = np.random.RandomState(50 + seed)
    q = (40, 100, 160, 230)[seed]
    te, tc = TRangeEncoder(), tcdf.CdfContext(q, update=bool(seed % 3))
    je, jc = JRangeEncoder(), jcdf.CdfContext(q, update=bool(seed % 3))
    for _ in range(300):
        a, l = _nb_info(rng), _nb_info(rng)
        ref = lambda nb: None if nb is None or not nb[0] else (
            (nb[1], nb[2]) if nb[2] else nb[1])
        counts = tim.neighbor_ref_counts(ref(a), ref(l))
        _eq(counts, jim.neighbor_ref_counts(ref(a), ref(l)))
        op = rng.randint(3)
        if op == 0:
            ctx = tim.ref_mode_ctx(a, l)
            assert ctx == jim.ref_mode_ctx(a, l)
            v = bool(rng.randint(2))
            tim.write_comp_mode(te, tc, ctx, v)
            jim.write_comp_mode(je, jc, ctx, v)
        elif op == 1:
            assert tim.comp_ref_type_ctx(a, l) == jim.comp_ref_type_ctx(a, l)
            tim.write_comp_refs_last_altref(te, tc, a, l, counts)
            jim.write_comp_refs_last_altref(je, jc, a, l, counts)
        else:
            mode = int(rng.randint(17, 25))
            ctx = int(rng.randint(0, 6)) | (int(rng.randint(0, 6)) << 4) | \
                (int(rng.randint(0, 2)) << 3)
            tim.write_inter_compound_mode(te, tc, mode, ctx)
            jim.write_inter_compound_mode(je, jc, mode, ctx)
    assert te.done() == je.done()
    for k in jc._t:
        _eq(tc._t[k], jc._t[k], k)


# pairs of (LAST, ALTREF) mvs, 1/8 pel (even: no high precision)
_PAIRS = [(0, 0, 0, 0), (-8, 16, 8, -16), (4, -6, -4, 6), (-16, 24, 0, 0),
          (2, 2, -2, -2)]


def _compound_maps(w, h, seed):
    """Random maps of a compound frame: intra candidates, the three
    single-reference lanes and the two compound lanes mixed at every
    depth; 4-component mvs as the encoder leaves them (a single-reference
    block's ALTREF half 0, GLOBAL_GLOBALMV's all 0, NEW_NEWMV's from a
    small pool of pairs)."""
    d = _inter_maps(w, h, seed)
    rng = np.random.RandomState(1000 + seed)
    n_i = {"mi_top": 13, "mi_sub": 10, "mi_sb": 13}
    for key, mv_key in (("mi_top", "mv_top"), ("mi_sub", "mv_sub"),
                        ("mi_sb", "mv_sb")):
        mi = d[key]
        inter = mi >= n_i[key]
        lane = rng.randint(0, 5, mi.shape)
        d[key] = np.where(inter, n_i[key] + lane, mi).astype(np.int32)
        pairs = np.array(_PAIRS, np.int32)[rng.randint(0, len(_PAIRS),
                                                       mi.shape)]
        single = np.concatenate([d[mv_key], np.zeros_like(d[mv_key])], -1)
        lane = lane[..., None]
        d[mv_key] = np.where(lane == 3, pairs, np.where(
            lane == 4, 0, single)).astype(np.int32)
    return d


@pytest.mark.parametrize("w,h,seed,update,modes", [
    (128, 64, 0, True, (17, 23, 24)), (192, 56, 1, True, (23, 24)),
    (256, 128, 2, False, (17, 23, 24))])
def test_tile_coder_compound(w, h, seed, update, modes):
    """The compound frame's tile (comp=True): comp_mode on every inter
    block, the LAST+ALTREF pair and NEAREST_NEARESTMV / GLOBAL_GLOBALMV /
    NEW_NEWMV on lanes 3-4, on two frames of the CDF chain: equal bytes
    and CDFs; `modes` (the compound modes the maps give) were coded."""
    ph = tgeo.pad64(h)
    cands = expand_candidates(tie.CAND_MODES)
    cands_sub = expand_candidates(tw2.SUB_MODES)
    counts = {}
    t_init = j_init = None
    for k in range(2):
        d = _compound_maps(w, h, 20 * seed + k)
        tc = ttc.TileCoder(w, ph, 100, update, true_h=h, kf=False,
                           cdf_init=t_init, comp=True)
        jc = jtc.TileCoder(w, ph, 100, update, kf=False, cdf_init=j_init,
                           true_h=h, comp=True)
        got, got_cdf = tc.encode(
            d["part"], d["mi_top"], d["lev_top_y"], d["lev_top_u"],
            d["lev_top_v"], d["mi_sub"], d["lev_sub_y"], d["lev_sub_u"],
            d["lev_sub_v"], cands, cands_sub, d["stx_sub"], d["part_sb"],
            d["mi_sb"], d["lev_sb_y"], d["lev_sb_u"], d["lev_sb_v"],
            d["uv_top"], d["uv_sub"], d["uv_sb"], mv_top=d["mv_top"],
            mv_sub=d["mv_sub"], mv_sb=d["mv_sb"])
        want, want_cdf = jc.encode(
            d["part"], d["mi_top"], d["lev_top_y"], d["lev_top_u"],
            d["lev_top_v"], d["mi_sub"], d["lev_sub_y"], d["lev_sub_u"],
            d["lev_sub_v"], d["mv_top"], d["mv_sub"], cands, cands_sub,
            len(cands), len(cands_sub), stx_sub=d["stx_sub"],
            part_sb=d["part_sb"], mi_sb=d["mi_sb"], lev_sb_y=d["lev_sb_y"],
            lev_sb_u=d["lev_sb_u"], lev_sb_v=d["lev_sb_v"], mv_sb=d["mv_sb"],
            uv_top=d["uv_top"], uv_sub=d["uv_sub"], uv_sb=d["uv_sb"])
        assert got == want, f"frame {k}"
        for key in want_cdf._t:
            _eq(got_cdf._t[key], want_cdf._t[key], key)
        t_init, j_init = got_cdf.snapshot(), want_cdf.snapshot()
        for m, n in tc.mode_counts.items():
            counts[m] = counts.get(m, 0) + n
    assert all(counts[m] > 0 for m in modes), str(counts)


# ---- the scan's prepare step and body ---------------------------------------

def _scan_inputs(form, seed):
    """Seeded inputs of a 128x64 scan call (chroma: U+V 2x32x64): src,
    force masks and the inter lanes of `form` ("key", "inter" 3 lanes,
    "compound" 5 lanes, "chroma" 1 lane forced by a random partition)."""
    rng = np.random.RandomState(seed)
    chroma = form == "chroma"
    B, h, w, bs = (2, 32, 64, 16) if chroma else (1, 64, 128, 32)
    bh, bw, sh, sw, hs = h // bs, w // bs, h // bs // 2, w // bs // 2, bs // 2
    src = torch.from_numpy(rng.randint(0, 256, (B, h, w)).astype(np.uint8))
    if chroma:
        fp = torch.from_numpy(rng.randint(0, 2, (B, bh, bw)).astype(np.int32))
        fsb = torch.from_numpy(rng.randint(0, 2, (B, sh, sw)).astype(
            np.int32))
    else:
        fp, fsb = (torch.from_numpy(a[None].copy()) for a in
                   tgeo.bottom_force_masks(bh, bw, sh, sw, h // 4))
    n = {"key": 0, "inter": 3, "compound": 5, "chroma": 1}[form]
    lanes = None
    if n:
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        pred = lambda *s: t(rng.randint(0, 256, (B, n) + s).astype(np.int32))
        rate = lambda *s: t(rng.uniform(3, 30, (B, n) + s).astype(
            np.float32))
        ok = lambda *s: t(rng.rand(*s) < 0.8)
        lanes = tw2.InterLanes(
            pred(bh, bw, bs, bs), rate(bh, bw), ok(B, n, bh, bw),
            pred(bh, bw, 4, hs, hs), rate(bh, bw, 4), ok(B, n, bh, bw, 4),
            pred(sh, sw, 2 * bs, 2 * bs), rate(sh, sw), ok(B, n, sh, sw),
            ok(B, bh, bw), ok(B, bh, bw, 4), ok(B, sh, sw))
    lam_map = torch.from_numpy(rng.uniform(0.68, 1.18, (B, bh, bw)).astype(
        np.float32))
    return src, bs, fp, fsb, chroma, lanes, lam_map


@pytest.mark.parametrize("form", ["key", "inter", "compound", "chroma"])
def test_part_scan_refilled_equals_one_shot_calls(form):
    """One PartScan's buffers refilled at q100 (weight 1, no map), at q140
    (weight 1.15, a random lambda map) and at q100 again: each run equals
    a one-shot call with the same arguments (on a card the refills are
    what a captured graph replays); the map and the weight move the
    decisions."""
    src, bs, fp, fsb, chroma, lanes, lam_map = _scan_inputs(form, 7)
    B, h, w = src.shape
    scan = tw2.PartScan("cpu", B, h, w, bs, chroma, 8, not chroma, None,
                        None if lanes is None else lanes.top.shape[1])
    runs = []
    for q, scale, lm in ((100, 1.0, None), (140, 1.15, lam_map),
                         (100, 1.0, None)):
        scan.fill(src, q, fp, fsb, lanes, scale, lm)
        got = scan.run()
        want = tw2.encode_plane_wavefront_part(
            src, bs, q, fp, fsb, chroma=chroma, tx_search=not chroma,
            inter=lanes, lam_scale=scale, lam_map=lm)
        for k, (g, w_) in enumerate(zip(got, want)):
            _eq(g, w_, f"q{q} output {k}")
        runs.append(got)
    for k, (a, b) in enumerate(zip(runs[0], runs[2])):
        _eq(a, b, f"refill output {k}")
    assert any(not torch.equal(a, b) for a, b in zip(runs[0], runs[1]))


def test_part_scan_lambda_weight_scales_the_lambda():
    """lam_scale is the product the JAX package forms: f32(lambda(q) *
    scale); the map defaults to ones."""
    cands = [expand_candidates(m) for m in (tie.CAND_MODES, tw2.SUB_MODES,
                                            tie.CAND_MODES)]
    for q in (60, 100, 200):
        rd = tw2.rd_params_part(q, 32, *cands, lam_scale=1.3)
        base = tw2.rd_params_part(q, 32, *cands)
        assert rd["lam"] == np.float32(tw2._lambda(q) * 1.3)
        for k in rd:
            if k != "lam":
                _eq(rd[k], base[k], k)
    scan = tw2.PartScan("cpu", 1, 64, 128, 32, False, 8, True, None)
    src, _, fp, fsb, _, _, _ = _scan_inputs("key", 3)
    scan.fill(src, 100, fp, fsb)
    assert bool((scan.lam_map == 1.0).all())
