"""The port's decoder (``svtav1_tpu_torch.decoder``, ``dec_app``) against
the JAX package's, on the CPU.

- Each reader of the port against JAX's on streams that JAX's writers
  make from seeded random symbols: BitReader, RangeDecoder, the subexp
  readers, LR units, read_coeffs_txb (8..32 and TX_64X64's band, every tx
  class), the inter-mode, reference, DRL and MV readers (compound
  included), read_partition_edge; compound MV stacks on random grids with
  tile offsets; the batched torch predictors against JAX's per-block numpy
  predictors (mvs far outside the frame included) and the compound
  golden; film grain synthesis against JAX's and its golden; metadata.
- Streams the port encodes on the CPU at 128x64, decoded by the port's
  ``Decoder(device="cpu")`` and the JAX ``Decoder``: outputs equal each
  other's and the encoder's recons (with film grain, the references).
- Streams only the JAX encoder makes (``tests/data/torch_dec``: compound
  pyramid, two tile columns, 10-bit, angle deltas): both decoders give
  the MD5s of the JAX encoder's recons stored beside them.
- Corrupt streams raise ``DecodeError`` with JAX's message, and streams
  with seeded byte flips in their tile data or frame headers give both
  decoders the same outcome (the same message, or the same frames); the CLI
  prints what ``svtav1_tpu.dec_app`` prints and writes its Y4M bytes.
"""

import functools
import hashlib
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from svtav1_tpu import dec_app as jdec_app
from svtav1_tpu.decoder.decoder import DecodeError as JDecodeError
from svtav1_tpu.decoder.decoder import Decoder as JDecoder
from svtav1_tpu.ec import coeffs as jco
from svtav1_tpu.ec import inter_modes as jim
from svtav1_tpu.ec import lr_syntax as jlrs
from svtav1_tpu.ec import modes as jmodes
from svtav1_tpu.ec import mvpred as jmvp
from svtav1_tpu.ec import range_coder as jrc
from svtav1_tpu.ec import subexp as jsub
from svtav1_tpu.ops import film_grain as jfg
from svtav1_tpu.ops import mc as jmc
from svtav1_tpu.spec import cdf as jcdf
from svtav1_tpu.spec import mv as jmv
from svtav1_tpu.spec import txfm as jT
from svtav1_tpu.utils import bitio as jbitio
from svtav1_tpu.utils import metadata as jmeta
from svtav1_tpu_torch import dec_app as tdec_app
from svtav1_tpu_torch.cuda.inputs import edge_frames, moving_frames
from svtav1_tpu_torch.decoder.decoder import DecodeError, Decoder
from svtav1_tpu_torch.ec import coeffs as tco
from svtav1_tpu_torch.ec import inter_modes as tim
from svtav1_tpu_torch.ec import lr_syntax as tlrs
from svtav1_tpu_torch.ec import modes as tmodes
from svtav1_tpu_torch.ec import mvpred as tmvp
from svtav1_tpu_torch.ec import range_coder as trc
from svtav1_tpu_torch.ec import subexp as tsub
from svtav1_tpu_torch.encoder.intra_encoder import EncoderConfig, IntraEncoder
from svtav1_tpu_torch.encoder.rate_control import RateControl
from svtav1_tpu_torch.encoder.video_encoder import VideoEncoder
from svtav1_tpu_torch.ops import film_grain as tfg
from svtav1_tpu_torch.ops import mc as tmc
from svtav1_tpu_torch.spec import cdf as tcdf
from svtav1_tpu_torch.utils import bitio as tbitio
from svtav1_tpu_torch.utils import metadata as tmeta
from svtav1_tpu_torch.utils.ivf import IvfWriter
from svtav1_tpu_torch.utils.obu import (OBU_FRAME, OBU_FRAME_HEADER,
                                        OBU_SEQUENCE_HEADER, parse_obus,
                                        wrap_obu)

jax.config.update("jax_platforms", "cpu")

DATA = Path(__file__).parent / "data"
FIX = DATA / "torch_dec"
W, H = 128, 64


# ------------------------------------------------------------------ #
# readers against JAX's on JAX-written streams

@pytest.mark.parametrize("seed", range(3))
def test_bit_reader(seed):
    rng = np.random.RandomState(seed)
    w = jbitio.BitWriter()
    ops = []
    for _ in range(200):
        kind = rng.randint(3)
        if kind == 0:
            n = int(rng.randint(1, 17))
            ops.append(("f", n))
            w.f(int(rng.randint(0, 1 << n)), n)
        elif kind == 1:
            ops.append(("uvlc", None))
            w.uvlc(int(rng.randint(0, 3000)))
        else:
            n = int(rng.randint(2, 300))
            ops.append(("ns", n))
            w.ns(int(rng.randint(0, n)), n)
    w.byte_align()
    data = w.data()
    t, j = tbitio.BitReader(data), jbitio.BitReader(data)
    for op, n in ops:
        args = () if n is None else (n,)
        assert getattr(t, op)(*args) == getattr(j, op)(*args), op
        assert t.bits_read == j.bits_read
    t.byte_align()
    j.byte_align()
    assert t.bits_read == j.bits_read == 8 * len(data)


def _symbol_stream(seed, n=400):
    """JAX RangeEncoder output of random symbols (adapted 4..16-ary CDFs),
    bools of random probability and literals, and the script to read it."""
    rng = np.random.RandomState(seed)
    ctx = jcdf.CdfContext(60 * seed, update=True)
    tables = [ctx.partition_cdf[5], ctx.kf_y_cdf[1][2], ctx.skip_cdfs[1],
              ctx.uv_mode_cdf[1][3], ctx.eob_flag_cdf256[0][0]]
    enc = jrc.RangeEncoder()
    script = []
    for _ in range(n):
        kind = rng.randint(3)
        if kind == 0:
            k = int(rng.randint(len(tables)))
            t = tables[k]
            ns = len(t) - 1
            s = int(rng.randint(ns))
            enc.encode_symbol(s, t, ns)
            ctx.update(t, s)
            script.append(("sym", k, s))
        elif kind == 1:
            f = int(rng.randint(1, 32768))
            b = int(rng.randint(2))
            enc.encode_bool(b, f)
            script.append(("bool", f, b))
        else:
            bits = int(rng.randint(1, 12))
            v = int(rng.randint(0, 1 << bits))
            enc.encode_literal(v, bits)
            script.append(("lit", bits, v))
    return enc.done(), script, 60 * seed


@pytest.mark.parametrize("seed", range(3))
def test_range_decoder(seed):
    data, script, q = _symbol_stream(seed)
    decs = [(trc.RangeDecoder(data), tcdf.CdfContext(q, update=True)),
            (jrc.RangeDecoder(data), jcdf.CdfContext(q, update=True))]
    for dec, ctx in decs:
        tables = [ctx.partition_cdf[5], ctx.kf_y_cdf[1][2],
                  ctx.skip_cdfs[1], ctx.uv_mode_cdf[1][3],
                  ctx.eob_flag_cdf256[0][0]]
        for kind, a, v in script:
            if kind == "sym":
                got = dec.decode_symbol(tables[a], len(tables[a]) - 1)
                ctx.update(tables[a], got)
            elif kind == "bool":
                got = dec.decode_bool(a)
            else:
                got = dec.decode_literal(a)
            assert got == v, (kind, a)
    t, j = decs[0][0], decs[1][0]
    assert (t.dif, t.rng, t.cnt, t.bptr) == (j.dif, j.rng, j.cnt, j.bptr)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_subexp_readers(k):
    rng = np.random.RandomState(k)
    cases = []
    enc = jrc.RangeEncoder()
    bw = jbitio.BitWriter()
    for _ in range(150):
        low = int(rng.randint(-100, 1))
        high = low + int(rng.randint(2, 300))
        ref = int(rng.randint(low, high))
        v = int(rng.randint(low, high))
        jsub.write_signed_refsubexpfin(enc, low, high, k, ref, v)
        jsub.write_signed_subexp_bits(bw, low, high, ref, v)
        n = int(rng.randint(1, 200))
        q = int(rng.randint(0, n))
        jsub.write_quniform(enc, n, q)
        cases.append((low, high, ref, v, n, q))
    bw.byte_align()
    data, bits = enc.done(), bw.data()
    for sub, rc, bio in ((tsub, trc, tbitio), (jsub, jrc, jbitio)):
        dec, br = rc.RangeDecoder(data), bio.BitReader(bits)
        for low, high, ref, v, n, q in cases:
            assert sub.read_signed_refsubexpfin(dec, low, high, k, ref) == v
            assert sub.read_signed_subexp_bits(br, low, high, ref) == v
            assert sub.read_quniform(dec, n) == q


@pytest.mark.parametrize("frame_type", [1, 2, 3])
def test_lr_units(frame_type):
    """A sequence of random LR units per plane (chained references), as
    the tile coder writes them, read back by the port and JAX."""
    rng = np.random.RandomState(frame_type)
    cdf = jcdf.CdfContext(100, update=True)
    enc = jrc.RangeEncoder()
    refs = [jlrs.default_ref_state() for _ in range(3)]
    units = []
    for _ in range(40):
        p = int(rng.randint(3))
        if frame_type == 3:
            ut = int(rng.randint(3))
        else:
            ut = frame_type * int(rng.randint(2))
        ep = int(rng.randint(16))
        r0, r1 = jlrs.SGR_R[ep]
        x0 = 0 if r0 == 0 else int(rng.randint(jlrs.SGRPROJ_PRJ_MIN0,
                                                jlrs.SGRPROJ_PRJ_MAX0 + 1))
        x1 = int(rng.randint(jlrs.SGRPROJ_PRJ_MIN1,
                             jlrs.SGRPROJ_PRJ_MAX1 + 1))
        if r1 == 0:
            x1 = min(max((1 << jlrs.SGRPROJ_PRJ_BITS) - x0,
                         jlrs.SGRPROJ_PRJ_MIN1), jlrs.SGRPROJ_PRJ_MAX1)
        taps = [[int(rng.randint(jlrs.WIENER_TAP_MIN[i],
                                 jlrs.WIENER_TAP_MAX[i] + 1))
                 for i in range(3)] for _ in range(2)]
        if p:
            taps[0][0] = taps[1][0] = 0
        unit = dict(type=ut, eps=ep, xqd=(x0, x1), taps_v=tuple(taps[0]),
                    taps_h=tuple(taps[1]))
        jlrs.write_lr_unit(enc, cdf, frame_type, ut, unit, refs[p], p > 0)
        units.append((p, unit))
    data = enc.done()
    for lrs, rc, cd in ((tlrs, trc, tcdf), (jlrs, jrc, jcdf)):
        dec, ctx = rc.RangeDecoder(data), cd.CdfContext(100, update=True)
        refs = [lrs.default_ref_state() for _ in range(3)]
        for p, u in units:
            ut, eps, xqd, tv, th = lrs.read_lr_unit(dec, ctx, frame_type,
                                                    refs[p], p > 0)
            assert ut == u["type"]
            if ut == lrs.RESTORE_SGRPROJ:
                assert (eps, tuple(xqd)) == (u["eps"], u["xqd"])
            elif ut == lrs.RESTORE_WIENER:
                assert (tuple(tv), tuple(th)) == (u["taps_v"], u["taps_h"])


# (tx size, coded size, luma tx types, chroma tx types, is_inter):
# TX_64X64 codes its 32 band; luma types come from the coded tx set (2D
# classes only), chroma types are the caller's (V_DCT / H_DCT: the 1D
# classes' contexts and scans)
TXB_CASES = [(jT.TX_8X8, 8, (0, 1, 2, 3, 9), (0, 10, 11), False),
             (jT.TX_16X16, 16, (0, 1, 2, 3, 9), (0, 10, 11, 9), False),
             (jT.TX_16X16, 16, (0, 9), (0, 10, 11), True),
             (jT.TX_32X32, 32, (0,), (0,), False),
             (jT.TX_32X32, 32, (0, 9), (0,), True),
             (jT.TX_64X64, 32, (0,), (0,), False)]


def _random_levels(rng, n, dense):
    lev = np.zeros((n, n), np.int32)
    k = int(rng.randint(1, n * n // (2 if dense else 8) + 2))
    r = rng.randint(0, n, k) if dense else rng.randint(0, max(2, n // 3), k)
    c = rng.randint(0, n, k) if dense else rng.randint(0, max(2, n // 3), k)
    mag = np.where(rng.rand(k) < 0.1, rng.randint(15, 3000, k),
                   rng.randint(1, 16, k))
    lev[r, c] = mag * np.where(rng.rand(k) < 0.5, -1, 1)
    return lev


@pytest.mark.parametrize("case", range(len(TXB_CASES)))
def test_read_coeffs_txb(case):
    txs, n, types, ctypes, inter = TXB_CASES[case]
    rng = np.random.RandomState(case)
    cdf = jcdf.CdfContext(120, update=True)
    enc = jrc.RangeEncoder()
    blocks = []
    for i in range(24):
        plane_type = i % 2 if txs != jT.TX_64X64 else 0
        ttype = int(types[i % len(types)] if plane_type == 0
                    else ctypes[i // 2 % len(ctypes)])
        lev = (np.zeros((n, n), np.int32) if i % 7 == 3
               else _random_levels(rng, n, dense=i % 3 == 0))
        ctx = (int(rng.randint(13)) if plane_type == 0
               else 7 + int(rng.randint(3)), int(rng.randint(3)))
        mode = int(rng.randint(13))
        jco.write_coeffs_txb(enc, cdf, lev, txs, ttype, plane_type, *ctx,
                             is_inter=inter, intra_mode=mode)
        blocks.append((lev, ttype, plane_type, ctx, mode))
    data = enc.done()
    got = []
    for co, rc, cd in ((tco, trc, tcdf), (jco, jrc, jcdf)):
        dec, ctx_ = rc.RangeDecoder(data), cd.CdfContext(120, update=True)
        out = []
        for lev, ttype, pt, ctx, mode in blocks:
            r, tt = co.read_coeffs_txb(dec, ctx_, n, n, txs,
                                       0 if pt == 0 else ttype, pt, *ctx,
                                       is_inter=inter, intra_mode=mode)
            np.testing.assert_array_equal(r, lev)
            if pt or np.any(lev):
                assert tt == ttype
            out.append((r, tt))
        got.append((out, ctx_))
    for (a, ta), (b, tb) in zip(got[0][0], got[1][0]):
        np.testing.assert_array_equal(a, b)
        assert ta == tb
    for k in ("coeff_base_cdf", "coeff_br_cdf", "txb_skip_cdf"):
        np.testing.assert_array_equal(getattr(got[0][1], k),
                                      getattr(got[1][1], k))


def _inter_syntax_stream(seed):
    """JAX writers: random is_inter, single LAST and compound refs, inter
    and compound modes with their DRL indices, MVs (classes up to large
    magnitudes), intra y modes, on random neighbour contexts."""
    rng = np.random.RandomState(seed)
    cdf = jcdf.CdfContext(100, update=True)
    enc = jrc.RangeEncoder()
    ops = []
    nbs = [None, (True, 1, 0), (True, 1, 7), (False, 0, 0), (True, 7, 0)]
    for _ in range(120):
        kind = int(rng.randint(7))
        if kind == 0:
            ctx, v = int(rng.randint(4)), bool(rng.randint(2))
            jim.write_is_inter(enc, cdf, ctx, v)
        elif kind == 1:
            ctx = (int(rng.randint(3)), int(rng.randint(3)), 0, 0,
                   int(rng.randint(2)), int(rng.randint(2)),
                   int(rng.randint(2)), int(rng.randint(3)))
            v = None
            jim.write_ref_frame_last(enc, cdf, ctx)
        elif kind == 2:
            a, l = nbs[rng.randint(5)], nbs[rng.randint(5)]
            counts = [0] * 8
            for nb in (a, l):
                if nb and nb[0]:
                    counts[nb[1]] += 1
                    if nb[2]:
                        counts[nb[2]] += 1
            ctx, v = (a, l, tuple(counts)), None
            jim.write_comp_mode(enc, cdf, jim.ref_mode_ctx(a, l), True)
            jim.write_comp_refs_last_altref(enc, cdf, a, l, counts)
        elif kind == 3:
            mc = _mode_context(rng)
            v = int(rng.choice([jmv.NEAREST_NEARESTMV, jmv.NEAR_NEARMV,
                                jmv.GLOBAL_GLOBALMV, jmv.NEW_NEWMV]))
            ctx = mc
            jim.write_inter_compound_mode(enc, cdf, v, mc)
        elif kind == 4:
            mc = _mode_context(rng)
            v = int(rng.choice([jmv.NEWMV, jmv.NEARESTMV, jmv.NEARMV,
                                jmv.GLOBALMV]))
            stack = [[int(rng.randint(-40, 40)), int(rng.randint(-40, 40)),
                      int(rng.choice([2, 8, 640]))]
                     for _ in range(int(rng.randint(0, 5)))]
            nf = len(stack)
            jim.write_inter_mode(enc, cdf, v, mc)
            idx = 0          # read_drl_idx's value: stack[idx] / [1 + idx]
            if v in (jmv.NEWMV, jmv.NEARMV) and nf > 1:
                start = 0 if v == jmv.NEWMV else 1
                pick = int(rng.randint(start, min(nf, 3)))
                _write_drl(enc, cdf, start, stack, nf, pick)
                idx = pick - start
            ctx = (mc, stack, nf)
            v = (v, idx)
        elif kind == 5:
            ref = (int(rng.randint(-300, 300)) * 2,
                   int(rng.randint(-300, 300)) * 2)
            big = int(rng.choice([2, 30, 2000, 8000]))
            mv = (ref[0] + 2 * int(rng.randint(-big, big)),
                  ref[1] + 2 * int(rng.randint(-big, big)))
            jim.write_mv(enc, cdf, mv, ref)
            ctx, v = ref, mv
        else:
            v = int(rng.randint(13))
            ctx = None
            jim.write_y_mode_inter(enc, cdf, v)
        ops.append((kind, ctx, v))
    return enc.done(), ops


def _mode_context(rng):
    """A find_mv_stack mode_context: newmv 0..5, zeromv 0..1, refmv 0..5."""
    return (int(rng.randint(6)) | int(rng.randint(2)) << jmv.GLOBALMV_OFFSET
            | int(rng.randint(6)) << jmv.REFMV_OFFSET)


def _write_drl(enc, cdf, start, stack, nf, idx):
    """The DRL bits that make read_drl_idx pick stack entry idx (start 0
    for NEWMV, 1 for NEARMV); write_drl_idx writes only the first."""
    for i in range(start, start + 2):
        if nf > i + 1:
            bit = int(idx != i)
            jim._sym(enc, cdf, cdf.drl_cdf[jim.drl_ctx(stack, i)], bit)
            if not bit:
                return


@pytest.mark.parametrize("seed", range(4))
def test_inter_mode_readers(seed):
    data, ops = _inter_syntax_stream(seed)
    for im, rc, cd in ((tim, trc, tcdf), (jim, jrc, jcdf)):
        dec, cdf = rc.RangeDecoder(data), cd.CdfContext(100, update=True)
        for kind, ctx, v in ops:
            if kind == 0:
                assert im.read_is_inter(dec, cdf, ctx) == v
            elif kind == 1:
                assert im.read_ref_frame_single(dec, cdf, ctx) == 1
            elif kind == 2:
                a, l, counts = ctx
                assert im.read_comp_mode(dec, cdf, im.ref_mode_ctx(a, l))
                assert im.read_comp_refs(dec, cdf, a, l, counts) == (1, 7)
            elif kind == 3:
                assert im.read_inter_compound_mode(dec, cdf, ctx) == v
            elif kind == 4:
                mc, stack, nf = ctx
                mode = im.read_inter_mode(dec, cdf, mc)
                idx = 0
                if mode in (jmv.NEWMV, jmv.NEARMV):
                    idx = im.read_drl_idx(dec, cdf, mode, stack, nf)
                assert (mode, idx) == v
            elif kind == 5:
                assert im.read_mv(dec, cdf, ctx) == v
            else:
                assert im.read_y_mode_inter(dec, cdf) == v
    nbs = (None, (True, 1, 0), (True, 1, 7), (False, 0, 0), (True, 7, 0))
    for a in ((x, y) for x in nbs for y in nbs):
        assert tim.ref_mode_ctx(*a) == jim.ref_mode_ctx(*a)
        assert tim.comp_ref_type_ctx(*a) == jim.comp_ref_type_ctx(*a)
    for refs in ((1, 7), None, 7, (1, 7)):
        c = tim.neighbor_ref_counts(refs, 1)
        assert np.array_equal(c, jim.neighbor_ref_counts(refs, 1))
        assert tim.comp_bwdref_p_ctx(c) == jim.comp_bwdref_p_ctx(c)


@pytest.mark.parametrize("bsize", [16, 32, 64])
def test_read_partition_edge(bsize):
    rng = np.random.RandomState(bsize)
    cdf = jcdf.CdfContext(100, update=True)
    enc = jrc.RangeEncoder()
    ops = []
    for _ in range(60):
        ctx = int(rng.randint(4)) + 4 * {16: 1, 32: 2, 64: 3}[bsize]
        has_rows, has_cols = bool(rng.randint(2)), bool(rng.randint(2))
        split = bool(rng.randint(2)) or not (has_rows or has_cols)
        jmodes.write_partition_edge(enc, cdf, ctx, split, bsize, has_rows,
                                    has_cols)
        ops.append((ctx, has_rows, has_cols))
    data = enc.done()
    got = []
    for mo, rc, cd in ((tmodes, trc, tcdf), (jmodes, jrc, jcdf)):
        dec, ctx_ = rc.RangeDecoder(data), cd.CdfContext(100, update=True)
        got.append([mo.read_partition_edge(dec, ctx_, c, bsize, hr, hc)
                    for c, hr, hc in ops])
    assert got[0] == got[1]


# ------------------------------------------------------------------ #
# compound MV stacks, MC, film grain, metadata

_POOL = [(0, 0), (-16, -24), (8, -16), (10, -22), (-4, 6), (40, 2),
         (-6, -6), (2, 0)]


def _compound_grids(mi_rows, mi_cols, seed):
    """The same random grid (LAST, ALTREF or LAST+ALTREF compound, intra)
    as a port and a JAX MiGrid."""
    rng = np.random.RandomState(seed)
    grids = (tmvp.MiGrid(mi_rows, mi_cols), jmvp.MiGrid(mi_rows, mi_cols))
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
                kind = rng.randint(4)
                mv = _POOL[rng.randint(8)]
                mv1 = _POOL[rng.randint(8)]
                for g in grids:
                    if kind == 0:
                        g.set_block(r, c, n, n, 0, int(rng.randint(13)))
                    elif kind == 3:
                        g.set_block(r, c, n, n, 1, 24, *mv, ref1=7,
                                    mv1r=mv1[0], mv1c=mv1[1])
                    else:
                        g.set_block(r, c, n, n, (1, 7)[kind - 1], 16, *mv)
    return grids


@pytest.mark.parametrize("seed", range(4))
def test_find_mv_stack_compound_tiles(seed):
    mi_rows, mi_cols = 16, 32
    tg, jg = _compound_grids(mi_rows, mi_cols, seed)
    rng = np.random.RandomState(50 + seed)
    n = 0
    for _ in range(40):
        bw4 = int(rng.choice([4, 8, 16]))
        r = int(rng.randint(0, mi_rows // bw4)) * bw4
        c = int(rng.randint(0, mi_cols // bw4)) * bw4
        ref = (1, 7) if rng.rand() < 0.6 else 1
        kw = dict(ref_frame=ref, mi_col_off=32 * (seed % 3),
                  frame_mi_cols=32 * (1 + seed % 3))
        got = tmvp.find_mv_stack(tg, r, c, bw4, bw4, **kw)
        want = jmvp.find_mv_stack(jg, r, c, bw4, bw4, **kw)
        for k in ("stack", "num_found", "mode_context", "nearest_mv",
                  "near_mv", "ref_list"):
            assert getattr(got, k) == getattr(want, k), (k, r, c, bw4, ref)
        n += got.num_found
    assert n > 0


def _planes(rng, h, w, bd):
    return rng.randint(0, 1 << bd, (h, w)).astype(np.int32)


@pytest.mark.parametrize("case", [(0, 0, 8), (1, 1, 8), (2, 0, 10),
                                  (3, 1, 8)])
def test_predictors_against_numpy(case):
    """The batched torch predictors against JAX's per-block numpy ones on
    random mvs, a quarter of them far outside the frame (the UMV clamp and
    the window clamp of the padded plane)."""
    seed, filt, bd = case
    rng = np.random.RandomState(seed)
    fh, fw = 64, 128
    for ss, bs in ((0, 16), (0, 32), (1, 8), (1, 16), (0, 64)):
        h, w = fh >> ss, fw >> ss
        r0, r1 = _planes(rng, h, w, bd), _planes(rng, h, w, bd)
        p0 = jmc.pad_plane_np(r0)
        p1 = jmc.pad_plane_np(r1)
        n = 12
        y0 = rng.randint(0, (h - bs) // 4 + 1, n) * 4
        x0 = rng.randint(0, (w - bs) // 4 + 1, n) * 4
        far = rng.rand(n, 2) < 0.25
        mva = np.where(far, rng.randint(-3000, 3000, (n, 2)),
                       rng.randint(-80, 80, (n, 2))) * 2
        mvb = np.where(far[:, ::-1], rng.randint(-3000, 3000, (n, 2)),
                       rng.randint(-80, 80, (n, 2))) * 2
        t0 = tmc.pad_plane(torch.from_numpy(r0))[None]
        t1 = tmc.pad_plane(torch.from_numpy(r1))[None]
        assert np.array_equal(t0[0].numpy(), p0)
        args = (torch.from_numpy(y0)[None], torch.from_numpy(x0)[None])
        single = tmc.predict_inter_blocks(
            t0, *args, torch.from_numpy(mva)[None], fh, fw, bs, ss, bd,
            filt)[0].numpy()
        comp = tmc.predict_inter_blocks_compound(
            t0, t1, *args, torch.from_numpy(mva)[None],
            torch.from_numpy(mvb)[None], fh, fw, bs, ss, bd, filt)[0].numpy()
        for k in range(n):
            want = jmc.predict_inter_block_np(p0, int(y0[k]), int(x0[k]),
                                              mva[k], fh, fw, bs, ss, bd,
                                              filt)
            np.testing.assert_array_equal(single[k], want)
            want = jmc.predict_inter_block_np_compound(
                p0, p1, int(y0[k]), int(x0[k]), mva[k], mvb[k], fh, fw, bs,
                ss, bd, filt=filt)
            np.testing.assert_array_equal(comp[k], want)


def test_compound_golden():
    """COMPOUND_AVERAGE against the reference's jnt convolve outputs: a
    16x16 chroma block at (8, 8) whose 1/16-pel mv is the golden phase."""
    d = np.load(DATA / "golden_compound.npz")
    for case in range(40):
        s0 = tmc.pad_plane(torch.from_numpy(
            d[f"c{case}_s0"].astype(np.int32)))[None]
        s1 = tmc.pad_plane(torch.from_numpy(
            d[f"c{case}_s1"].astype(np.int32)))[None]
        sx0, sy0, sx1, sy1 = (int(v) for v in d[f"c{case}_ph"])
        pos = torch.tensor([[8]])
        got = tmc.predict_inter_blocks_compound(
            s0, s1, pos, pos, torch.tensor([[[sy0, sx0]]]),
            torch.tensor([[[sy1, sx1]]]), 64, 64, 16, 1)[0, 0].numpy()
        np.testing.assert_array_equal(got, d[f"c{case}_out"],
                                      err_msg=f"case {case}")


def _fg_params(ip):
    """tests/test_film_grain_frame.py::_params_from_ip."""
    lag = int(ip[3])
    return dict(
        num_y_points=int(ip[0]), num_cb_points=int(ip[1]),
        num_cr_points=int(ip[2]), ar_coeff_lag=lag,
        ar_coeff_shift=int(ip[4]), grain_scale_shift=int(ip[5]),
        random_seed=int(ip[6]), bit_depth=8,
        chroma_scaling_from_luma=int(ip[7]), scaling_shift=int(ip[8]),
        cb_mult=int(ip[9]), cb_luma_mult=int(ip[10]),
        cb_offset=int(ip[11]), cr_mult=int(ip[12]),
        cr_luma_mult=int(ip[13]), cr_offset=int(ip[14]),
        overlap_flag=int(ip[15]), clip_to_restricted_range=int(ip[16]),
        scaling_points_y=[(int(ip[20 + 2 * i]), int(ip[21 + 2 * i]))
                          for i in range(ip[0])],
        scaling_points_cb=[(int(ip[48 + 2 * i]), int(ip[49 + 2 * i]))
                           for i in range(ip[1])],
        scaling_points_cr=[(int(ip[76 + 2 * i]), int(ip[77 + 2 * i]))
                           for i in range(ip[2])],
        ar_coeffs_y=ip[104:128].tolist(),
        ar_coeffs_cb=ip[128:153].tolist(),
        ar_coeffs_cr=ip[153:178].tolist())


@pytest.mark.parametrize("case", range(6))
def test_film_grain_golden(case):
    d = np.load(DATA / "golden_fg_frame.npz")
    p = _fg_params(d[f"c{case}_ip"])
    planes = tuple(d[f"c{case}_in_{k}"] for k in ("y", "cb", "cr"))
    out = tfg.apply_film_grain(p, planes)
    want = jfg.apply_film_grain(p, planes)
    for a, b, k in zip(out, want, ("y", "cb", "cr")):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, d[f"c{case}_out_{k}"])
        np.testing.assert_array_equal(a, b)
    assert np.array_equal(tfg.init_scaling_lut(p["scaling_points_y"]),
                          jfg.init_scaling_lut(p["scaling_points_y"]))


def test_metadata():
    md = "G(0.265,0.69)B(0.15,0.06)R(0.68,0.32)WP(0.3127,0.329)L(1000,0.01)"
    t35 = dict(country_code=0xB5, payload=b"\x00\x3c\x00\x01")
    built = tmeta.build_metadata_obus(md, "1000,400", tmeta.ItutT35(**t35))
    assert built == jmeta.build_metadata_obus(md, "1000,400",
                                              jmeta.ItutT35(**t35))
    assert tmeta.write_itut_t35_obu(tmeta.ItutT35(0xFF, b"ab", 7)) == \
        jmeta.write_itut_t35_obu(jmeta.ItutT35(0xFF, b"ab", 7))
    for _, _, _, payload in parse_obus(built + tmeta.write_itut_t35_obu(
            tmeta.ItutT35(0xFF, b"ab", 7))):
        a = tmeta.parse_metadata_payload(payload)
        b = jmeta.parse_metadata_payload(payload)
        assert a[0] == b[0] and repr(a[1]).split("(", 1)[1] == \
            repr(b[1]).split("(", 1)[1]
    for bad in ("G(1,2)", "x"):
        with pytest.raises(ValueError):
            tmeta.parse_mastering_display_str(bad)
    with pytest.raises(ValueError):
        tmeta.parse_content_light_str("1")


# ------------------------------------------------------------------ #
# streams: the port's decoder against the JAX Decoder

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU ops here are small: one intra-op thread each keeps
    this file from crowding the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decode_both(payloads, ccso=False):
    """Both decoders over a TU sequence: (outputs, port decoder); the
    outputs must be equal, dtype included."""
    t, j = Decoder(ccso=ccso, device="cpu"), JDecoder(ccso=ccso)
    outs = []
    for p in payloads:
        a, b = t.decode_frame_obus(p), j.decode_frame_obus(p)
        assert (a is None) == (b is None)
        if a is not None:
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)
            outs.append(a)
    assert _metadata(t) == _metadata(j)
    return outs, t


def _metadata(dec):
    """A decoder's parsed metadata OBUs as comparable values."""
    return [(t, type(v).__name__, v if isinstance(v, bytes) else vars(v))
            for t, v in dec.metadata]


def _equal_recons(outs, recons):
    assert len(outs) == len(recons)
    for k, (o, r) in enumerate(zip(outs, recons)):
        for a, b in zip(o, r):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(k))


def _encode(kind):
    """(payloads, recons, ccso) of one port-encoded CPU stream."""
    fr = moving_frames(W, H, 5)
    dev = dict(device="cpu")
    if kind == "flat intra":
        enc = IntraEncoder(EncoderConfig(W, H, part_search=False), **dev)
        return (*enc.encode_frames(fr[:1]), False)
    if kind == "partition intra q150":
        enc = IntraEncoder(EncoderConfig(W, H, qindex=150), **dev)
        return (*enc.encode_frames(fr[:1]), False)
    if kind == "partition intra 128x56":
        # blocks overhang the frame bottom (edge partitions, valid_h)
        enc = IntraEncoder(EncoderConfig(W, 56), **dev)
        return (*enc.encode_frames(moving_frames(W, 56, 1)), False)
    if kind == "filters":
        enc = IntraEncoder(EncoderConfig(W, H, enable_cdef=True,
                                         enable_lr=True, enable_ccso=True),
                           **dev)
        return (*enc.encode_frames(edge_frames(W, H, 1)), True)
    if kind in ("low-delay partition", "low-delay flat", "film grain",
                "cbr"):
        kw = dict(part_search=kind == "low-delay partition")
        if kind == "film grain":
            kw["film_grain"] = 20
        rc = RateControl("cbr", target_kbps=80) if kind == "cbr" else None
        enc = VideoEncoder(EncoderConfig(W, H, **kw), keyint=64, rc=rc,
                           **dev)
        return (*enc.encode_frames(fr[:3]), False)
    enc = VideoEncoder(EncoderConfig(W, H, part_search=False), keyint=64,
                       pyramid=True, gop=4, tf=True, **dev)
    payloads, recons = enc.encode_frames(fr)
    p, r = enc.flush()
    return payloads + p, recons + r, False


@pytest.mark.parametrize("kind", [
    "flat intra", "partition intra q150", "partition intra 128x56", "filters",
    "low-delay partition", "low-delay flat", "flat pyramid tf", "cbr"])
def test_port_streams(kind):
    payloads, recons, ccso = _encode(kind)
    outs, dec = _decode_both(payloads, ccso)
    _equal_recons(outs, recons)
    fr = dec.frame_header
    if kind == "filters":
        assert fr.ccso is not None and any(fr.lr_frame_types)
        assert any(p or s for p, s in fr.cdef_y_strengths +
                   fr.cdef_uv_strengths)
    if kind == "flat pyramid tf":
        assert len(payloads) == 9 and len(outs) == 5


def test_port_stream_film_grain():
    """Grain on the output only: the outputs equal JAX's, each shown
    frame differs from its recon, and the references equal the recons."""
    payloads, recons, _ = _encode("film grain")
    t, j = Decoder(device="cpu"), JDecoder()
    for p, rec in zip(payloads, recons):
        a, b = t.decode_frame_obus(p), j.decode_frame_obus(p)
        assert t.frame_header.film_grain is not None
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert not np.array_equal(a[0], rec[0])
        for x, y in zip(t.reference(0), rec):
            np.testing.assert_array_equal(x, np.asarray(y))


# ------------------------------------------------------------------ #
# the JAX encoder's fixture streams

def _ivf_payloads(path):
    from svtav1_tpu_torch.utils.ivf import read_ivf
    with open(path, "rb") as f:
        _, frames = read_ivf(f)
        return [p for p, _ in frames]


def _md5(planes):
    m = hashlib.md5()
    for p in planes:
        m.update(p.tobytes())
    return m.hexdigest()


MD5 = json.loads((FIX / "md5.json").read_text())


@pytest.mark.parametrize("name", sorted(MD5))
def test_fixture_streams(name):
    want = MD5[name]
    payloads = _ivf_payloads(FIX / f"{name}.ivf")
    assert len(payloads) == want["tus"]
    outs, _ = _decode_both(payloads)
    assert [_md5(o) for o in outs] == want["frames"]
    assert outs[0][0].dtype == (np.uint16 if want["bit_depth"] == 10
                                else np.uint8)


# ------------------------------------------------------------------ #
# errors and the CLI

def _obus(payload, kind):
    return [wrap_obu(t, d) for t, _, _, d in parse_obus(payload)
            if t == kind]


def _error_streams():
    pyr = _ivf_payloads(FIX / "compound_pyramid.ivf")
    seq = _obus(pyr[0], OBU_SEQUENCE_HEADER)[0]
    overlay = next(p for p in pyr if _obus(p, OBU_FRAME_HEADER))
    frame1 = _obus(pyr[1], OBU_FRAME)[0]
    key = _obus(pyr[0], OBU_FRAME)[0]
    return {
        # cut inside the frame header (a cut tile only reads zeros)
        "truncated": [seq + key[:8]],
        "frame before sequence header": [frame1],
        "missing reference": [seq + frame1],
        "show_existing of empty slot": [seq + _obus(overlay,
                                                    OBU_FRAME_HEADER)[0]],
    }


@pytest.mark.parametrize("case", ["truncated",
                                  "frame before sequence header",
                                  "missing reference",
                                  "show_existing of empty slot"])
def test_decode_errors(case):
    payloads = _error_streams()[case]
    msgs = []
    for dec, err in ((Decoder(device="cpu"), DecodeError),
                     (JDecoder(), JDecodeError)):
        with pytest.raises(err) as e:
            for p in payloads:
                dec.decode_frame_obus(p)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1], msgs


def _tile_spans(payloads, ccso=False):
    """Per TU, the lengths of its frame OBU's payload and of the tile data
    at its end, or None for a TU without a frame OBU (the frame OBU is
    each TU's last)."""
    dec, spans = Decoder(ccso=ccso, device="cpu"), []
    parse = dec._parse_tiles

    def record(tile_data, seq, fr):
        spans[-1] = (spans[-1], len(tile_data))
        return parse(tile_data, seq, fr)

    dec._parse_tiles = record
    for p in payloads:
        last = list(parse_obus(p))[-1]
        spans.append(len(last[3]) if last[0] == OBU_FRAME else None)
        dec.decode_frame_obus(p)
    return spans


def _flip(payload, span, seed):
    """`payload` with one seeded byte among its last `span` XORed."""
    rng = np.random.RandomState(seed)
    b = bytearray(payload)
    b[len(b) - span + int(rng.randint(span))] ^= int(rng.randint(1, 256))
    return bytes(b)


def _outcome(dec, payloads, err):
    """The shown frames of a decode, or the message it raised."""
    try:
        return [o for o in map(dec.decode_frame_obus, payloads)
                if o is not None]
    except err as e:
        return str(e)


_GOLOMB_BOUND = "corrupt or unsupported stream: coefficient level beyond int32"


@functools.lru_cache(maxsize=None)
def _corruptible(name):
    """(payloads, ccso) of a fixture or of the port's filter stream."""
    if name == "port filters":
        payloads, _, ccso = _encode("filters")
        return payloads, ccso
    return _ivf_payloads(FIX / f"{name}.ivf"), False


def _flip_span(span, where):
    """How many of a frame OBU's last bytes a flip may hit: its tile data,
    the tile data's last 16 bytes (the last blocks' syntax), or the whole
    OBU, frame header included."""
    obu, tiles = span
    return {"tile data": tiles, "tile tail": min(16, tiles),
            "frame": obu}[where]


@pytest.mark.parametrize("where", ["tile data", "tile tail", "frame"])
@pytest.mark.parametrize("name", sorted(MD5) + ["port filters"])
def test_corrupt_streams(name, where):
    """A seeded byte flip in a TU's tile data (or its last bytes, or
    anywhere in its frame OBU) makes both decoders raise DecodeError with
    the same message, or decode the same frames: values read from corrupt
    data reach the device stages (mvs, CDEF / LR / CCSO side info, edge
    indices) without an index error of the port's own."""
    payloads, ccso = _corruptible(name)
    clean = _outcome(Decoder(ccso=ccso, device="cpu"), payloads, DecodeError)
    decoded = changed = 0
    for k, span in enumerate(_tile_spans(payloads, ccso)):
        if span is None:
            continue
        for seed in range(2):
            bad = _flip(payloads[k], _flip_span(span, where), seed)
            stream = payloads[:k] + [bad] + payloads[k + 1:]
            a = _outcome(Decoder(ccso=ccso, device="cpu"), stream,
                         DecodeError)
            case = (k, seed)
            if a == _GOLOMB_BOUND:
                # the port bounds a Golomb prefix at 32 bits; JAX's
                # prefix loop has no bound, and on such data it never ends
                continue
            b = _outcome(JDecoder(ccso=ccso), stream, JDecodeError)
            if isinstance(a, str) or isinstance(b, str):
                assert a == b, case
                continue
            decoded += 1
            assert len(a) == len(b) == len(clean), case
            for x, y, c in zip(a, b, clean):
                changed += not all(map(np.array_equal, x, c))
                for p, q in zip(x, y):
                    np.testing.assert_array_equal(p, q, err_msg=str(case))
    if where == "tile tail" or name == "compound_pyramid":
        assert changed > 0 and decoded > 0


def test_device_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="not available"):
        Decoder(device="cuda")


@pytest.mark.parametrize("name", ["compound_pyramid", "ten_bit"])
def test_cli(name, tmp_path, capsys):
    ivf = str(FIX / f"{name}.ivf")
    outs = []
    for main, extra in ((tdec_app.main, ["--device", "cpu"]),
                        (jdec_app.main, [])):
        y4m = tmp_path / f"{main.__module__}.y4m"
        assert main(["-i", ivf, "-o", str(y4m), "--md5"] + extra) == 0
        outs.append((capsys.readouterr().out, y4m.read_bytes()))
    assert outs[0] == outs[1]
    assert f"decoded {len(MD5[name]['frames'])} frames" in outs[0][0]


def test_cli_corrupt_stream(tmp_path, capsys):
    bad = tmp_path / "bad.ivf"
    payloads = _error_streams()["missing reference"]
    with open(bad, "wb") as f:
        ivf = IvfWriter(f, W, H)
        for i, p in enumerate(payloads):
            ivf.write_frame(p, i)
        ivf.finalize()
    assert tdec_app.main(["-i", str(bad), "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert jdec_app.main(["-i", str(bad)]) == 1
    assert capsys.readouterr().err == err == \
        "error: missing reference frame\n"
