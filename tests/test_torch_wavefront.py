"""The port's wavefront against the JAX package's (the XLA twin of the
Pallas kernel), and the host-side tables the CUDA kernel reads against the
port's plain ops.

The wavefront bar is the one the Pallas kernel is held to: >= 99% of
blocks choose the same candidate, levels equal wherever the candidate
agrees, recon equal when every candidate agrees (float RD-cost sums may
break near-ties differently).
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from svtav1_tpu.encoder import wavefront as jwf
from svtav1_tpu.encoder.intra_encoder import CAND_MODES
from svtav1_tpu.spec import txfm as T
from svtav1_tpu_torch.cuda import gen_txfm_nets as gen
from svtav1_tpu_torch.cuda import wavefront_kernel as wk
from svtav1_tpu_torch.encoder import wavefront as twf
from svtav1_tpu_torch.ops import intra, transforms
from svtav1_tpu_torch.ops.intra_dir import dr_pred


def _src(rng, B, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for b in range(B):
        f = np.clip(120 + 60 * np.sin((xx + 7 * b) / 17.0) +
                    40 * np.cos((yy + 3 * b) / 11.0) +
                    rng.randint(-6, 7, (h, w)), 0, 255)
        out.append(f)
    return np.stack(out).astype(np.uint8)


def _agree(ref, got, label):
    mi_r, lev_r, rec_r = [np.asarray(a) for a in ref]
    mi_g, lev_g, rec_g = [np.asarray(a) for a in got]
    same = mi_r == mi_g
    frac = same.mean()
    assert frac >= 0.99, f"{label}: only {frac:.4f} of modes agree"
    np.testing.assert_array_equal(lev_r[same], lev_g[same],
                                  err_msg=f"{label} levels")
    if frac == 1.0:
        np.testing.assert_array_equal(rec_r.astype(np.int32),
                                      rec_g.astype(np.int32),
                                      err_msg=f"{label} recon")


# the three configs of tests/test_wavefront_pallas.py
WF_CASES = {
    "luma": (0, 2, 128, 192, 32, T.TX_32X32, 100, {}),
    "valid_h": (1, 1, 128, 128, 32, T.TX_32X32, 120, {"valid_h": 100}),
    "chroma": (2, 4, 64, 96, 16, T.TX_16X16, 100,
               {"paired": True, "kf": "uv", "uv_tx": True}),
}


@pytest.mark.parametrize("label", list(WF_CASES))
def test_wavefront_matches_jax(label, monkeypatch):
    monkeypatch.delenv("SVT_TPU_LAMBDA_SCALE", raising=False)
    seed, B, h, w, bs, txs, q, kw = WF_CASES[label]
    src = _src(np.random.RandomState(seed), B, h, w)
    ref = jwf.encode_plane_wavefront(src, bs, txs, q, CAND_MODES, 8, **kw)
    got = twf.encode_plane_wavefront(torch.from_numpy(src), bs, txs, q,
                                     CAND_MODES, 8, **kw)
    assert got[0].shape == (B, h // bs, w // bs)
    assert got[1].shape == (B, h // bs, w // bs, bs, bs)
    assert got[2].shape == (B, h, w)
    assert all(a.dtype == torch.int32 for a in got)
    _agree(ref, [a.numpy() for a in got], label)


@pytest.mark.parametrize("qindex,kf,scale", [
    (100, True, None), (120, True, None), (100, "uv", None),
    (200, "uv", "0.5")])
def test_rd_params_match_jax(qindex, kf, scale, monkeypatch):
    if scale is None:
        monkeypatch.delenv("SVT_TPU_LAMBDA_SCALE", raising=False)
    else:
        monkeypatch.setenv("SVT_TPU_LAMBDA_SCALE", scale)
    cands = twf.expand_candidates(CAND_MODES)
    assert cands == jwf.expand_candidates(CAND_MODES)
    ref = twf.rd_from_numpy(*[np.asarray(a) for a in
                              jwf.rd_params(qindex, 8, cands, kf=kf)])
    got = twf.rd_params(qindex, 8, cands, kf=kf)
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and r.shape == g.shape
        assert torch.equal(r, g)
    # the f32 lambda bit for bit
    assert ref[2].view(torch.int32).item() == got[2].view(torch.int32).item()


def test_quad_tables_match_jax():
    for bh, bw in ((4, 6), (34, 60)):
        for a, b in zip(twf._quad_tables(bh, bw), jwf._quad_tables(bh, bw)):
            np.testing.assert_array_equal(a, b)


# ---- the CUDA kernel's host-side tables, emulated in numpy ----------- #


@pytest.mark.parametrize("bs", [16, 32])
def test_linear_pred_maps_match_predictors(bs):
    """pred = (E[i0]*(32-sh) + E[i1]*sh + 16) >> 5 over E = [corner,
    above_ext, left_ext] reproduces V, H and every directional mode."""
    rng = np.random.RandomState(bs)
    above_ext = rng.randint(0, 256, (5, 2 * bs)).astype(np.int32)
    left_ext = rng.randint(0, 256, (5, 2 * bs)).astype(np.int32)
    corner = rng.randint(0, 256, 5).astype(np.int32)
    E = np.concatenate([corner[:, None], above_ext, left_ext], axis=1)
    cands = twf.expand_candidates(CAND_MODES)
    maps = wk.linear_pred_maps(bs, cands)
    t = torch.from_numpy
    checked = 0
    for ci, (mode, delta) in enumerate(cands):
        if not 1 <= mode <= 8:
            assert not maps[ci].any()
            continue
        i0, i1, sh = maps[ci] & 0xFF, (maps[ci] >> 8) & 0xFF, \
            (maps[ci] >> 16) & 0x3F
        got = np.clip((E[:, i0] * (32 - sh) + E[:, i1] * sh + 16) >> 5, 0,
                      255).reshape(5, bs, bs)
        if mode in (intra.V_PRED, intra.H_PRED):
            want = intra.predict(mode, t(above_ext[:, :bs]),
                                 t(left_ext[:, :bs]), t(corner))
        else:
            want = dr_pred(mode, delta, t(above_ext), t(left_ext), t(corner),
                           bs)
        np.testing.assert_array_equal(got, want.numpy(), err_msg=str(mode))
        checked += 1
    assert checked == 8


@pytest.fixture(scope="module")
def nets_lib(tmp_path_factory):
    """csrc/txfm_nets.cuh compiled by gcc as C, one entry per network:
    run(which, x, lo, hi) applies network `which` of gen.NETS to x[n]."""
    cases = []
    for k, (name, _, _, direction, _) in enumerate(gen.NETS):
        args = "x, lo, hi" if direction == "inv" else "x"
        cases.append(f"    case {k}: {name}({args}); break;")
    src = ("#include \"txfm_nets.cuh\"\n"
           "void run(int which, int *x, int lo, int hi) {\n"
           "  switch (which) {\n" + "\n".join(cases) + "\n  }\n}\n")
    d = tmp_path_factory.mktemp("nets")
    (d / "nets.c").write_text(src)
    so = d / "libnets.so"
    subprocess.run(["gcc", "-O1", "-shared", "-fPIC", "-I",
                    str(gen.HEADER.parent), "-o", str(so), str(d / "nets.c")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int]
    lib.run.restype = None
    return lib


def _net(lib, name, x, cols, lo=0, hi=0):
    """Apply the generated network `name` to every column (cols=True) or
    row of x [R, n, n] int64."""
    which = [n[0] for n in gen.NETS].index(name)
    x = np.array(x, np.int64)
    for b in range(x.shape[0]):
        for k in range(x.shape[1]):
            vec = np.ascontiguousarray(x[b, :, k] if cols else x[b, k],
                                       np.int32)
            lib.run(which, vec.ctypes.data, lo, hi)
            if cols:
                x[b, :, k] = vec
            else:
                x[b, k] = vec
    return x


def _rshift(x, s):
    return (x + (1 << (s - 1))) >> s if s > 0 else x * (1 << -s)


@pytest.mark.parametrize("tx_size,tx_type", [
    (T.TX_32X32, T.DCT_DCT), (T.TX_16X16, T.DCT_DCT),
    (T.TX_16X16, T.ADST_DCT), (T.TX_16X16, T.DCT_ADST),
    (T.TX_16X16, T.ADST_ADST)])
def test_stage_tables_match_transforms(tx_size, tx_type, nets_lib):
    """The kernel's 2D transform flow over the generated networks of
    csrc/txfm_nets.cuh (compiled by gcc) and tx_params equals the port's
    fwd_txfm2d and inv_txfm2d."""
    bs = T.TX_W[tx_size]
    rk, ck = (wk._KIND_NAME[k] for k in wk._kinds_of(tx_type))
    p = wk.tx_params(bs)
    rng = np.random.RandomState(tx_type)
    resid = rng.randint(-255, 256, (4, bs, bs)).astype(np.int32)
    v = _rshift(resid.astype(np.int64), p["fwd_s0"])
    col, row = (("net_fwd_dct32",) * 2 if bs == 32 else
                (f"net_fwd_col_{ck}{bs}", f"net_fwd_row_{rk}{bs}"))
    v = _net(nets_lib, col, v, True)
    v = _rshift(v, p["fwd_s1"])
    v = _net(nets_lib, row, v, False)
    v = _rshift(v, p["fwd_s2"])
    want = transforms.fwd_txfm2d(torch.from_numpy(resid), tx_size, tx_type)
    np.testing.assert_array_equal(v, want.numpy())

    assert (p["dq_lo"], p["row_lo"], p["mid_lo"], p["col_lo"]) == \
        (-(1 << 15),) * 4
    coef = (v // 7).clip(p["dq_lo"], p["dq_hi"])
    u = _net(nets_lib, f"net_inv_{rk}{bs}", coef, False, p["row_lo"],
             p["row_hi"])
    u = np.clip(_rshift(u, p["inv_s0"]), p["mid_lo"], p["mid_hi"])
    u = _net(nets_lib, f"net_inv_{ck}{bs}", u, True, p["col_lo"],
             p["col_hi"])
    u = _rshift(u, p["inv_s1"])
    want = transforms.inv_txfm2d(torch.from_numpy(coef.astype(np.int32)),
                                 tx_size, tx_type)
    np.testing.assert_array_equal(u, want.numpy())


def test_checked_in_header_matches_generator():
    assert gen.HEADER.read_text() == gen.emit(), \
        "run python -m svtav1_tpu_torch.cuda.gen_txfm_nets"


# (bs, h, w, valid_h): the three test configs and the 1080p planes
SCHED_CASES = {
    "luma": (32, 128, 192, 128), "valid_h": (32, 128, 128, 100),
    "chroma": (16, 64, 96, 64), "luma_1080p": (32, 1088, 1920, 1080),
    "chroma_1080p": (16, 544, 960, 540),
}


@pytest.mark.parametrize("label", list(SCHED_CASES))
def test_schedule_is_topological(label):
    """The ticket list is a permutation of the plane's blocks and every
    block's dependencies come before it."""
    bs, h, w, vh = SCHED_CASES[label]
    bh, bw = h // bs, w // bs
    sched = wk.schedule(bs, h, w, vh)
    ids = sched[:, 0] * bw + sched[:, 1]
    assert sorted(ids.tolist()) == list(range(bh * bw))
    pos = np.empty(bh * bw, int)
    pos[ids] = np.arange(len(ids))
    for k, row in enumerate(sched):
        deps = row[4:][row[4:] >= 0]
        assert (pos[deps] < k).all(), (label, row)


@pytest.mark.parametrize("label", list(SCHED_CASES))
def test_deps_cover_plain_edge_reads(label):
    """Every boundary pixel the plain body's edge assembly reads for a
    block was written by one of the block's dependencies, and every
    dependency is read: the buffers hold a code of each cell's position
    and the edges are decoded back to the blocks that wrote them."""
    bs, h, w, vh = SCHED_CASES[label]
    bh, bw = h // bs, w // bs
    sched = wk.schedule(bs, h, w, vh)
    ROW, COL = 1 << 20, 1 << 21
    rr, xx = np.mgrid[0:bh, 0:w]
    yy, cc = np.mgrid[0:h, 0:bw]
    rowbuf = torch.from_numpy((ROW + rr * w + xx)[None].astype(np.int32))
    colbuf = torch.from_numpy((COL + yy * bw + cc)[None].astype(np.int32))
    t = lambda a: torch.from_numpy(a.astype(np.int64))
    edges = twf._edges(rowbuf, colbuf, t(sched[:, 0]), t(sched[:, 1]),
                       t(sched[:, 2]).bool(), t(sched[:, 3]).bool(), bs, vh,
                       128)
    vals = np.concatenate([e[0].reshape(len(sched), -1).numpy()
                           for e in edges], axis=1)
    for row, v in zip(sched, vals):
        r_code = v[(v >= ROW) & (v < COL)] - ROW
        c_code = v[v >= COL] - COL
        writers = set(((r_code // w) * bw + (r_code % w) // bs).tolist())
        writers |= set(((c_code // bw) // bs * bw + c_code % bw).tolist())
        deps = set(row[4:][row[4:] >= 0].tolist())
        assert writers == deps, (label, row[:4], writers, deps)


def test_reciprocal_divides_exactly():
    """The kernel's deadzone division by a multiply and a shift."""
    rng = np.random.RandomState(0)
    for d in list(range(1, 2100)) + [4096, 21387, 65535]:
        m, s = wk.reciprocal(d)
        for n in [0, 1, d - 1, d, d + 1, (1 << 31) - 1] + \
                rng.randint(0, 1 << 31, 8).tolist():
            assert (n * m) >> s == n // d, (n, d)
            assert n * m < 1 << 64


def test_kernel_wrapper_rejects_cpu_tensors():
    cands = twf.expand_candidates(CAND_MODES)
    rd = twf.rd_params(100, 8, cands)
    src = torch.zeros((1, 64, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        wk.wavefront_cuda(src, rd, 32, T.TX_32X32, CAND_MODES)


# ---- the kernel's launch geometry ------------------------------------------

@pytest.mark.parametrize("C", range(1, wk.MAXC + 1))
def test_launch_geometry_runs_each_candidate_on_one_warp(C):
    """One candidate a warp on a cluster as wide as the list needs: 4 CTAs
    up to 16 candidates (the geometry of the 13-16-candidate forms,
    ceil(C / 4) warps a CTA), 8 up to 32, 16 up to 64, never more than 4
    warps a CTA nor a row of idle warps; every candidate on exactly one
    warp of one rank, and the write-out's lookup of a winner gives the
    warp that ran it."""
    K, wpc = wk.launch_geometry(C)
    assert K == (4 if C <= 16 else 8 if C <= 32 else 16)
    if C <= 16:
        assert wpc == min(-(-C // 4), 4)
    assert wpc <= 4 and (wpc - 1) * K < C <= K * wpc
    cand, home = wk.warp_map(C, K, wpc)
    runs = {}
    for rank in range(wk.MAXK):
        for w in range(wk.MAXW):
            c = cand[rank * wk.MAXW + w]
            if rank >= K or w >= wpc or c < 0:
                assert c == -1, (rank, w, c)
                continue
            assert c not in runs, (c, runs[c], (rank, w))
            runs[c] = (rank, w)
    assert sorted(runs) == list(range(C))
    for c, (rank, w) in runs.items():
        assert (home[c] & 0xFF, home[c] >> 8) == (rank, w)


def test_warp_map_rejects_a_launch_too_small():
    with pytest.raises(ValueError, match="do not fit"):
        wk.warp_map(61, 8, 4)
    with pytest.raises(ValueError, match="do not fit"):
        wk.warp_map(13, 4, wk.MAXW + 1)
    for C in (0, wk.MAXC + 1):
        with pytest.raises(ValueError, match="outside"):
            wk.launch_geometry(C)


def test_params_arrays_match_the_cuda_struct():
    """The kernel's limits and the lengths of WfParams' tables (the warp
    map among them) are the ctypes mirror's."""
    from pathlib import Path
    import re
    src = (Path(wk.__file__).parent.parent / "csrc" /
           "wavefront.cu").read_text()
    const = {n: int(v) for n, v in
             re.findall(r"constexpr int (\w+) = (\d+);", src)}
    for n in ("MAXC", "MAXK", "MAXW", "MAXDEP"):
        assert const[n] == getattr(wk, n), n
    body = re.search(r"struct WfParams \{(.*?)\n\};", src, re.S).group(1)
    arrays = {n: eval(e, {}, const) for n, e in
              re.findall(r"(\w+)\[([A-Z *]+)\];", body)}
    mirror = {n: t._length_ for n, t in wk._Params._fields_
              if hasattr(t, "_length_")}
    assert arrays == mirror


def test_ctypes_signatures_match_the_c_functions(monkeypatch):
    """The wrapper declares each extern "C" function of the kernel with
    the argument count of its definition (ctypes would pass a short call
    on to the library unchecked only on the card)."""
    from pathlib import Path
    import re
    import types
    from svtav1_tpu_torch.cuda import build
    src = (Path(wk.__file__).parent.parent / "csrc" /
           "wavefront.cu").read_text()
    body = src[src.index('extern "C" {'):]
    defs = {n: len([a for a in args.split(",") if a.strip()])
            for n, args in re.findall(r"^int (\w+)\(([^)]*)\)", body, re.M)}
    fake = types.SimpleNamespace(**{n: types.SimpleNamespace()
                                    for n in defs})
    fake.wf_params_size = lambda: ctypes.sizeof(wk._Params)
    monkeypatch.setattr(build, "load_library", lambda: fake)
    lib = wk._lib.__wrapped__()
    assert defs.keys() == {"wf_params_size", "wf_plane", "wf_info"}
    for n, count in defs.items():
        assert len(getattr(lib, n).argtypes) == count, n
