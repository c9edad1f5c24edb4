"""The port's flat low-delay P path (presets M11-M13 and --no-part-search
at --keyint > 1) against the JAX package at 128x64, q100, on the CPU.

One module fixture encodes three frames of ``cuda/inputs.moving_frames``
(I, P, P) with the port's VideoEncoder and with the JAX VideoEncoder, for
``part_search=False`` and for preset 13 (no CDF update, no filter search),
and records each P frame's decisions on both sides (JAX's from the
arguments of its ``encode_inter_tile``, its filter pick and its deblock
levels): every map, the mvs, the GM vector, the filter, the deblock
levels, the recons and the payloads must be equal.

At the fixture's shapes, so that this worker's JAX jit cache serves most
of them, the file also holds ``encode_plane_wavefront_mixed`` against
JAX's on random lanes (``test_torch_wavefront._agree``, the bar of the
wavefront tests, recon exact when every block agrees; masked intra
candidates, ``valid_h``, U and V in one call against two JAX calls),
``encode_inter_tile`` against JAX's on random maps over two chained
frames, the kernel's parameter block against the CUDA source's, and the
bound's count of the lanes' work.
"""

import re
from contextlib import contextmanager
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtav1_tpu.encoder import intra_encoder as jie
from svtav1_tpu.encoder import presets as jpresets
from svtav1_tpu.encoder import tile_inter as jti
from svtav1_tpu.encoder import video_encoder as jve
from svtav1_tpu.encoder import wavefront as jwf
from svtav1_tpu.spec import cdf as jcdf
from svtav1_tpu.spec import txfm as jT
from svtav1_tpu_torch.cuda import wavefront_kernel as wk
from svtav1_tpu_torch.cuda.inputs import moving_frames
from svtav1_tpu_torch.encoder import geometry as tgeo
from svtav1_tpu_torch.encoder import intra_encoder as tie
from svtav1_tpu_torch.encoder import presets as tpresets
from svtav1_tpu_torch.encoder import tile_inter as tti
from svtav1_tpu_torch.encoder import video_encoder as tve
from svtav1_tpu_torch.encoder import wavefront as twf
from svtav1_tpu_torch.spec import cdf as tcdf
from test_torch_part import one_thread
from test_torch_wavefront import _agree, _src

ROOT = Path(__file__).resolve().parent.parent
W, H, Q = 128, 64, 100
CONFIGS = ("no-part-search", "preset13")
MAPS = ("y_mi", "y_lev", "u_lev", "v_lev", "mv_t", "gm", "filt", "lf")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread (small tensors; the test workers
    share the machine's cores)."""
    with one_thread():
        yield


@pytest.fixture(autouse=True)
def _lambda_scale(monkeypatch):
    """Both packages read SVT_TPU_LAMBDA_SCALE: pin it."""
    monkeypatch.setenv("SVT_TPU_LAMBDA_SCALE", "1.0")


def _configs(name):
    if name == "preset13":
        return (tpresets.apply_preset(tie.EncoderConfig(W, H, qindex=Q), 13),
                jpresets.apply_preset(jie.EncoderConfig(W, H, qindex=Q), 13))
    return (tie.EncoderConfig(W, H, qindex=Q, part_search=False),
            jie.EncoderConfig(W, H, qindex=Q, part_search=False))


@contextmanager
def _jax_spies(frame):
    """Record the JAX flat P frame's decisions into the dict `frame`: the
    maps and mvs its tile coder gets, its filter pick."""
    tile, pick = jve.encode_inter_tile, jve._pick_interp_filt

    def spy_tile(w, h, q, upd, y_mi, y_lev, u_lev, v_lev, mv, cands,
                 n_intra, **kw):
        frame.update(y_mi=np.asarray(y_mi), y_lev=np.asarray(y_lev),
                     u_lev=np.asarray(u_lev), v_lev=np.asarray(v_lev),
                     mv_t=np.asarray(mv), gm=tuple(kw["gm_mv"]))
        return tile(w, h, q, upd, y_mi, y_lev, u_lev, v_lev, mv, cands,
                    n_intra, **kw)

    def spy_pick(*a, **kw):
        frame["filt"] = pick(*a, **kw)
        return frame["filt"]

    jve.encode_inter_tile, jve._pick_interp_filt = spy_tile, spy_pick
    try:
        yield
    finally:
        jve.encode_inter_tile, jve._pick_interp_filt = tile, pick


@pytest.fixture(scope="module")
def runs():
    frames = moving_frames(W, H, 3)
    out = {}
    for name in CONFIGS:
        tcfg, jcfg = _configs(name)
        with one_thread():
            enc = tve.VideoEncoder(tcfg, keyint=64, device="cpu")
            port, maps = [], []
            for f in frames:
                port.append(enc.encode_frame(*f))
                m = dict(enc.last_p) if len(port) > 1 else None
                if m is not None:
                    m["gm"] = tuple(m["gm"] or (0, 0))
                maps.append(m)
        jenc = jve.VideoEncoder(jcfg, keyint=64)
        lf_levels = jenc._p_lf_levels
        jax_out, jmaps = [], []
        for f in frames:
            rec = {"filt": 0}
            jenc._p_lf_levels = lambda q=None, rec=rec: rec.setdefault(
                "lf", lf_levels(q))
            with _jax_spies(rec):
                jax_out.append(jenc.encode_frame(*f))
            jmaps.append(rec if len(jax_out) > 1 else None)
        out[name] = dict(port=port, maps=maps, jax=jax_out, jmaps=jmaps)
    return out


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", MAPS)
@pytest.mark.parametrize("config", CONFIGS)
def test_p_frame_map(runs, config, k, name):
    got, want = (runs[config][s][k][name] for s in ("maps", "jmaps"))
    if isinstance(want, np.ndarray):
        assert np.shape(got) == want.shape, name
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=name)


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("config", CONFIGS)
def test_recon(runs, config, k):
    got, want = runs[config]["port"][k][1], runs[config]["jax"][k][1]
    for p, (g, w_) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g, np.int32),
                                      np.asarray(w_, np.int32),
                                      err_msg=f"plane {p}")


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("config", CONFIGS)
def test_payload(runs, config, k):
    got, want = runs[config]["port"][k][0], runs[config]["jax"][k][0]
    assert len(got) > 20
    assert got == want


@pytest.mark.parametrize("config", CONFIGS)
def test_the_clip_takes_the_inter_path(runs, config):
    """The P frames code (nearly) every block inter, and the second P
    frame's payload is a fraction of the key frame's."""
    for k in (1, 2):
        m = runs[config]["maps"][k]
        assert (m["y_mi"] >= 13).mean() > 0.5
        assert sum(m["mode_counts"].values()) == int((m["y_mi"] >= 13).sum())
    port = runs[config]["port"]
    assert len(port[2][0]) < len(port[0][0]) // 2


# ---- the mixed wavefront on random lanes ------------------------------------

def _lanes(seed, B, h, w, bs, n_extra, p_ok=0.8, p_iok=0.8):
    """A source stack and n_extra lanes: lane e is the source plus noise
    of amplitude 3 + 12 e, and noise alone on ~40% of the blocks (so
    lanes win some blocks and lose others), rates of 4-30 bits, random
    masks."""
    rng = np.random.RandomState(seed)
    src = _src(rng, B, h, w)
    bh, bw = h // bs, w // bs
    blk = src.reshape(B, bh, bs, bw, bs).transpose(0, 1, 3, 2, 4)
    amp = lambda e: 3 + 12 * e
    preds = np.stack([np.clip(blk.astype(np.int32) + rng.randint(
        -amp(e), amp(e) + 1, blk.shape), 0, 255) for e in range(n_extra)],
        1).astype(np.int32)
    bad = rng.rand(B, 1, bh, bw, 1, 1) < 0.4
    preds = np.where(bad, rng.randint(0, 256, preds.shape), preds).astype(
        np.int32)
    rate = rng.uniform(4, 30, (B, n_extra, bh, bw)).astype(np.float32)
    ok = rng.rand(B, n_extra, bh, bw) < p_ok
    iok = rng.rand(B, bh, bw) < p_iok
    return src, preds, rate, ok, iok


def _port_mixed(src, preds, rate, ok, iok, bs, tx, n_extra, modes, vh):
    t = torch.from_numpy
    out = twf.encode_plane_wavefront_mixed(
        t(src), bs, tx, Q, t(preds), t(rate), t(ok), t(iok), n_extra,
        modes, 8, valid_h=vh)
    return [a.numpy() for a in out]


def _jax_mixed(src, preds, rate, ok, iok, bs, tx, n_extra, modes, vh):
    out = jwf.encode_plane_wavefront_mixed(
        jnp.asarray(src).astype(jnp.int32), bs, tx, Q, jnp.asarray(preds),
        jnp.asarray(rate), jnp.asarray(ok), jnp.asarray(iok), n_extra,
        modes, 8, (0,), valid_h=vh)
    return [np.asarray(a) for a in out]


# label: seed, B, h, w, bs, n_extra, modes, valid_h
MIXED_CASES = {
    "luma 2 lanes": (0, 1, 64, 128, 32, 2, jie.CAND_MODES, None),
    "luma 2 lanes valid_h": (1, 1, 64, 128, 32, 2, jie.CAND_MODES, 56),
    "chroma 1 lane": (2, 1, 32, 64, 16, 1, (0,), None),
    "chroma 1 lane valid_h": (3, 1, 32, 64, 16, 1, (0,), 28),
}


@pytest.mark.parametrize("label", MIXED_CASES)
def test_mixed_wavefront_matches_jax(label):
    seed, B, h, w, bs, n_extra, modes, vh = MIXED_CASES[label]
    tx = jT.TX_32X32 if bs == 32 else jT.TX_16X16
    args = _lanes(seed, B, h, w, bs, n_extra) + (bs, tx, n_extra, modes, vh)
    want = _jax_mixed(*args)
    got = _port_mixed(*args)
    _agree(want, got, label)
    n_intra = len(twf.expand_candidates(modes))
    assert (got[0] >= n_intra).any() and (got[0] < n_intra).any(), \
        "the case must pick lanes and intra candidates"


def test_chroma_u_and_v_in_one_call_match_two_jax_calls():
    """U and V on the batch axis choose independently: the port's one call
    equals JAX's two, with the P frame's masks (intra where luma is intra,
    the lane where it is inter)."""
    src, preds, rate, _, _ = _lanes(4, 2, 32, 64, 16, 1)
    rng = np.random.RandomState(5)
    is_inter = rng.rand(1, 2, 4) < 0.6
    ok = np.concatenate([is_inter[:, None]] * 2)
    iok = np.concatenate([~is_inter] * 2)
    got = _port_mixed(src, preds, rate, ok, iok, 16, jT.TX_16X16, 1, (0,),
                      None)
    for b in range(2):
        want = _jax_mixed(src[b:b + 1], preds[b:b + 1], rate[b:b + 1],
                          ok[b:b + 1], iok[b:b + 1], 16, jT.TX_16X16, 1,
                          (0,), None)
        _agree(want, [a[b:b + 1] for a in got], f"plane {b}")
        np.testing.assert_array_equal(got[0][b] >= 1, is_inter[0])


def test_a_masked_intra_candidate_cannot_win():
    """Blocks where intra wins with every candidate allowed pick a lane
    once intra is masked, in both packages."""
    src, preds, rate, ok, _ = _lanes(6, 1, 64, 128, 32, 2, p_ok=1.0)
    preds = preds // 2                              # poor lanes
    free = np.ones((1, 2, 4), bool)
    args = (32, jT.TX_32X32, 2, jie.CAND_MODES, None)
    open_ = _port_mixed(src, preds, rate, ok, free, *args)
    intra_wins = open_[0] < 13
    assert intra_wins.sum() >= 2
    masked = ~intra_wins | (np.arange(8).reshape(1, 2, 4) % 2 == 0)
    want = _jax_mixed(src, preds, rate, ok, masked, *args)
    got = _port_mixed(src, preds, rate, ok, masked, *args)
    _agree(want, got, "masked intra")
    forced = intra_wins & ~masked
    assert forced.any()
    assert (got[0][forced] >= 13).all() and (want[0][forced] >= 13).all()


def test_mixed_form_runs_the_plain_body_on_the_cpu(monkeypatch):
    """A CPU tensor never reaches the kernel wrapper; the wrapper refuses a
    CPU tensor with lanes."""
    monkeypatch.setattr(wk, "launch", lambda *a, **kw: pytest.fail(
        "the kernel wrapper ran for a CPU tensor"))
    args = _lanes(7, 1, 64, 64, 32, 2)
    _port_mixed(*args, 32, jT.TX_32X32, 2, jie.CAND_MODES, None)
    monkeypatch.undo()
    t = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        wk.wavefront_cuda(t[0], twf.rd_params(Q, 8, twf.expand_candidates(
            jie.CAND_MODES), kf=False), 32, jT.TX_32X32, jie.CAND_MODES,
            extra=tuple(t[1:]))


def test_mixed_form_checks_its_lane_count():
    args = _lanes(8, 1, 64, 64, 32, 2)
    with pytest.raises(ValueError, match="n_extra"):
        _port_mixed(*args, 32, jT.TX_32X32, 1, jie.CAND_MODES, None)


# ---- the flat inter tile coder ----------------------------------------------

_POOL = [(-16, -24), (8, -16), (0, 4), (-6, 10)]


def _flat_maps(w, h, seed):
    """Random flat P-frame maps at (w, pad64(h)): intra candidates, NEWMV
    and GLOBALMV lanes; NEWMV mvs from a small pool, so that stacks often
    hold the block's own."""
    ph = tgeo.pad64(h)
    bh, bw = ph // 32, w // 32
    rng = np.random.RandomState(seed)

    def lev(*shape):
        a = rng.randint(-2, 3, shape) * (rng.rand(*shape) < 0.05)
        a[rng.rand(*shape) < 0.003] = rng.randint(-40, 41)
        a[rng.rand(*shape[:-2]) < 0.4] = 0
        return a.astype(np.int32)

    inter = rng.rand(bh, bw) < 0.7
    y_mi = np.where(inter, 13 + rng.randint(0, 2, (bh, bw)),
                    rng.randint(0, 13, (bh, bw))).astype(np.int32)
    mv = np.array(_POOL, np.int32)[rng.randint(0, len(_POOL), (bh, bw))]
    return (y_mi, lev(bh, bw, 32, 32), lev(bh, bw, 16, 16),
            lev(bh, bw, 16, 16), mv)


@pytest.mark.parametrize("w,h,seed,update,gm", [
    (128, 64, 0, True, (0, 0)), (128, 56, 1, False, (-16, -24)),
    (192, 120, 2, True, (8, -16)), (256, 88, 3, True, (-16, -24))])
def test_encode_inter_tile_matches_jax(w, h, seed, update, gm):
    """Two chained P frames (the second from the first's end-of-frame
    snapshot): equal bytes and CDFs, and NEWMV plus two other inter modes
    coded."""
    ph = tgeo.pad64(h)
    cands = twf.expand_candidates(tie.CAND_MODES)
    t_init = j_init = None
    counts = {}
    for k in range(2):
        maps = _flat_maps(w, h, 10 * seed + k)
        got, got_cdf = tti.encode_inter_tile(
            w, ph, Q, update, *maps, cands, 13, cdf_init=t_init, true_h=h,
            gm_mv=gm, mode_counts=counts)
        want, want_cdf = jti.encode_inter_tile(
            w, ph, Q, update, *maps, cands, 13, cdf_init=j_init, true_h=h,
            gm_mv=gm)
        assert len(got) > 50
        assert got == want, f"frame {k}"
        for key in want_cdf._t:
            np.testing.assert_array_equal(np.asarray(got_cdf._t[key]),
                                          np.asarray(want_cdf._t[key]),
                                          err_msg=key)
        t_init, j_init = got_cdf.snapshot(), want_cdf.snapshot()
    assert counts[16] > 0 and sum(n > 0 for n in counts.values()) >= 3, \
        counts
    assert isinstance(t_init, tcdf.CdfContext)
    assert isinstance(j_init, jcdf.CdfContext)


# ---- the kernel's host side ------------------------------------------------

def _c_fields():
    """Field names of struct WfParams in csrc/wavefront.cu, in order."""
    src = (ROOT / "svtav1_tpu_torch/csrc/wavefront.cu").read_text()
    body = re.search(r"struct WfParams \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        decl = re.sub(r"^(const\s+)?(unsigned long long|[A-Za-z_0-9]+)\*?",
                      "", decl)
        names += [re.sub(r"[\s*]|\[.*\]", "", n) for n in decl.split(",")]
    return names


def test_params_block_matches_the_cuda_struct():
    """The ctypes mirror lists WfParams' fields in the source's order (the
    library only checks the total size)."""
    assert [n for n, _ in wk._Params._fields_] == _c_fields()


def test_bound_counts_the_lanes():
    """The lanes add their chains (without prediction) and their inputs;
    a candidate no block lets compete adds no operation."""
    base = wk.work(32, 1, 1088, 1920, jie.CAND_MODES)
    lanes = wk.work(32, 1, 1088, 1920, jie.CAND_MODES, n_extra=2)
    px, blocks = 1088 * 1920, 1088 * 1920 // 1024
    assert lanes[1] - base[1] == 2 * (px + 5 * blocks) + blocks
    per_lane = (lanes[0] - base[0]) / 2
    assert 0.8 * base[0] / 13 < per_lane < base[0] / 13
    chroma = wk.work(16, 2, 544, 960, (0,), n_extra=1)
    half = wk.work(16, 2, 544, 960, (0,), n_extra=1, live=[0.25, 0.75])
    assert half[0] < chroma[0] and half[1] == chroma[1]
    ms, by = wk.bound_ms(32, 1, 1088, 1920, jie.CAND_MODES, n_extra=2)
    assert ms > wk.bound_ms(32, 1, 1088, 1920, jie.CAND_MODES)[0]
    assert by == "operations"
