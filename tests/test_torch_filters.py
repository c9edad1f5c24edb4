"""The port's in-loop filter stage (CDEF, CCSO, loop restoration) on the
partition intra path against the JAX package at 128x64, on the CPU.

The JAX partition scan is not run again here (``test_torch_part.py`` holds
the port's device tuple to JAX's field by field): each configuration runs
the port's ``device_encode``, hands the same tuple to the port's
``host_finish`` and to the JAX encoder's ``_host_finish_part``, and
requires byte-identical payloads, equal filtered recons and equal filter
decisions (CDEF params, CCSO info, LR frame types and every unit field).
The configurations make every tool fire, and ``test_every_tool_fires``
asserts it from the JAX run:

- ``all``: a batch of a frame with a flat 64x64 SB, a smooth 32x32 block
  and split textured blocks (``test_torch_part.part_frames``) and a frame
  of sharp diagonal edges beside noise: CDEF with nonzero strengths and
  2 strength sets, SGR units, CCSO in luma after CDEF, on all three
  partition depths;
- ``ccso_lr``: an 8-pixel luma checker with co-located chroma edges,
  CCSO and LR without CDEF (CCSO classifies the deblocked luma; LR takes
  its stripe context from the pre-CCSO planes);
- ``lr``: LR alone (its context rows are the deblocked planes);
- ``wiener``: ``all`` with SGR priced out and Wiener free in both
  packages' searches (as ``tests/test_lr_e2e.py`` does), so Wiener units
  and their syntax run through the whole path;
- ``sb64``: CDEF alone on frames whose coded 64x64 SB NONE and split SB
  want different strengths (2 sets: the CDEF literal at a 64-wide first
  block; ``all`` codes it in split SBs).
"""

from contextlib import contextmanager

import numpy as np
import pytest
import torch

import svtav1_tpu.encoder.ccso_search as jccs
import svtav1_tpu.encoder.cdef_search as jcds
import svtav1_tpu.encoder.lr_search as jlrs
from svtav1_tpu.encoder import geometry as jgeo
from svtav1_tpu.encoder import intra_encoder as jie
from svtav1_tpu.utils.ivf import read_ivf
from svtav1_tpu.utils.y4m import Y4mInfo, Y4mWriter
from svtav1_tpu_torch import app
from svtav1_tpu_torch.encoder import intra_encoder as tie
from svtav1_tpu_torch.encoder import lr_search as tlrs
from svtav1_tpu_torch.encoder.presets import apply_preset
from svtav1_tpu_torch.utils.obu import OBU_FRAME, parse_obus
from test_torch_part import one_thread, part_frames

W, H = 128, 64
ALL = dict(enable_cdef=True, enable_lr=True, enable_ccso=True)


def edge_frames(w, h, n=2, seed=0):
    """Left SB: sharp diagonal edges with noise; right SB: noise; chroma
    with co-located edges."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for b in range(n):
        edges = 128 + 70 * np.sign(np.sin((xx + 2 * yy) / 6.0 + b)) + \
            rng.randint(-12, 13, (h, w))
        y = np.where(xx < 64, edges, 128 + rng.randint(-40, 41, (h, w)))
        cy, cx = yy[::2, ::2], xx[::2, ::2]
        u = 120 + 30 * np.sign(np.sin((cx + 2 * cy) / 3.0)) + \
            rng.randint(-6, 7, (h // 2, w // 2))
        v = 130 + 25 * np.cos(cy / 4.0) + rng.randint(-8, 9, (h // 2, w // 2))
        frames.append(tuple(np.clip(p, 0, 255).astype(np.uint8)
                            for p in (y, u, v)))
    return frames


def checker_frames(w, h, n=2):
    """An 8-pixel 60/200 luma checker with co-located chroma edges."""
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for b in range(n):
        y = np.where(((yy // 8) + (xx // 8) + b) % 2, 200, 60)
        c = ((yy[::2, ::2] // 4) + (xx[::2, ::2] // 4) + b) % 2
        frames.append((y.astype(np.uint8),
                       np.where(c, 170, 80).astype(np.uint8),
                       np.where(c, 90, 160).astype(np.uint8)))
    return frames


def mixed_frames():
    return [part_frames(W, H)[0], edge_frames(W, H)[0]]


def sb64_frames(n=2):
    """Left SB: a smooth, lightly noisy surface (a coded 64x64 SB NONE);
    right SB: the edge frame's edges.  At q110 the two SBs want
    different CDEF strengths: 2 strength sets, the first coded literal in
    a 64x64 block."""
    yy, xx = np.mgrid[0:H, 0:W]
    frames = []
    for b in range(n):
        rng = np.random.RandomState(1 + b)
        e = edge_frames(W, H, seed=b)[0]
        smooth = 100 + 30 * np.sin(xx / 23.0) * np.cos(yy / 19.0) + \
            rng.randint(-4, 5, (H, W))
        y = np.where(xx < 64, smooth, np.roll(e[0], 64, 1))
        frames.append((np.clip(y, 0, 255).astype(np.uint8),
                       np.roll(e[1], 32, 1), e[2]))
    return frames


CONFIGS = {  # name: (frames, qindex, config fields, Wiener forced)
    "all": (mixed_frames, 100, ALL, False),
    "ccso_lr": (lambda: checker_frames(W, H), 120,
                dict(enable_ccso=True, enable_lr=True), False),
    "lr": (mixed_frames, 100, dict(enable_lr=True), False),
    "wiener": (mixed_frames, 100, ALL, True),
    "sb64": (sb64_frames, 110, dict(enable_cdef=True), False),
}


@contextmanager
def spies(mp):
    """Record each search's result, per frame, in both packages."""
    got = {"jax": [], "port": []}

    def spy(mod, name, side):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            got[side].append((name, out))
            return out
        mp.setattr(mod, name, wrapped)

    for name in ("cdef_search_frame", "ccso_search_frame",
                 "lr_search_frame"):
        spy(tie, name, "port")
    spy(jcds, "cdef_search_frame", "jax")
    spy(jccs, "ccso_search_frame", "jax")
    spy(jlrs, "lr_search_frame", "jax")
    yield got


def run_config(name):
    make, q, fields, wiener = CONFIGS[name]
    frames = make()
    with pytest.MonkeyPatch.context() as mp, spies(mp) as got, one_thread():
        if wiener:
            for mod in (jlrs, tlrs):
                mp.setattr(mod, "SGR_BITS", 1e12)      # SGR never picked
                mp.setattr(mod, "WIENER_BITS", 0.0)
        tenc = tie.IntraEncoder(tie.EncoderConfig(W, H, qindex=q, **fields),
                                device="cpu")
        dev = tenc.device_encode(frames)
        tpay, trec = tenc.host_finish(dev)
        jdev = tuple(np.asarray(a) if torch.is_tensor(a) else a for a in dev)
        jenc = jie.IntraEncoder(jie.EncoderConfig(W, H, qindex=q, **fields))
        jpay, jrec = jenc._host_finish_part(jdev)
    return dict(frames=frames, dev=dev, tpay=tpay, trec=trec, jpay=jpay,
                jrec=jrec, got=got)


@pytest.fixture(scope="module")
def runs():
    return {name: run_config(name) for name in CONFIGS}


def decisions(run, side, search):
    return [out for name, out in run["got"][side] if name == search]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_payloads_match_jax(runs, name):
    r = runs[name]
    assert len(r["tpay"]) == 2
    assert r["tpay"] == r["jpay"]
    for p in r["tpay"]:
        assert any(t == OBU_FRAME and len(d) for t, _, _, d in parse_obus(p))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_filtered_recons_match_jax(runs, name):
    r = runs[name]
    for b, (got, want) in enumerate(zip(r["trec"], r["jrec"])):
        for p in range(3):
            np.testing.assert_array_equal(got[p], np.asarray(want[p]),
                                          err_msg=f"frame {b} plane {p}")


@pytest.mark.parametrize("name", ["all", "wiener", "sb64"])
def test_cdef_params_match_jax(runs, name):
    got = decisions(runs[name], "port", "cdef_search_frame")
    want = decisions(runs[name], "jax", "cdef_search_frame")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        key = lambda d: {k: v for k, v in d.items() if k != "idx_map"}
        assert key(g) == key(w)
        np.testing.assert_array_equal(g["idx_map"], w["idx_map"])


def _same_info(g, w):
    if g is None or w is None:
        return g is w
    for pg, pw in zip(g["planes"], w["planes"]):
        if (pg is None) != (pw is None):
            return False
        if pg is not None and not all(
                np.array_equal(pg[k], pw[k]) for k in pw):
            return False
    return True


@pytest.mark.parametrize("name", ["all", "ccso_lr", "wiener"])
def test_ccso_info_matches_jax(runs, name):
    got = decisions(runs[name], "port", "ccso_search_frame")
    want = decisions(runs[name], "jax", "ccso_search_frame")
    assert len(got) == len(want) == 2
    for b, (g, w) in enumerate(zip(got, want)):
        assert _same_info(g, w), f"frame {b}"


def lr_differences(got, want):
    """Units whose fields differ, named by frame, plane and unit, with
    both values (a float32 RD tie in the JAX search shows here)."""
    out = []
    for b, ((gt, gu), (wt, wu)) in enumerate(zip(got, want)):
        if tuple(gt) != tuple(wt):
            out.append(f"frame {b}: frame types {gt} != {wt}")
        for p, (g, w) in enumerate(zip(gu, wu)):
            if (g is None) != (w is None):
                out.append(f"frame {b} plane {p}: {g is None} / {w is None}")
                continue
            if g is None:
                continue
            for k in w:
                bad = np.argwhere(np.asarray(g[k]) != np.asarray(w[k]))
                for ur, uc in {tuple(i[:2]) for i in bad}:
                    out.append(f"frame {b} plane {p} unit ({ur}, {uc}) {k}: "
                               f"{g[k][ur, uc]} != {w[k][ur, uc]}")
    return out


@pytest.mark.parametrize("name", ["all", "ccso_lr", "lr", "wiener"])
def test_lr_units_match_jax(runs, name):
    got = decisions(runs[name], "port", "lr_search_frame")
    want = decisions(runs[name], "jax", "lr_search_frame")
    assert len(got) == len(want) == 2
    diff = lr_differences(got, want)
    assert not diff, "\n".join(diff)


def test_every_tool_fires(runs):
    """The JAX runs take every decision of the filter stage."""
    cdef = decisions(runs["all"], "jax", "cdef_search_frame")
    assert any(p != (0, 0) for c in cdef for p in c["y_strengths"] +
               c["uv_strengths"]), "no nonzero CDEF strength"
    assert any(c["bits"] > 0 for c in cdef), "one CDEF strength set only"
    lr = decisions(runs["all"], "jax", "lr_search_frame")
    units = [u["type"] for _, us in lr for u in us if u is not None]
    assert any((t == 2).any() for t in units), "no SGR unit"
    assert any(lr_t[0] for lr_t, _ in lr), "no luma LR"
    wl = decisions(runs["wiener"], "jax", "lr_search_frame")
    assert any((u["type"] == 1).any() for _, us in wl for u in us
               if u is not None), "no Wiener unit"
    for name in ("all", "ccso_lr"):
        ccso = decisions(runs[name], "jax", "ccso_search_frame")
        assert any(i is not None and any(p is not None for p in i["planes"])
                   for i in ccso), f"{name}: CCSO off in every plane"
    # the filters ran on all three partition depths
    part, part_sb = runs["all"]["dev"][2].numpy(), runs["all"]["dev"][16]
    part_sb = part_sb.numpy()
    assert (part_sb == 0).any(), "no 64x64 SB NONE"
    split = np.repeat(np.repeat(part_sb, 2, 1), 2, 2) == 1
    assert (part[split] == 0).any() and (part[split] == 1).any()
    # a CDEF literal coded at a 64x64 block: a coded SB NONE in a frame
    # with 2 strength sets
    r = runs["sb64"]
    sets = [c["bits"] for c in decisions(r, "jax", "cdef_search_frame")]
    psb, lev = r["dev"][16].numpy(), r["dev"][18].numpy()
    assert any(bits > 0 and (psb[b] == 0).any() and
               lev[b][psb[b] == 0].any() for b, bits in enumerate(sets))


# ---- the CLI -----------------------------------------------------------

def _write_y4m(path, frames, w, h):
    with open(path, "wb") as f:
        wtr = Y4mWriter(f, Y4mInfo(w, h, 30, 1))
        for fr in frames:
            wtr.write_frame(*fr)


def _read_payloads(path):
    with open(path, "rb") as f:
        _, frames = read_ivf(f)
        return [p for p, _ in frames]


@pytest.mark.parametrize("extra,fields", [
    (["--preset", "8"], dict(enable_cdef=True)),
    (["--preset", "9", "--lr"], dict(enable_cdef=True, enable_lr=True,
                                     tx_search=False)),
    (["--cdef", "--ccso"], dict(enable_cdef=True, enable_ccso=True))])
def test_cli_filter_modes(tmp_path, extra, fields):
    """The CLI's filter modes at 128x64 on the CPU give the payloads of
    the same configuration through the encoder API."""
    frames = mixed_frames()
    src, out = tmp_path / "in.y4m", tmp_path / "out.ivf"
    _write_y4m(src, frames, W, H)
    with one_thread():
        rc = app.main(["-i", str(src), "-b", str(out), "--keyint", "1",
                       "--device", "cpu", *extra])
        enc = tie.IntraEncoder(tie.EncoderConfig(W, H, **fields),
                               device="cpu")
        want, _ = enc.encode_frames(frames)
    assert rc == 0
    assert _read_payloads(out) == want


def test_cli_rejects_filters_at_1080_rows(tmp_path, capsys):
    """Like the JAX package, the filters need a height that is a multiple
    of 64: a 1080-row input with --preset 8 exits 2 with its message."""
    src = tmp_path / "in.y4m"
    z = np.zeros((1080, 1920), np.uint8)
    c = np.zeros((540, 960), np.uint8)
    _write_y4m(src, [(z, c, c)], 1920, 1080)
    rc = app.main(["-i", str(src), "-b", str(tmp_path / "o.ivf"),
                   "--keyint", "1", "--device", "cpu", "--preset", "8"])
    assert rc == 2
    with pytest.raises(ValueError) as e:
        jgeo.check_dims(1920, 1080, True, inloop_extras=True)
    assert f"error: {e.value}" in capsys.readouterr().err


@pytest.mark.parametrize("preset", range(6))
def test_cli_rejects_angle_delta_presets(tmp_path, preset):
    """Presets 0-5 (angle deltas, CDEF, the tx-type search) exited 2 until
    the port had angle deltas; the CLI now runs them and writes the
    payload of the preset's configuration through the encoder API
    (the JAX encoder's bytes at presets 1 and 4:
    tests/test_torch_angle_deltas.py)."""
    frames = mixed_frames()[:1]
    src, out = tmp_path / "in.y4m", tmp_path / "o.ivf"
    _write_y4m(src, frames, W, H)
    with one_thread():
        rc = app.main(["-i", str(src), "-b", str(out), "--keyint", "1",
                       "--device", "cpu", "--preset", str(preset)])
        enc = tie.IntraEncoder(apply_preset(tie.EncoderConfig(W, H), preset),
                               device="cpu")
        want, _ = enc.encode_frames(frames)
    assert rc == 0
    assert _read_payloads(out) == want
