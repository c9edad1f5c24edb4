"""Write the JAX side of ``tests/test_torch_part_pyramid.py`` (the
compound partition pyramid at 128x64, q100):

    JAX_PLATFORMS=cpu python tests/data/torch_part_pyramid/make_fixtures.py

Run by hand from the repo root (~10 min on a CPU, most of it the JAX
anchor and compound scans' compile).

- ``runs.npz``: for each case of the test's CASES (by index c), the JAX
  VideoEncoder's pyramid after the port's key frame: its state set to
  what the port's ``_drain`` leaves after a key frame (slot 0 the port's
  key-frame recon as int32 planes, display index 0, anchor slot 0, the
  scene-cut state), its rate controller having counted the key frame's
  bytes, and with --tf its ``_tf_filter`` returning the port's filtered
  planes of the anchors.  Kept: its payloads and recons after the key
  frame, and for each coded frame the dumped maps (``SVT_DUMP_DIR``), q,
  DLF level, compound flag and its ``_encode_p`` arguments lam_scale and
  lam_map; ``c_state_md5`` is the test's ``state_md5`` of the port's key
  frame and filtered planes that the JAX side started from.
- ``scans.npz``: JAX's ``encode_plane_wavefront_part`` on the inputs of
  each of the test's SCAN_CASES (``_scan_inputs``): every output.
"""

import os
import pickle
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from svtav1_tpu.encoder import intra_encoder as jie  # noqa: E402
from svtav1_tpu.encoder import rate_control as jrc  # noqa: E402
from svtav1_tpu.encoder import video_encoder as jve  # noqa: E402
from svtav1_tpu.encoder import wavefront2 as jw2  # noqa: E402
from svtav1_tpu.spec import txfm as jT  # noqa: E402
from svtav1_tpu_torch.cuda.inputs import moving_frames  # noqa: E402
import test_torch_part_pyramid as tpp  # noqa: E402

W, H, Q = tpp.W, tpp.H, tpp.Q


def jax_after_key(frames, gop, tf, mode, port, dump):
    """The JAX pyramid after the port's key frame: (payloads and recons
    after the key frame, coded-frame records)."""
    rc = tpp._rc(jrc, mode)
    cfg = jie.EncoderConfig(W, H, qindex=Q)
    jenc = jve.VideoEncoder(cfg, keyint=64, pyramid=True, gop=gop, tf=tf,
                            rc=rc)
    key_payload, key_rec = port["key"]
    # int32 planes, as JAX's P frames leave its slots (one ME signature)
    jenc._slots = {0: tuple(np.asarray(p, np.int32) for p in key_rec)}
    jenc._slot_cdf, jenc._slot_t, jenc._slot_gm = {}, {0: 0}, {}
    jenc._anchor_slot, jenc._idx, jenc._kf_at = 0, 1, 64
    jenc._tail_src = np.asarray(frames[0][0], np.int32)[::4, ::4]
    jenc._sad_hist = [0.0]
    if rc is not None:
        rc.update(len(key_payload), 1)
    args = []
    code = jenc._encode_p

    def spy_code(*a, lam_scale=1.0, lam_map=None, **kw):
        args.append(dict(lam_scale=lam_scale, lam_map=lam_map))
        return code(*a, lam_scale=lam_scale, lam_map=lam_map, **kw)

    anchors = iter(port["filtered"][1:])
    jenc._encode_p = spy_code
    jenc._tf_filter = lambda *a: next(anchors)
    saved = os.environ.get("SVT_DUMP_DIR")
    os.environ["SVT_DUMP_DIR"] = str(dump)
    try:
        p1, r1 = jenc.encode_frames(frames[1:])
        p2, r2 = jenc.flush()
    finally:
        if saved is None:
            del os.environ["SVT_DUMP_DIR"]
        else:
            os.environ["SVT_DUMP_DIR"] = saved
    coded = []
    for k, a in enumerate(args):
        with open(dump / f"pframe_{k:03d}.pkl", "rb") as f:
            d = pickle.load(f)
        coded.append(dict({m: d[m][0] for m in tpp.MAPS}, q=d["q"],
                          lf=d["lf"], comp=d["comp"], **a))
    return p1 + p2, r1 + r2, coded


def make_runs():
    out = {}
    for c, (label, (n, gop, tf, mode)) in enumerate(tpp.CASES.items()):
        frames = moving_frames(W, H, n)
        port = tpp._port_run(frames, gop, tf, mode)
        with tempfile.TemporaryDirectory() as d:
            payloads, recons, coded = jax_after_key(frames, gop, tf, mode,
                                                    port, Path(d))
        out[f"{c}_state_md5"] = np.asarray(tpp.state_md5(
            port["key"][0], port["filtered"][1:]))
        out[f"{c}_counts"] = np.asarray([len(payloads), len(recons),
                                         len(coded)])
        for i, p in enumerate(payloads):
            out[f"{c}_pay_{i}"] = np.frombuffer(p, np.uint8)
        for i, r in enumerate(recons):
            for p in range(3):
                out[f"{c}_rec_{i}_{p}"] = np.asarray(r[p])
        for k, rec in enumerate(coded):
            for f, v in rec.items():
                if v is not None:
                    out[f"{c}_coded_{k}_{f}"] = np.asarray(v)
        print(label, len(payloads), "payloads", len(coded), "coded",
              flush=True)
    np.savez_compressed(HERE / "runs.npz", **out)


def make_scans():
    out = {}
    for c, (form, n, scale) in enumerate(tpp.SCAN_CASES):
        src, bs, lanes, fp, fsb, lmap = tpp._scan_inputs(form, n, scale)
        (top, r_t, ok_t, sub, r_s, ok_s, sb, r_b, ok_b, i_t, i_s, i_b) = \
            (jnp.asarray(a) for a in lanes)
        if form == "chroma":
            want = jw2.encode_plane_wavefront_part(
                jnp.asarray(src), 16, jT.TX_16X16, jT.TX_8X8, Q, top, r_t,
                sub, r_s, ok_t, ok_s, i_t, i_s, jnp.asarray(fp), 1,
                jw2.CHROMA_TOP_MODES, jw2.CHROMA_SUB_MODES, 8, (0,), False,
                False, scale, sb_search=True, tx_sb=jT.TX_32X32,
                extra_sb=sb, extra_rate_sb=r_b, extra_ok_sb=ok_b,
                intra_ok_sb=i_b, force_sb=jnp.asarray(fsb), valid_h=None,
                paired=True, uv_rates=True, modes_sbl=jw2.CHROMA_SB_MODES,
                uv_tx=True, lam_map=jnp.asarray(lmap))
        else:
            want = jw2.encode_plane_wavefront_part(
                jnp.asarray(src), 32, jT.TX_32X32, jT.TX_16X16, Q, top, r_t,
                sub, r_s, ok_t, ok_s, i_t, i_s, jnp.asarray(fp), n,
                jie.CAND_MODES, jw2.SUB_MODES, 8, (0,), False, True, scale,
                sb_search=True, tx_sb=jT.TX_64X64, extra_sb=sb,
                extra_rate_sb=r_b, extra_ok_sb=ok_b, intra_ok_sb=i_b,
                force_sb=jnp.asarray(fsb), valid_h=None,
                lam_map=jnp.asarray(lmap))
        out[f"{c}_n"] = np.asarray(len(want))
        for k, a in enumerate(want):
            out[f"{c}_{k}"] = np.asarray(a)
        print(form, n, scale, len(want), "outputs", flush=True)
    np.savez_compressed(HERE / "scans.npz", **out)


if __name__ == "__main__":
    make_runs()
    make_scans()
