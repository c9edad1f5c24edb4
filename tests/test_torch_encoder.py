"""The port's IntraEncoder and CLI against the JAX package (CPU).

Payloads must be byte-identical to the JAX flat path whenever every block
picks the same candidate (asserted first), and the JAX package's own
decoder must reproduce the port's reconstruction exactly.  The CLI's HDR
metadata flags write the JAX CLI's bytes.
"""

import subprocess
import sys
import textwrap
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from svtav1_tpu.decoder.decoder import Decoder
from svtav1_tpu.encoder import intra_encoder as jie
from svtav1_tpu.utils.ivf import read_ivf
from svtav1_tpu.utils.y4m import Y4mInfo, Y4mWriter
from svtav1_tpu_torch import app
from svtav1_tpu_torch.encoder import intra_encoder as tie
from svtav1_tpu_torch.encoder.presets import verify_settings
from svtav1_tpu_torch.encoder import video_encoder as tve

ROOT = Path(__file__).resolve().parent.parent


def _synth(w, h, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(100 + 50 * np.sin(xx / 17.0) + 40 * np.cos(yy / 23.0) +
                rng.randint(-6, 7, (h, w)), 0, 255).astype(np.uint8)
    u = np.clip(120 + 30 * np.sin(xx[::2, ::2] / 31.0), 0,
                255).astype(np.uint8)
    v = np.clip(130 + 25 * np.cos(yy[::2, ::2] / 29.0), 0,
                255).astype(np.uint8)
    return y, u, v


@pytest.fixture(scope="module", params=[(128, 64), (128, 56)],
                ids=["128x64", "128x56_valid_h"])
def both(request):
    """Two frames through the JAX flat path and through the port."""
    w, h = request.param
    frames = [_synth(w, h, i) for i in range(2)]
    jenc = jie.IntraEncoder(jie.EncoderConfig(w, h, qindex=100,
                                              part_search=False))
    jdev = jenc.device_encode(frames)
    jpay, _ = jenc.host_finish(jdev)
    tenc = tie.IntraEncoder(tie.EncoderConfig(w, h, qindex=100,
                                              part_search=False),
                            device="cpu")
    tdev = tenc.device_encode(frames)
    tpay, trec = tenc.host_finish(tdev)
    return dict(frames=frames, jdev=jdev, jpay=jpay, tdev=tdev, tpay=tpay,
                trec=trec, h=h)


def test_payloads_match_jax(both):
    for k in ("y_mi", "uv_mi"):
        np.testing.assert_array_equal(both["tdev"][k].numpy(),
                                      np.asarray(both["jdev"][k]), err_msg=k)
    assert both["tpay"] == both["jpay"]
    assert all(len(p) > 100 for p in both["tpay"])


def test_own_decoder_roundtrip(both):
    dec = Decoder()
    for payload, rec in zip(both["tpay"], both["trec"]):
        out = dec.decode_frame_obus(payload)
        dy, du, dv = out[0] if isinstance(out, list) else out
        assert rec[0].shape == (both["h"], 128)
        for got, want in zip((dy, du, dv), rec):
            np.testing.assert_array_equal(np.asarray(got), want)


_BLOCK_JAX = textwrap.dedent("""
    import sys
    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError("jax is blocked: " + name)
    sys.meta_path.insert(0, _NoJax())
    import numpy as np
    from svtav1_tpu_torch.encoder.intra_encoder import (EncoderConfig,
                                                        IntraEncoder)
    from svtav1_tpu_torch.app import main
    rng = np.random.RandomState(0)
    y = rng.randint(0, 256, (64, 128)).astype(np.uint8)
    u = rng.randint(0, 256, (32, 64)).astype(np.uint8)
    enc = IntraEncoder(EncoderConfig(128, 64, part_search=False),
                       device="cpu")
    payload, rec = enc.encode_frame(y, u, u.copy())
    assert len(payload) > 100
    assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
    print("NOJAX_OK")
""")


def test_port_runs_without_jax():
    r = subprocess.run([sys.executable, "-c", _BLOCK_JAX], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "NOJAX_OK" in r.stdout


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tie.IntraEncoder(tie.EncoderConfig(128, 64, part_search=False))


@pytest.mark.parametrize("change", [
    {"part_search": True, "tile_cols": 2}, {"bit_depth": 10},
    {"angle_deltas": (-2, 0, 2)},
    {"tile_cols": 2}, {"enable_cdef": True}, {"enable_lr": True},
    {"enable_ccso": True}])
def test_outside_the_slice_raises(change):
    cfg = replace(tie.EncoderConfig(128, 64, part_search=False), **change)
    if cfg.bit_depth == 10:
        # ported: 10-bit takes every path (tests/test_torch_10bit_*.py);
        # other depths raise as the JAX package's verify_settings does
        assert tie.IntraEncoder(cfg, device="cpu").seq.bit_depth == 10
        with pytest.raises(ValueError, match="bit_depth must be 8 or 10"):
            tie.IntraEncoder(replace(cfg, bit_depth=12), device="cpu")
        return
    if cfg.angle_deltas != (0,):
        # ported: the flat path takes angle deltas
        # (tests/test_torch_angle_deltas.py); out-of-range deltas fail
        # verify_settings, as in the JAX package
        assert tie.IntraEncoder(cfg, device="cpu").cfg.angle_deltas == \
            (-2, 0, 2)
        with pytest.raises(ValueError, match="angle delta out of range"):
            verify_settings(replace(cfg, angle_deltas=(-4, 0)))
        return
    if cfg.tile_cols > 1:
        # ported: tile columns on the partition path
        # (tests/test_torch_tiles.py); the flat path with tiles raises the
        # JAX encoder's error and message
        if cfg.part_search:
            assert tie.IntraEncoder(cfg, device="cpu").cfg.tile_cols == 2
            cfg = replace(cfg, part_search=False)
        with pytest.raises(NotImplementedError) as want:
            jie.IntraEncoder(jie.EncoderConfig(128, 64, part_search=False,
                                               tile_cols=2))
        with pytest.raises(NotImplementedError) as got:
            tie.IntraEncoder(cfg, device="cpu")
        assert str(got.value) == str(want.value)
        return
    # the in-loop filters ride the partition path, in the JAX package too
    with pytest.raises(NotImplementedError, match="partition coding path"):
        tie.IntraEncoder(cfg, device="cpu")


def test_flat_heights_checked_like_jax():
    with pytest.raises(ValueError, match="16x8"):
        tie.IntraEncoder(tie.EncoderConfig(128, 72, part_search=False),
                         device="cpu")


def _write_y4m(path, w, h, n):
    with open(path, "wb") as f:
        wtr = Y4mWriter(f, Y4mInfo(w, h, 30, 1))
        for i in range(n):
            wtr.write_frame(*_synth(w, h, 10 + i))


def test_cli_preset12_writes_decodable_ivf(tmp_path, capsys):
    src, out = tmp_path / "in.y4m", tmp_path / "out.ivf"
    _write_y4m(src, 128, 64, 3)
    rc = app.main(["-i", str(src), "-b", str(out), "-q", "100", "--keyint",
                   "1", "--preset", "12", "--batch", "2", "--stat-report",
                   "--device", "cpu"])
    assert rc == 0
    assert "PSNR Y" in capsys.readouterr().out
    with open(out, "rb") as f:
        _, frames = read_ivf(f)
        payloads = [p for p, _ in frames]
    assert len(payloads) == 3
    dec = Decoder()
    for p in payloads:
        assert dec.decode_frame_obus(p)


def test_cli_flat_p_path_writes_the_encoders_payloads(tmp_path):
    """--keyint 64 --no-part-search encodes (I, P, P): the IVF holds the
    port's VideoEncoder's payloads, and the JAX Decoder decodes them."""
    src, out = tmp_path / "in.y4m", tmp_path / "out.ivf"
    _write_y4m(src, 128, 64, 3)
    rc = app.main(["-i", str(src), "-b", str(out), "-q", "100", "--keyint",
                   "64", "--no-part-search", "--device", "cpu"])
    assert rc == 0
    with open(out, "rb") as f:
        _, frames = read_ivf(f)
        payloads = [p for p, _ in frames]
    enc = tve.VideoEncoder(tie.EncoderConfig(128, 64, qindex=100,
                                             part_search=False),
                           keyint=64, device="cpu")
    want, _ = enc.encode_frames([_synth(128, 64, 10 + i) for i in range(3)])
    assert payloads == want
    dec = Decoder()
    for p in payloads:
        assert dec.decode_frame_obus(p)


@pytest.mark.parametrize("extra", [
    ["--keyint", "1", "--cdef", "--no-part-search"],
    ["--keyint", "1", "--preset", "5", "--no-part-search"]])
def test_cli_rejects_other_modes(tmp_path, extra):
    src = tmp_path / "in.y4m"
    _write_y4m(src, 128, 64, 1)
    rc = app.main(["-i", str(src), "-b", str(tmp_path / "o.ivf"),
                   "--device", "cpu", *extra])
    assert rc == 2


MD = "G(0.265,0.69)B(0.15,0.06)R(0.68,0.32)WP(0.3127,0.329)L(1000,0.01)"


def test_cli_metadata_matches_jax(tmp_path):
    """--mastering-display and --content-light: the port's CLI writes the
    JAX CLI's IVF bytes (the flat path at 128x64: the JAX side hits the
    `both` fixture's compiled calls), and the port's decoder returns the
    metadata the JAX Decoder returns."""
    from svtav1_tpu import app as japp
    from svtav1_tpu_torch.decoder.decoder import Decoder as TDecoder
    src = tmp_path / "in.y4m"
    _write_y4m(src, 128, 64, 2)
    args = ["-i", str(src), "-q", "100", "--keyint", "1",
            "--no-part-search", "--mastering-display", MD,
            "--content-light", "1000,400"]
    jout, tout = tmp_path / "j.ivf", tmp_path / "t.ivf"
    assert japp.main(args + ["-b", str(jout)]) == 0
    assert app.main(args + ["-b", str(tout), "--device", "cpu"]) == 0
    assert tout.read_bytes() == jout.read_bytes()
    tdec, jdec = TDecoder(device="cpu"), Decoder()
    with open(tout, "rb") as f:
        for p, _ in read_ivf(f)[1]:
            for a, b in zip(tdec.decode_frame_obus(p),
                            jdec.decode_frame_obus(p)):
                np.testing.assert_array_equal(a, b)
    assert [m[0] for m in tdec.metadata] == [2, 1]
    assert [(t, vars(v)) for t, v in tdec.metadata] == \
        [(t, vars(v)) for t, v in jdec.metadata]


@pytest.mark.parametrize("flag", [["--content-light", "1000"],
                                  ["--mastering-display", "G(1,2)"]])
def test_cli_bad_metadata_exits_2(tmp_path, flag, capsys):
    src = tmp_path / "in.y4m"
    _write_y4m(src, 128, 64, 1)
    rc = app.main(["-i", str(src), "-b", str(tmp_path / "o.ivf"),
                   "--device", "cpu"] + flag)
    assert rc == 2
    assert capsys.readouterr().err.startswith("error: ")
