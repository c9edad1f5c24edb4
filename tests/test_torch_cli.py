"""The port's CLI flags and helpers that the JAX CLI has: ``--mbr`` (capped
CRF), SSIM in ``--stat-report`` and the leveled log (``utils/log.py``),
against the JAX package on the CPU, with no JAX scan compiled.

- The JAX CLI's fixtures (``tests/data/torch_tiles/cli_*``, written by its
  ``make_streams.py``): ``--keyint 1 --mbr K --stat-report`` on the flat
  path (``--preset 12``) and on the default partition path, and
  ``--stat-report`` of a 10-bit clip.  The port's CLI on the same Y4M
  writes the JAX CLI's IVF bytes, its PSNR and SSIM lines, its frame
  count and bitrate (the timing aside) and its log line (the time
  aside).
- ``--mbr`` at ``--keyint`` > 1 exits 2 with the JAX CLI's message (both
  CLIs run here: the check comes before any encode).
- ``ops.metrics.ssim_plane`` against JAX's on seeded planes at 8 and 10
  bits, planes smaller than a window included.
- ``utils.log``: the levels, ``SVT_LOG`` parsing (numbers, names,
  out-of-range and bad values), the threshold and the line format of
  JAX's module, the time field masked.
- ``IntraEncoder.cap_bits`` through the API: every frame over the cap is
  coded again at a higher qindex, as the CLI's fixtures show.
"""

import importlib
import io
import json
import re
from contextlib import redirect_stderr
from pathlib import Path

import numpy as np
import pytest
import torch

from svtav1_tpu import app as japp
from svtav1_tpu.ops import metrics as jmetrics
from svtav1_tpu.utils import log as jlog
from svtav1_tpu_torch import app
from svtav1_tpu_torch.cuda import inputs
from svtav1_tpu_torch.encoder.intra_encoder import EncoderConfig, IntraEncoder
from svtav1_tpu_torch.encoder.presets import apply_preset
from svtav1_tpu_torch.ops import metrics as tmetrics
from svtav1_tpu_torch.utils import log as tlog
from svtav1_tpu_torch.utils.ivf import read_ivf
from svtav1_tpu_torch.utils.obu import OBU_SEQUENCE_HEADER, parse_obus
from svtav1_tpu_torch.utils.y4m import Y4mInfo, Y4mWriter

ROOT = Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "data" / "torch_tiles"
MD5 = json.loads((FIX / "md5.json").read_text())
CLI = sorted(k for k, e in MD5.items() if e["encoder"] == "cli")
# "encoded 2 frames in 12.77s (0.16 fps), 196.4 kbps": the times masked
TIMING = re.compile(r"in [0-9.]+s \([0-9.]+ fps\)")
# "Svt[info]   21.502s app: ...": the seconds since import masked
LOGTIME = re.compile(r"^(Svt\[[a-z?]+\]) +[0-9.]+s ")


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU ops on one thread: the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _y4m(path, frames, w, h, bd=8):
    with open(path, "wb") as f:
        wtr = Y4mWriter(f, Y4mInfo(w, h, 30, 1, bit_depth=bd))
        for fr in frames:
            wtr.write_frame(*fr)


def _ivf(path):
    with open(path, "rb") as f:
        return [p for p, _ in read_ivf(f)[1]]


def _masked_out(lines):
    return [TIMING.sub("in _s (_ fps)", line) for line in lines]


def _masked_log(lines):
    """The log lines (other stderr lines, such as the JAX package's own
    warnings, dropped), their time fields masked."""
    return [LOGTIME.sub(r"\1 _s ", line) for line in lines
            if line.startswith("Svt[")]


def _fixture_args(entry, src, out):
    c = entry["config"]
    args = ["-i", str(src), "-b", str(out)] + c["args"]
    if entry["mbr"]:
        args += ["--mbr", str(entry["mbr"])]
    return args


def test_cli_fixtures_cover_the_flags():
    """The --mbr fixtures re-encoded every frame under the cap (their sizes
    moved from the uncapped ones); each entry printed the stat lines."""
    assert {"cli_mbr_flat", "cli_mbr_part", "cli_stat10"} <= set(CLI)
    for name in CLI:
        e = MD5[name]
        assert [s[:4] for s in e["stdout"][1:]] == ["PSNR", "SSIM"]
        if e["mbr"]:
            assert e["recoded"] > 0 and e["sizes"] != e["plain_sizes"]
            cap = e["mbr"] * 1000 // 30
            assert all(8 * s <= cap for s in e["sizes"]), (e["sizes"], cap)


@pytest.mark.parametrize("name", CLI)
def test_cli_matches_jax_cli(name, tmp_path, capsys):
    """The port's CLI on the fixture's Y4M and arguments: the JAX CLI's IVF
    bytes, stdout (the timing aside) and log line (the time aside)."""
    e = MD5[name]
    c, s = e["config"], e["source"]
    frames = getattr(inputs, s["kind"])(c["width"], c["height"], s["n"],
                                        seed=s["seed"])
    src, out = tmp_path / "in.y4m", tmp_path / "out.ivf"
    _y4m(src, frames, c["width"], c["height"], c["bit_depth"])
    capsys.readouterr()
    assert app.main(_fixture_args(e, src, out) + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert _ivf(out) == _ivf(FIX / f"{name}.ivf")
    assert _masked_out(got.out.splitlines()) == _masked_out(e["stdout"])
    assert _masked_log(got.err.splitlines()) == _masked_log(e["stderr"])
    assert len(_masked_log(got.err.splitlines())) == 1


@pytest.mark.parametrize("keyint", ["64", "2"])
def test_cli_mbr_needs_all_intra(keyint, tmp_path, capsys):
    """--mbr at --keyint > 1: exit 2 with the JAX CLI's message, after its
    log line."""
    src = tmp_path / "in.y4m"
    _y4m(src, inputs.moving_frames(128, 64, 1), 128, 64)
    args = ["-i", str(src), "-b", str(tmp_path / "o.ivf"), "--keyint",
            keyint, "--mbr", "300"]
    capsys.readouterr()
    assert japp.main(args) == 2
    want = capsys.readouterr().err.splitlines()
    assert app.main(args + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err.splitlines()
    assert got[-1] == want[-1] == ("error: --mbr (capped CRF) is supported "
                                   "for the all-intra path (--keyint 1)")
    assert _masked_log(got) == _masked_log(want)


@pytest.mark.parametrize("preset", [12, None])
def test_cap_bits_api(preset):
    """IntraEncoder.cap_bits: each frame over the cap is coded again at a
    higher qindex (under the cap here); the first keeps its sequence
    header; a cap every frame meets changes nothing."""
    frames = inputs.moving_frames(128, 64, 2)
    cfg = EncoderConfig(128, 64, qindex=100)
    if preset is not None:
        cfg = apply_preset(cfg, preset)
    plain, _ = IntraEncoder(cfg, device="cpu").encode_frames(frames)
    enc = IntraEncoder(cfg, device="cpu")
    enc.cap_bits = int(0.7 * 8 * max(map(len, plain)))
    capped, recons = enc.encode_frames(frames)
    assert all(8 * len(p) <= enc.cap_bits for p in capped)
    for a, b in zip(capped, plain):
        assert a == b if 8 * len(b) <= enc.cap_bits else len(a) < len(b)
    assert capped != plain
    # the first frame keeps the sequence header, the second has none
    kinds = [[t for t, *_ in parse_obus(p)] for p in capped]
    assert OBU_SEQUENCE_HEADER in kinds[0]
    assert OBU_SEQUENCE_HEADER not in kinds[1]
    enc = IntraEncoder(cfg, device="cpu")
    enc.cap_bits = 8 * max(map(len, plain))
    assert enc.encode_frames(frames)[0] == plain
    assert len(recons) == 2 and recons[0][0].shape == (64, 128)


# ------------------------------------------------------------------ #
# SSIM

@pytest.mark.parametrize("shape", [(64, 128), (37, 53), (8, 8), (7, 40),
                                   (40, 5), (1, 1)])
@pytest.mark.parametrize("bd", [8, 10])
def test_ssim_plane(shape, bd):
    """ssim_plane against JAX's on seeded planes: a noisy copy, an
    identical copy and an unrelated plane, at the bit depth's peak."""
    rng = np.random.RandomState(shape[0] * 100 + shape[1] + bd)
    peak = (1 << bd) - 1
    dt = np.uint8 if bd == 8 else np.uint16
    a = rng.randint(0, peak + 1, shape).astype(dt)
    noisy = np.clip(a.astype(np.int64) + rng.randint(-9, 10, shape), 0,
                    peak).astype(dt)
    other = rng.randint(0, peak + 1, shape).astype(dt)
    for b in (noisy, a.copy(), other):
        got = tmetrics.ssim_plane(a, b, peak)
        assert got == jmetrics.ssim_plane(a, b, peak)
        assert isinstance(got, float)
    assert tmetrics.ssim_plane(a, a, peak) == pytest.approx(1.0)


# ------------------------------------------------------------------ #
# the leveled log

SVT_LOG = ["", "0", "1", "2", "3", "4", "debug", "INFO", " warn ", "error",
           "fatal", "9", "-2", "loud"]


def _reload(mod, monkeypatch, value):
    monkeypatch.setenv("SVT_LOG", value)
    return importlib.reload(mod)


@pytest.mark.parametrize("value", SVT_LOG)
def test_log_threshold(value, monkeypatch):
    """SVT_LOG picks the same threshold in both modules (numbers clamp to
    debug..fatal, names in any case, anything else is info)."""
    try:
        t, j = (_reload(m, monkeypatch, value) for m in (tlog, jlog))
        assert t.get_level() == j.get_level() == t._threshold()
        assert (t.DEBUG, t.INFO, t.WARN, t.ERROR, t.FATAL) == \
            (j.DEBUG, j.INFO, j.WARN, j.ERROR, j.FATAL)
        assert t._NAMES == j._NAMES
    finally:
        monkeypatch.undo()
        for m in (tlog, jlog):
            importlib.reload(m)


@pytest.mark.parametrize("level", range(5))
def test_log_lines(level):
    """At each threshold, the same calls print the same lines (the time
    field masked): the levels below it print nothing; printf-style args."""
    lines = {}
    for name, mod in (("port", tlog), ("jax", jlog)):
        old = mod.get_level()
        buf = io.StringIO()
        try:
            mod.set_level(level)
            with redirect_stderr(buf):
                mod.debug("enc", "frame %d", 3)
                mod.info("app", "%dx%d bd=%d", 128, 64, 8)
                mod.warn("rc", "no args %s")
                mod.error("dec", "bad %s at %d", "obu", 7)
                mod.log(mod.FATAL, "x", "fatal %.2f", 1.5)
                mod.log(7, "y", "unknown level")
        finally:
            mod.set_level(old)
        lines[name] = buf.getvalue().splitlines()
    assert _masked_log(lines["port"]) == _masked_log(lines["jax"])
    assert len(lines["port"]) == 6 - level
    assert all(LOGTIME.match(line) for line in lines["port"])


def test_cli_logs_like_jax(tmp_path, capsys):
    """The CLI's one log line at the default level, and none under
    SVT_LOG=warn, as the JAX CLI (both stop at an invalid -q first)."""
    src = tmp_path / "in.y4m"
    _y4m(src, inputs.moving_frames(128, 64, 1), 128, 64)
    args = ["-i", str(src), "-b", str(tmp_path / "o.ivf"), "--keyint", "2",
            "--mbr", "1"]
    for mods_level in (tlog.INFO, tlog.WARN):
        old = (tlog.get_level(), jlog.get_level())
        try:
            tlog.set_level(mods_level)
            jlog.set_level(mods_level)
            capsys.readouterr()
            assert japp.main(args) == 2
            want = capsys.readouterr().err.splitlines()
            assert app.main(args + ["--device", "cpu"]) == 2
            got = capsys.readouterr().err.splitlines()
        finally:
            tlog.set_level(old[0])
            jlog.set_level(old[1])
        assert _masked_log(got) == _masked_log(want)
        assert len(_masked_log(got)) == (mods_level == tlog.INFO)
