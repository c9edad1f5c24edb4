"""The port stands on its own: no module of ``svtav1_tpu_torch`` and not
``chip_smoke.py`` imports JAX, the JAX package or its benchmark, and the
port encodes with all three blocked, on the flat and on the partition
path, with the in-loop filters on, on the low-delay inter path (a key
frame and a P frame, partition and flat) and on the flat pyramid with
temporal filtering and rate control (a key frame and a mini-GoP of 4).
It also decodes with all three blocked: a flat pyramid stream it encodes
and the JAX encoder's compound pyramid fixture; at 10 bits it encodes a
flat key frame and a partition I+P and decodes both streams; and it
encodes with tile columns (decoded too) and runs ``parallel.mesh``'s
sharded encodes, SSIM and the log.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "svtav1_tpu", "bench")


def _imported(path: Path):
    """Top-level module names that `path` imports (absolute imports)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_no_module_of_the_port_imports_the_reference():
    files = sorted((ROOT / "svtav1_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [f"{f.relative_to(ROOT)}:{line} imports {name}"
           for f in files for line, name in _imported(f) if name in BLOCKED]
    assert not bad, "\n".join(bad)


# The subprocesses run one OpenMP thread: beside the other test workers'
# processes, torch's 8-thread parallel regions wait on descheduled threads
# (the encode below took over 300 s that way, 10 s alone; 70 s with one
# thread under the same load).
_ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")

_ENCODE_BLOCKED = textwrap.dedent("""
    import sys
    for name in {blocked!r}:
        sys.modules[name] = None          # any import of it raises
    import numpy as np
    from svtav1_tpu_torch.encoder.intra_encoder import (EncoderConfig,
                                                        IntraEncoder)
    from svtav1_tpu_torch.utils.obu import OBU_FRAME, parse_obus
    rng = np.random.RandomState(0)
    frames = [(rng.randint(0, 256, (64, 128)).astype(np.uint8),
               rng.randint(0, 256, (32, 64)).astype(np.uint8),
               rng.randint(0, 256, (32, 64)).astype(np.uint8))
              for _ in range(2)]
    filters = dict(enable_cdef=True, enable_lr=True, enable_ccso=True)
    for kw in (dict(part_search=False), dict(), filters):
        enc = IntraEncoder(EncoderConfig(128, 64, **kw), device="cpu")
        payloads, recons = enc.encode_frames(frames)
        assert len(payloads) == 2 and all(len(p) > 100 for p in payloads)
        for p in payloads:
            assert any(t == OBU_FRAME for t, _, _, _ in parse_obus(p))
        assert recons[1][0].shape == (64, 128)
    from svtav1_tpu_torch.cuda.inputs import moving_frames
    from svtav1_tpu_torch.encoder.video_encoder import VideoEncoder
    for kw in (dict(), dict(part_search=False)):
        enc = VideoEncoder(EncoderConfig(128, 64, **kw), keyint=64,
                           device="cpu")
        payloads, recons = enc.encode_frames(moving_frames(128, 64, 2))
        assert len(payloads[1]) < len(payloads[0])
        assert sum(enc.last_p["mode_counts"].values()) > 0
    from svtav1_tpu_torch.encoder.rate_control import RateControl
    enc = VideoEncoder(EncoderConfig(128, 64, part_search=False),
                       pyramid=True, gop=4, tf=True,
                       rc=RateControl("cbr", target_kbps=150),
                       device="cpu")
    payloads, recons = enc.encode_frames(moving_frames(128, 64, 5))
    payloads += enc.flush()[0]
    assert len(recons) == 5 and len(payloads) == 9     # 4 overlays
    assert enc.rc.base_q != 100
    print("ISOLATED_OK")
""")


def test_port_encodes_with_the_reference_blocked():
    code = _ENCODE_BLOCKED.format(blocked=BLOCKED)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=_ONE_THREAD)
    assert r.returncode == 0, r.stderr
    assert "ISOLATED_OK" in r.stdout


_DECODE_BLOCKED = textwrap.dedent("""
    import hashlib, json, sys
    for name in {blocked!r}:
        sys.modules[name] = None          # any import of it raises
    import numpy as np
    from svtav1_tpu_torch import Decoder
    from svtav1_tpu_torch.cuda.inputs import moving_frames
    from svtav1_tpu_torch.encoder.intra_encoder import EncoderConfig
    from svtav1_tpu_torch.encoder.video_encoder import VideoEncoder
    from svtav1_tpu_torch.utils.ivf import read_ivf
    enc = VideoEncoder(EncoderConfig(128, 64, part_search=False),
                       pyramid=True, gop=4, tf=True, device="cpu")
    payloads, recons = enc.encode_frames(moving_frames(128, 64, 5))
    p, r = enc.flush()
    dec = Decoder(device="cpu")
    outs = [o for o in map(dec.decode_frame_obus, payloads + p) if o]
    assert len(outs) == 5
    for o, rec in zip(outs, recons + r):
        assert all(np.array_equal(a, b) for a, b in zip(o, rec))
    fix = "tests/data/torch_dec/"
    with open(fix + "compound_pyramid.ivf", "rb") as f:
        tus = [t for t, _ in read_ivf(f)[1]]
    dec = Decoder(device="cpu")
    md5 = [hashlib.md5(b"".join(x.tobytes() for x in o)).hexdigest()
           for o in map(dec.decode_frame_obus, tus) if o is not None]
    want = json.load(open(fix + "md5.json"))["compound_pyramid"]["frames"]
    assert md5 == want
    print("ISOLATED_OK")
""")


def test_port_decodes_with_the_reference_blocked():
    code = _DECODE_BLOCKED.format(blocked=BLOCKED)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=_ONE_THREAD)
    assert r.returncode == 0, r.stderr
    assert "ISOLATED_OK" in r.stdout


_TEN_BIT_BLOCKED = textwrap.dedent("""
    import sys
    for name in {blocked!r}:
        sys.modules[name] = None          # any import of it raises
    import numpy as np
    from svtav1_tpu_torch import Decoder
    from svtav1_tpu_torch.cuda.inputs import moving_frames10, synth_frames10
    from svtav1_tpu_torch.encoder.intra_encoder import (EncoderConfig,
                                                        IntraEncoder)
    from svtav1_tpu_torch.encoder.video_encoder import VideoEncoder

    def decodes_to(payloads, recons):
        dec = Decoder(device="cpu")
        outs = [o for o in map(dec.decode_frame_obus, payloads) if o]
        assert len(outs) == len(recons)
        for o, rec in zip(outs, recons):
            assert all(a.dtype == np.uint16 and np.array_equal(a, b)
                       for a, b in zip(o, rec))

    enc = IntraEncoder(EncoderConfig(128, 64, bit_depth=10,
                                     part_search=False), device="cpu")
    payloads, recons = enc.encode_frames(synth_frames10(128, 64, 1))
    assert recons[0][0].dtype == np.uint16 and recons[0][0].max() > 255
    decodes_to(payloads, recons)
    enc = VideoEncoder(EncoderConfig(128, 64, bit_depth=10), keyint=64,
                       device="cpu")
    payloads, recons = enc.encode_frames(moving_frames10(128, 64, 2))
    assert len(payloads[1]) < len(payloads[0])
    assert sum(enc.last_p["mode_counts"].values()) > 0
    decodes_to(payloads, recons)
    print("ISOLATED_OK")
""")


def test_port_encodes_10bit_with_the_reference_blocked():
    code = _TEN_BIT_BLOCKED.format(blocked=BLOCKED)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=_ONE_THREAD)
    assert r.returncode == 0, r.stderr
    assert "ISOLATED_OK" in r.stdout


_TILES_BLOCKED = textwrap.dedent("""
    import sys
    for name in {blocked!r}:
        sys.modules[name] = None          # any import of it raises
    import numpy as np
    from svtav1_tpu_torch import Decoder
    from svtav1_tpu_torch.cuda.inputs import moving_frames
    from svtav1_tpu_torch.encoder.intra_encoder import EncoderConfig
    from svtav1_tpu_torch.encoder.video_encoder import VideoEncoder
    from svtav1_tpu_torch.ops.metrics import ssim_plane
    from svtav1_tpu_torch.parallel import mesh
    from svtav1_tpu_torch.utils import log
    enc = VideoEncoder(EncoderConfig(256, 64, tile_cols=2), keyint=64,
                       device="cpu")
    payloads, recons = enc.encode_frames(moving_frames(256, 64, 2))
    dec = Decoder(device="cpu")
    outs = [dec.decode_frame_obus(p) for p in payloads]
    for o, rec in zip(outs, recons):
        assert all(np.array_equal(a, b) for a, b in zip(o, rec))
    assert 0.5 < ssim_plane(recons[1][0], moving_frames(256, 64, 2)[1][0])
    cpu2 = ["cpu", "cpu"]
    assert mesh.sharded_video_encode_bytes(cpu2) == \\
        mesh.sharded_video_encode_bytes(cpu2, shard=False)
    assert mesh.sharded_tile_encode_bytes(cpu2) == \\
        mesh.sharded_tile_encode_bytes(cpu2, shard=False)
    assert log.get_level() == log.INFO
    print("ISOLATED_OK")
""")


def test_port_tiles_and_mesh_with_the_reference_blocked():
    """Tile columns (a low-delay I+P at two, decoded), SSIM, the log and
    parallel.mesh's sharded encodes, with the reference blocked."""
    code = _TILES_BLOCKED.format(blocked=BLOCKED)
    env = {k: v for k, v in _ONE_THREAD.items() if k != "SVT_LOG"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    assert "ISOLATED_OK" in r.stdout
