"""The flat path's edge strip (m = 12 heights, ``encoder/edge.py``) on the
CPU: the port's encode decodes with its own decoder to the recon it
returns, at 8 and 10 bits and across sizes; the chain's block order and
edges, the strip's deblock edges, the decoder's 16x16 leaf edges, the
sequence header's level rule, the geometry's guards, and the chain
kernel's host side (csrc/wf_edge.cu cannot be built here).  The JAX
package has no strip (it rejects these heights on the flat path); the
plain reference in ``benchmark/reference/edge.py`` is held to the port in
``benchmark/tests/test_bench_edge.py``."""

import ctypes
import re
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from svtav1_tpu_torch.cuda import edge_kernel as ek
from svtav1_tpu_torch.cuda import inputs
from svtav1_tpu_torch.decoder.decoder import Decoder, _leaf16_edges
from svtav1_tpu_torch.ec import native
from svtav1_tpu_torch.encoder import edge
from svtav1_tpu_torch.encoder.headers import (SequenceConfig, level_idx,
                                              write_sequence_header_obu)
from svtav1_tpu_torch.encoder.intra_encoder import (CAND_MODES,
                                                    EncoderConfig,
                                                    IntraEncoder)
from svtav1_tpu_torch.encoder.presets import apply_preset
from svtav1_tpu_torch.encoder.video_encoder import VideoEncoder
from svtav1_tpu_torch.ops.deblock import _filter_pass, deblock_plane_uniform


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _encode(w, h, bd, n=2, q=110, lf=-1, seed=0):
    frames = (inputs.moving_frames(w, h, n, seed=seed) if bd == 8
              else inputs.synth_frames10(w, h, n, seed=seed))
    cfg = replace(apply_preset(EncoderConfig(w, h, qindex=q, bit_depth=bd),
                               12), lf_level=lf)
    enc = IntraEncoder(cfg, device="cpu")
    dev = enc.device_encode(frames)
    return dev, enc.host_finish(dev)


@pytest.mark.parametrize("w,h,bd,lf", [(128, 112, 8, -1), (128, 112, 10, -1),
                                       (256, 48, 8, -1), (192, 176, 10, 0),
                                       (128, 112, 8, 0)])
def test_decodes_to_the_recon(w, h, bd, lf):
    """Every payload of an m = 12 batch decodes exactly to the recon
    host_finish returns (the deblock on and off)."""
    dev, (payloads, recons) = _encode(w, h, bd, lf=lf, seed=w + h)
    assert dev["y_emi"].shape == (2, 2 * w // 32)
    assert dev["uv_elev"].shape == (4, 2 * w // 32, 8, 8)
    dec = Decoder(device="cpu")
    for p, rec in zip(payloads, recons):
        out = dec.decode_frame_obus(p)
        for a, b in zip(out, rec):
            assert a.shape == b.shape
            np.testing.assert_array_equal(np.asarray(a, np.int64),
                                          np.asarray(b, np.int64))


def test_strip_carries_every_mode_kind():
    """Across a few frames the strip picks directional modes that read
    the above-right edge (D45, D67), so the decode test above covers the
    16x16 leaves' edge rules, not only the Z2-safe modes."""
    dev, _ = _encode(256, 176, 8, n=4, seed=3)
    modes = {CAND_MODES[i] for i in dev["y_emi"].numpy().ravel()}
    assert modes & {3, 8}, modes


def test_chain_order_and_edges():
    blocks = edge.edge_blocks(128, 32)
    assert [(dy, x, n) for dy, x, n, *_ in blocks[:6]] == [
        (0, 0, 32), (0, 32, 32), (32, 0, 16), (32, 16, 16), (32, 32, 16),
        (32, 48, 16)]
    # top-left: above-right always (where an above row exists),
    # below-left from the SB to its left; top-right: above-right where an
    # SB follows; the strip: above-right but at the SB's right edge
    assert [(tr, bl) for _, _, _, tr, bl, _ in blocks] == [
        (True, False), (True, False), (True, False), (True, False),
        (True, False), (False, False),
        (True, True), (False, False), (True, False), (True, False),
        (True, False), (False, False)]
    assert [out for *_, out in blocks[:6]] == [0, 1, -1, -2, -3, -4]
    assert edge.strip_count(3840, 32) == 240
    assert edge.strip_count(1920, 16) == 240
    np.testing.assert_array_equal(ek.block_table(128, 16)[:, 2],
                                  [0, 0, 1, 1, 1, 1] * 4)


@pytest.mark.parametrize("sr,sc,qr,qc,right,blin,want", [
    # the strip (qr 1, sr 0): above-right in the 32-row above but at the
    # SB's right edge; no below-left in the frame
    (0, 0, 1, 0, True, False, (True, False)),
    (0, 1, 1, 0, True, False, (True, False)),
    (0, 0, 1, 1, True, False, (True, False)),
    (0, 1, 1, 1, True, False, (False, False)),
    # the top 32-row: the next SB's above row where it exists
    (0, 1, 0, 1, True, True, (True, False)),
    (0, 1, 0, 1, False, True, (False, False)),
    # bottom leaves: the top-right leaf of the same 32x32 only
    (1, 0, 0, 0, True, True, (True, True)),
    (1, 1, 0, 0, True, True, (False, False)),
    (1, 0, 0, 1, True, True, (True, False)),
    # below-left of a left-column leaf: the left SB inside this SB's rows
    (0, 0, 0, 0, True, True, (True, True)),
    (1, 0, 1, 0, True, True, (True, False)),
])
def test_leaf16_edges(sr, sc, qr, qc, right, blin, want):
    assert _leaf16_edges(sr, sc, qr, qc, right, blin) == want


def test_deblock_strip_edges():
    """At valid_h = h - 16 (m = 12) the vertical edges halfway between the
    grid's filter in the strip's rows alone; at another valid_h the
    deblock is the uniform grid's."""
    rng = np.random.RandomState(5)
    plane = torch.from_numpy(rng.randint(90, 110, (2, 128, 128))
                             .astype(np.int32))
    got = deblock_plane_uniform(plane, 32, 14, 40, 40, valid_h=112)
    v = _filter_pass(plane, 32, 128, 14, 40, 0, 8)
    grid = _filter_pass(v.transpose(-1, -2), 32, 112, 14, 40, 0,
                        8).transpose(-1, -2)
    v[..., 96:112, :] = _filter_pass(v[..., 96:112, :], 32, 128, 14, 40, 0,
                                     8, start=16)
    want = _filter_pass(v.transpose(-1, -2), 32, 112, 14, 40, 0,
                        8).transpose(-1, -2)
    assert not torch.equal(grid, want)
    assert torch.equal(got, want)
    assert torch.equal(deblock_plane_uniform(plane, 32, 14, 40, 40,
                                             valid_h=104), _filter_pass(
        _filter_pass(plane, 32, 128, 14, 40, 0, 8).transpose(-1, -2), 32,
        104, 14, 40, 0, 8).transpose(-1, -2))
    assert torch.equal(deblock_plane_uniform(plane, 32, 14, 0, 40,
                                             valid_h=112),
                       _filter_pass(plane.transpose(-1, -2), 32, 112, 14,
                                    40, 0, 8).transpose(-1, -2))


@pytest.mark.parametrize("w,h,idx", [(1920, 1080, 8), (2048, 1088, 8),
                                     (2048, 1152, 12), (3840, 2160, 12)])
def test_level_rule(w, h, idx):
    """The smallest Annex A level from 4.0 up that holds the frame."""
    assert level_idx(w, h) == idx
    assert SequenceConfig(w, h).seq_level_idx == idx


def test_level_keeps_the_header_bytes_at_4_0():
    """Frames up to 2,228,224 samples keep 4.0 (the header the JAX package
    writes); an explicit level is kept."""
    for w, h in ((128, 64), (1920, 1080), (4096, 544)):
        assert write_sequence_header_obu(SequenceConfig(w, h)) == \
            write_sequence_header_obu(SequenceConfig(w, h, seq_level_idx=8))
    assert SequenceConfig(3840, 2160, seq_level_idx=13).seq_level_idx == 13
    assert level_idx(7680, 4320) == 16 and level_idx(16384, 8705) == 31


def test_guards():
    """IntraEncoder takes m = 12 on the flat path; the flat low-delay path,
    whose P frames have no strip, refuses it; 16x8 heights stay
    refused."""
    IntraEncoder(apply_preset(EncoderConfig(128, 112), 12), device="cpu")
    with pytest.raises(ValueError, match="16x16 edge blocks"):
        VideoEncoder(apply_preset(EncoderConfig(128, 112), 12), keyint=8,
                     device="cpu")
    VideoEncoder(apply_preset(EncoderConfig(128, 112), 12), keyint=1,
                 device="cpu")
    with pytest.raises(ValueError, match="16x8"):
        IntraEncoder(apply_preset(EncoderConfig(128, 104), 12),
                     device="cpu")


def test_edge_params_match_the_cuda_struct():
    """The kernel's limits and EdgeParams' array lengths are the ctypes
    mirror's, and each extern "C" function is declared with its
    definition's argument count."""
    src = (Path(ek.__file__).parent.parent / "csrc" / "wf_edge.cu") \
        .read_text()
    const = {n: int(v) for n, v in
             re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["EMAXC"], const["EMAXW"], const["ECOLS"]) == (
        ek.EMAXC, ek.EMAXW, ek.ECOLS)
    body = re.search(r"struct EdgeParams \{(.*?)\n\};", src, re.S).group(1)
    arrays = {}
    for decl in re.findall(r"^\s*(?:int|float) ([^;]*);", body, re.M):
        for part in decl.split(","):
            m = re.match(r"\s*(\w+)\[([0-9A-Z *]+)\]", part)
            if m:
                arrays[m.group(1)] = eval(m.group(2), {}, const)
    mirror = {n: t._length_ for n, t in ek._EdgeParams._fields_
              if hasattr(t, "_length_")}
    assert arrays == mirror
    externs = src[src.index('extern "C" {'):]
    defs = {n: len([a for a in args.split(",") if a.strip()])
            for n, args in re.findall(r"^int (\w+)\(([^)]*)\)", externs,
                                      re.M)}
    assert defs == {"wf_edge_params_size": 0, "wf_edge": 3,
                    "wf_edge_info": 3}


def test_edge_kernel_rejects_cpu_tensors():
    src = torch.zeros((1, 64, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        ek.edge_cuda(src, None, None, None, None, 32, (), 8, 48, False,
                     False)


def test_tile_coder_edge_entry_has_the_c_arguments():
    """The coder's one entry takes the strip last (NULL at every other
    height), and _Strip mirrors the C struct Strip field for field."""
    src = re.sub(r"/\*.*?\*/", "", Path(native._SRC).read_text(), flags=re.S)
    body = re.search(r"typedef struct \{([^}]*)\} Strip;", src).group(1)
    assert re.findall(r"(\w+);", body) == [n for n, _ in
                                           native._Strip._fields_]
    assert native._load().encode_tile_intra.argtypes[-1] is \
        ctypes.POINTER(native._Strip)


def test_native_coder_refuses_a_strip_height_without_the_strip():
    """The flat coder given an m = 12 frame and no strip fails rather than
    code the bottom 32-row whole."""
    from svtav1_tpu_torch.spec.cdf import CdfContext
    bh, bw = 2, 4
    z = lambda *s: np.zeros(s, np.int32)
    with pytest.raises(RuntimeError, match="native tile coder failed"):
        native.encode_tile_intra(128, 64, True, z(bh, bw),
                                 z(bh, bw, 32, 32), z(bh, bw, 16, 16),
                                 z(bh, bw, 16, 16), CdfContext(110),
                                 true_h=48)


def test_decodes_with_angle_deltas():
    """The flat path with angle deltas (API only): the strip's luma
    blocks carry them too, and the stream still decodes to the recon."""
    w, h = 128, 112
    frames = inputs.moving_frames(w, h, 2, seed=9)
    enc = IntraEncoder(EncoderConfig(w, h, qindex=110, part_search=False,
                                     angle_deltas=tuple(range(-3, 4))),
                       device="cpu")
    dev = enc.device_encode(frames)
    payloads, recons = enc.host_finish(dev)
    dec = Decoder(device="cpu")
    for p, rec in zip(payloads, recons):
        for a, b in zip(dec.decode_frame_obus(p), rec):
            np.testing.assert_array_equal(np.asarray(a, np.int64),
                                          np.asarray(b, np.int64))
