"""The plain reference against the port's CPU path at small sizes: the
device stage element for element and the payloads byte for byte (the
port's CPU path runs its plain PyTorch wavefront and its C tile coder)."""

import numpy as np
import pytest
import torch

from benchmark.reference import coder, encoder, tables
from benchmark.yardstick import clips
from benchmark.tests.tiny import REPO
import json

MIX = json.loads((REPO / "benchmark/traffic/detail-q110-b4.json").read_text())


def test_zigzag():
    assert tables.zigzag(32)[:10].tolist() == [0, 1, 32, 64, 33, 2, 3, 34,
                                               65, 96]
    assert tables.zigzag(16)[:10].tolist() == [0, 1, 16, 32, 17, 2, 3, 18,
                                               33, 48]
    assert sorted(tables.zigzag(16).tolist()) == list(range(256))


@pytest.mark.parametrize("bd,w,h,q", [(8, 256, 120, 110), (8, 128, 64, 210),
                                      (10, 128, 64, 110)])
def test_reference_equals_port(bd, w, h, q):
    from svtav1_tpu_torch.encoder.intra_encoder import (EncoderConfig,
                                                        IntraEncoder)
    from svtav1_tpu_torch.encoder.presets import apply_preset
    torch.set_num_threads(2)
    frames = clips.make_pool(MIX["content"], w, h, bd, 2, 7 + q)
    enc = IntraEncoder(apply_preset(EncoderConfig(w, h, qindex=q,
                                                  bit_depth=bd), 12),
                       device="cpu")
    enc.host_finish(enc.device_encode(frames[:1]))   # the stream's first
    dev = enc.device_encode(frames)
    payloads, recons = enc.host_finish(dev)
    ref = {k: v.numpy() for k, v in
           encoder.device_stage(frames, q, bd, h, "cpu").items()}
    for k, v in ref.items():
        assert np.array_equal(dev[k].to(torch.int32).numpy(), v), k
    lf = encoder.lf_levels(q)
    for b in range(2):
        want = coder.host_stage(ref["y_mi"][b], ref["uv_mi"][b],
                                ref["y_lev"][b], ref["uv_lev"][b],
                                ref["uv_lev"][2 + b], w, h, q, lf, True)
        assert payloads[b] == want
        assert np.array_equal(recons[b][0], ref["y_rec"][b][:h])
