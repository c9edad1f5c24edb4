"""The frozen wavefront work count against values worked out by hand for
the cells' shapes."""

import pytest

from benchmark.yardstick import workcount as wc

# luma: 13 DCT_DCT candidates, each (482 + 482 + 738 + 738) / 32 + 30 =
# 106.25 operations a pixel; chroma: 2 DCT_DCT candidates at (190 + 190 +
# 286 + 286) / 16 + 30 = 89.5, 8 with one ADST at (190 + 279 + 375 + 286)
# / 16 + 30 = 100.625, 3 ADST_ADST at (279 + 279 + 375 + 375) / 16 + 30 =
# 111.75
LUMA_PX = 13 * 106.25
CHROMA_PX = 2 * 89.5 + 8 * 100.625 + 3 * 111.75


def test_ops_per_pixel():
    assert wc.ops_per_pixel(32, wc.LUMA_KINDS) == LUMA_PX == 1381.25
    assert wc.ops_per_pixel(16, wc.CHROMA_KINDS) == CHROMA_PX == 1319.25


@pytest.mark.parametrize("bs,B,h,w,chroma,bd,ops,nbytes", [
    # batch 4 (the detail cells): luma 4x1088x1920, U+V 8x544x960
    (32, 4, 1088, 1920, False, 8, 11541504000, 4 * 1088 * 1920 * 9 + 4 * 8160),
    (16, 8, 544, 960, True, 8, 5511720960, 8 * 544 * 960 * 9 + 4 * 16320),
    (32, 4, 1088, 1920, False, 10, 11541504000,
     4 * 1088 * 1920 * 10 + 4 * 8160),
    (16, 8, 544, 960, True, 10, 5511720960, 8 * 544 * 960 * 10 + 4 * 16320),
    # batch 1 (the smooth mix): luma 1x1088x1920, U+V 2x544x960
    (32, 1, 1088, 1920, False, 8, 2885376000, 1088 * 1920 * 9 + 4 * 2040),
    (16, 2, 544, 960, True, 8, 1377930240, 2 * 544 * 960 * 9 + 4 * 4080),
])
def test_work(bs, B, h, w, chroma, bd, ops, nbytes):
    assert wc.work(bs, B, h, w, chroma, bd) == (ops, nbytes)


def test_least_time_is_the_operations():
    # 11541504000 + 5511720960 operations at 64 x 132 x 1.98e9 a second:
    # 1.020 ms a batch of 4, far above the bytes' 0.03 ms
    t = wc.least_seconds(32, 4, 1088, 1920, False, 8) + \
        wc.least_seconds(16, 8, 544, 960, True, 8)
    assert t == pytest.approx(17053224960 / (64 * 132 * 1.98e9))
    assert 1.019e-3 < t < 1.021e-3
