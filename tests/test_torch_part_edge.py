"""The port's partition intra path against the JAX package at 128x56:
the bottom SB row has 14 valid mi rows, so the bottom 32-row is forced
NONE and overhangs the frame by 8 rows (valid_h = 56).  Same checks as
``test_torch_part.py``, in a file of its own so that another test worker
compiles the JAX side at the same time.
"""

import numpy as np
import pytest

from test_torch_part import FIELDS, check_decisions, run_both


@pytest.fixture(scope="module")
def both():
    return run_both(128, 56)


def test_decisions_occur(both):
    check_decisions(both["jdev"], edge=True)


@pytest.mark.parametrize("field", list(FIELDS))
def test_device_tuple_matches_jax(both, field):
    k = FIELDS[field]
    got = both["tdev"][k].numpy()
    want = both["jdev"][k]
    assert got.shape == want.shape, field
    np.testing.assert_array_equal(got, want, err_msg=field)


def test_dlf_level_matches_jax(both):
    assert both["tdev"][24] == both["jdev"][24]
    assert both["tdev"][24][0] > 0


def test_payloads_match_jax(both):
    assert both["tpay"] == both["jpay"]
    rec = both["trec"][1]
    assert rec[0].shape == (56, 128) and rec[2].shape == (28, 64)


def test_tx_search_off_codes_dct_only(both):
    assert not both["dev10"][11].any()
    assert (both["dev10"][2][:, -1] == 0).all()
