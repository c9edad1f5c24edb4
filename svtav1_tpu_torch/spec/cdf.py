"""Frame CDF context: default tables + per-symbol adaptation (spec §8.4).

Copy of ``svtav1_tpu/spec/cdf.py``.  Tables load from
``data/default_cdfs.npz`` (normative defaults, coefficient tables per
qindex class).  A CdfContext holds mutable copies for one tile; update()
implements the spec's CDF adaptation rule (disabled when the frame sets
disable_cdf_update).  The native flat-path coder copies the tables and
adapts its own copies; the partition path's Python tile coder adapts these.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

from .tables import read_npz

_DATA = Path(__file__).parent / "data" / "default_cdfs.npz"


def q_ctx(base_qindex: int) -> int:
    """Coefficient CDF qindex class (EbCabacContextModel.c:2270)."""
    if base_qindex <= 20:
        return 0
    if base_qindex <= 60:
        return 1
    if base_qindex <= 120:
        return 2
    return 3


_COEF_FIELDS = ("txb_skip_cdf", "eob_extra_cdf", "dc_sign_cdf",
                "eob_flag_cdf16", "eob_flag_cdf32", "eob_flag_cdf64",
                "eob_flag_cdf128", "eob_flag_cdf256", "eob_flag_cdf512",
                "eob_flag_cdf1024", "coeff_base_eob_cdf", "coeff_base_cdf",
                "coeff_br_cdf")

_NSYMBS2SPEED = [0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2]


@lru_cache(maxsize=None)
def _npz():
    return read_npz(_DATA)


class CdfContext:
    """Mutable per-tile CDF set.  Attribute access returns the ndarray whose
    last axis is [icdf_0..icdf_{n-1}, counter] (icdf[n-1] == 0)."""

    def __init__(self, base_qindex: int, update: bool = False):
        d = _npz()
        qc = q_ctx(base_qindex)
        self.update_enabled = update
        self._t = {}
        for k in d:
            if k.startswith("raw_"):
                continue
            arr = d[k].astype(np.uint16)
            if k in _COEF_FIELDS:
                arr = arr[qc]
            self._t[k] = arr.copy()
        self._shape_nmv(d["raw_nmvc"].astype(np.uint16))
        # the fork's per-plane CCSO unit-flag CDF, default AOM_CDF2(11570)
        # (EbCabacContextModel.c:641 default_ccso_cdf)
        self._t["ccso_cdf"] = np.tile(
            np.array([32768 - 11570, 0, 0], np.uint16), (3, 1))

    def _shape_nmv(self, raw: np.ndarray) -> None:
        """Slice the NmvContext blob (joints + 2x NmvComponent,
        EbCabacContextModel.h:527-541) into named tables."""
        self._t["nmv_joints_cdf"] = raw[:5].copy()
        comp_fields = (("nmv_classes_cdf", (12,)),
                       ("nmv_class0_fp_cdf", (2, 5)),
                       ("nmv_fp_cdf", (5,)),
                       ("nmv_sign_cdf", (3,)),
                       ("nmv_class0_hp_cdf", (3,)),
                       ("nmv_hp_cdf", (3,)),
                       ("nmv_class0_cdf", (3,)),
                       ("nmv_bits_cdf", (10, 3)))
        per_comp = sum(int(np.prod(s)) for _, s in comp_fields)
        if 5 + 2 * per_comp != len(raw):
            raise ValueError("raw_nmvc has an unexpected length")
        for ci in range(2):
            off = 5 + ci * per_comp
            for name, shape in comp_fields:
                n = int(np.prod(shape))
                arr = raw[off:off + n].reshape(shape).copy()
                off += n
                self._t.setdefault(name, [None, None])[ci] = arr
        for name, _ in comp_fields:
            self._t[name] = np.stack(self._t[name])    # [2 comps, ...]

    def clone(self) -> "CdfContext":
        """Deep snapshot (frame-end CDF state, spec §7.20)."""
        c = object.__new__(CdfContext)
        c.update_enabled = self.update_enabled
        c._t = {k: v.copy() for k, v in self._t.items()}
        return c

    # counter index overrides where the coded alphabet is smaller than the
    # table stride (svt_av1_reset_cdf_symbol_counters,
    # EbCabacContextModel.c:2369; row-dependent for partition/ext-tx)
    @staticmethod
    def _counter_index(name, row_idx, stride):
        if name == "partition_cdf":
            if row_idx < 4:
                return 4
            if row_idx >= 16:
                return 8
            return 10
        if name == "inter_ext_tx_cdf":
            return {0: 16, 1: 16, 2: 12, 3: 2}[row_idx]
        if name == "intra_ext_tx_cdf":
            return {0: 16, 1: 7, 2: 5, 3: 16}[row_idx]
        if name == "uv_mode_cdf":
            return 13 if row_idx == 0 else 14
        if name == "tx_size_cdf":
            return 2 if row_idx == 0 else 3
        return stride - 1

    def reset_counters(self) -> None:
        """Zero every CDF's adaptation counter (the spec's frame-end update
        keeps probabilities but resets rates)."""
        for name, arr in self._t.items():
            stride = arr.shape[-1]
            flatrows = arr.reshape(-1, stride)
            if name in ("partition_cdf", "inter_ext_tx_cdf",
                        "intra_ext_tx_cdf", "uv_mode_cdf", "tx_size_cdf"):
                # first axis selects the alphabet variant
                n_var = arr.shape[0]
                per = flatrows.shape[0] // n_var
                for v in range(n_var):
                    idx = self._counter_index(name, v, stride)
                    flatrows[v * per:(v + 1) * per, idx] = 0
            else:
                flatrows[:, stride - 1] = 0

    def snapshot(self) -> "CdfContext":
        """Frame-end state: probabilities kept, counters reset."""
        c = self.clone()
        c.reset_counters()
        return c

    def __getattr__(self, name):
        if name == "_t":           # not yet set (e.g. during unpickle)
            raise AttributeError(name)
        try:
            return self._t[name]
        except KeyError:
            raise AttributeError(name)

    def update(self, cdf: np.ndarray, val: int, nsymbs: int = None) -> None:
        """AV1 CDF adaptation (libaom update_cdf); cdf is a 1D slice
        [n icdf values + counter].  Pass nsymbs when the coded alphabet is
        smaller than the table: the rate and the counter slot follow the
        coded alphabet, and the counter lives at index nsymbs."""
        if not self.update_enabled:
            return
        if nsymbs is None:
            nsymbs = len(cdf) - 1
        count = cdf.item(nsymbs)
        rate = 3 + (count > 15) + (count > 31) + _NSYMBS2SPEED[nsymbs]
        # icdf entries below val move up toward 32768, the others down
        # toward 0 (libaom's tmp = 32768 / 0 on either side of val)
        cdf[:nsymbs - 1] = [c + ((32768 - c) >> rate) if i < val
                            else c - (c >> rate)
                            for i, c in enumerate(cdf[:nsymbs - 1].tolist())]
        if count < 32:
            cdf[nsymbs] = count + 1
