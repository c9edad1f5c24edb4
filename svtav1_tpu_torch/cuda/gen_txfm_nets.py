"""Generate ``csrc/txfm_nets.cuh``: the 1D transform networks as
straight-line code.

    python -m svtav1_tpu_torch.cuda.gen_txfm_nets      # rewrite the header

Each network of ``spec.txfm.compiled_stages`` that the flat path runs
becomes one inline function over an array of n values that the caller
keeps in registers: every index is a constant, so nothing is looked up
at run time (a runtime-indexed table into a register array would spill
to local memory).  Butterflies take their products in 64 bits and narrow
after the rounding shift; adds are int32 as in the plain version; the
inverse networks clamp their add stages to [lo, hi].  The header is plain
C under any compiler but nvcc, so the CPU tests compile it with gcc and
hold it against the port's transforms.  ``tests/test_torch_wavefront.py``
checks that the checked-in header equals ``emit()``.
"""

from __future__ import annotations

from pathlib import Path

from ..spec import txfm as T

HEADER = Path(__file__).resolve().parent.parent / "csrc" / "txfm_nets.cuh"

# (function name, kind, n, direction, cos bit): the forward column and row
# networks of the square sizes (one for 32x32, whose column and row cos
# bits are equal), and the inverse networks (one cos bit)
_W8, _W16, _W32 = 1, 2, 3    # log2(n) - 2, the FWD_COS_BIT_* index
if T.FWD_COS_BIT_COL[_W32][_W32] != T.FWD_COS_BIT_ROW[_W32][_W32]:
    raise AssertionError("32x32 column and row cos bits differ")
NETS = (
    ("net_fwd_dct32", "dct", 32, "fwd", T.FWD_COS_BIT_COL[_W32][_W32]),
    ("net_inv_dct32", "dct", 32, "inv", T.INV_COS_BIT),
    ("net_fwd_col_dct16", "dct", 16, "fwd", T.FWD_COS_BIT_COL[_W16][_W16]),
    ("net_fwd_row_dct16", "dct", 16, "fwd", T.FWD_COS_BIT_ROW[_W16][_W16]),
    ("net_inv_dct16", "dct", 16, "inv", T.INV_COS_BIT),
    ("net_fwd_col_adst16", "adst", 16, "fwd",
     T.FWD_COS_BIT_COL[_W16][_W16]),
    ("net_fwd_row_adst16", "adst", 16, "fwd",
     T.FWD_COS_BIT_ROW[_W16][_W16]),
    ("net_inv_adst16", "adst", 16, "inv", T.INV_COS_BIT),
    # the 8x8 chroma of the edge strip (csrc/wf_edge.cu)
    ("net_fwd_col_dct8", "dct", 8, "fwd", T.FWD_COS_BIT_COL[_W8][_W8]),
    ("net_fwd_row_dct8", "dct", 8, "fwd", T.FWD_COS_BIT_ROW[_W8][_W8]),
    ("net_inv_dct8", "dct", 8, "inv", T.INV_COS_BIT),
    ("net_fwd_col_adst8", "adst", 8, "fwd", T.FWD_COS_BIT_COL[_W8][_W8]),
    ("net_fwd_row_adst8", "adst", 8, "fwd", T.FWD_COS_BIT_ROW[_W8][_W8]),
    ("net_inv_adst8", "adst", 8, "inv", T.INV_COS_BIT),
)

_PRELUDE = """\
// Generated by svtav1_tpu_torch/cuda/gen_txfm_nets.py from
// svtav1_tpu_torch/spec/data/txfm_stages.json; do not edit.
//
// AV1's 1D transform networks (spec §7.13.2) as straight-line code over
// an array of n values: one block per butterfly stage, outputs that pass
// their input through unchanged are not written.  wf_btf takes its
// products in 64 bits and narrows after the rounding shift.
#pragma once

#ifdef __CUDACC__
#define WF_NET __device__ __forceinline__
#else
#define WF_NET static inline
#endif

WF_NET int wf_btf(int wa, int a, int wb, int b, int cos_bit) {
  return (int)(((long long)wa * a + (long long)wb * b +
                (1LL << (cos_bit - 1))) >> cos_bit);
}

WF_NET int wf_clamp(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
"""


def _term(w: int, i: int) -> str:
    return {1: f"x[{i}]", -1: f"-x[{i}]"}[w]


def _expr(ia, wa, ib, wb, mode, cos_bit: int, clamp: bool) -> str:
    if mode == T.MODE_BTF:
        return f"wf_btf({wa}, x[{ia}], {wb}, x[{ib}], {cos_bit})"
    lin = _term(wa, ia)
    if wb:
        lin += (" + " if wb > 0 else " - ") + f"x[{ib}]"
    if mode == T.MODE_ADD_CLAMP and clamp:
        return f"wf_clamp({lin}, lo, hi)"
    return lin


def _function(name: str, kind: str, n: int, direction: str,
              cos_bit: int) -> str:
    inv = direction == "inv"
    args = "int *x, int lo, int hi" if inv else "int *x"
    stages = T.compiled_stages(kind, n, direction, cos_bit)
    out = [f"// {kind} {n} {direction}, cos_bit {cos_bit}, "
           f"{len(stages)} stages",
           f"WF_NET void {name}({args}) {{"]
    for s, (ia, wa, ib, wb, mode) in enumerate(stages):
        body = []
        for r in range(n):
            a, b, m = int(ia[r]), int(wa[r]), int(ib[r])
            v, md = int(wb[r]), int(mode[r])
            if md == T.MODE_LIN and a == r and b == 1 and v == 0:
                continue                      # passes its input through
            body.append((r, _expr(a, b, m, v, md, cos_bit, inv)))
        out.append(f"  {{  // stage {s}")
        out += [f"    const int t{r} = {e};" for r, e in body]
        out += [f"    x[{r}] = t{r};" for r, _ in body]
        out.append("  }")
    out.append("}")
    return "\n".join(out)


def emit() -> str:
    """The header's text for the current spec tables."""
    return "\n\n".join([_PRELUDE.rstrip("\n")] +
                       [_function(*net) for net in NETS]) + "\n"


def main() -> None:
    HEADER.write_text(emit())
    print(f"wrote {HEADER}")


if __name__ == "__main__":
    main()
