"""AV1 IVF in -> Y4M out (and an MD5 of the frames) with the port's decoder.

Counterpart of ``svtav1_tpu/dec_app.py`` (the reference DecApp surface,
Source/App/DecApp): the same frame count line, MD5 and Y4M bytes.  The
reconstruction and the in-loop filters run on --device (default cuda).

Usage: python -m svtav1_tpu_torch.dec_app -i in.ivf [-o out.y4m] [--md5]
       [--ccso] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="svtav1_tpu_torch.dec")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--md5", action="store_true",
                   help="print MD5 of decoded frames (DecApp-style check)")
    p.add_argument("--ccso", action="store_true",
                   help="parse the fork's grafted (nonstandard) CCSO "
                        "syntax, required for streams encoded with --ccso")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    args = p.parse_args(argv)

    from .decoder.decoder import DecodeError, Decoder
    from .utils.ivf import read_ivf
    from .utils.y4m import Y4mInfo, Y4mWriter

    dec = Decoder(ccso=args.ccso, device=args.device)
    md5 = hashlib.md5()
    n = 0
    wtr = None
    with open(args.input, "rb") as f:
        info, frames = read_ivf(f)
        out_f = open(args.output, "wb") if args.output else None
        try:
            for payload, _pts in frames:
                try:
                    frame = dec.decode_frame_obus(payload)
                except DecodeError as e:
                    print(f"error: {e}", file=sys.stderr)
                    return 1
                if frame is None:
                    continue
                y, u, v = frame
                if out_f is not None and wtr is None:
                    # IVF timebase is 1/fps: fps_num = timebase_den /
                    # timebase_num
                    wtr = Y4mWriter(out_f, Y4mInfo(
                        y.shape[1], y.shape[0], info["timebase_den"] or 30,
                        info["timebase_num"] or 1,
                        bit_depth=dec.seq.bit_depth if dec.seq else 8))
                if wtr:
                    wtr.write_frame(y, u, v)
                if args.md5:
                    md5.update(y.tobytes())
                    md5.update(u.tobytes())
                    md5.update(v.tobytes())
                n += 1
        finally:
            if out_f:
                out_f.close()
    print(f"decoded {n} frames")
    if args.md5:
        print(f"MD5: {md5.hexdigest()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
