"""Metadata OBUs: HDR CLL, HDR mastering display (MDCV), ITU-T T.35.

Copy of ``svtav1_tpu/utils/metadata.py``.  AV1 spec §5.8 (metadata_obu);
reference analogue Source/Lib/Encoder/Globals/EbMetadataHandle.c and the
OBU writer write_metadata_av1 (EbEntropyCoding.c); the CLI string formats
follow SvtAv1EncApp's --mastering-display / --content-light
(App/EncApp/EbAppConfig.c).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from .bitio import BitReader, BitWriter, leb128_decode, leb128_encode
from .obu import OBU_METADATA, wrap_obu

METADATA_TYPE_HDR_CLL = 1
METADATA_TYPE_HDR_MDCV = 2
METADATA_TYPE_SCALABILITY = 3
METADATA_TYPE_ITUT_T35 = 4
METADATA_TYPE_TIMECODE = 5


@dataclass
class ContentLight:
    """§5.8.3 metadata_hdr_cll: maximum content light level / maximum
    frame-average light level, both in cd/m^2."""
    max_cll: int
    max_fall: int


@dataclass
class MasteringDisplay:
    """§5.8.4 metadata_hdr_mdcv.  Chromaticities in 0.16 fixed point,
    luminances in 24.8 (max) / 18.14 (min) fixed point — stored here
    already encoded (raw integer field values)."""
    primary_x: tuple          # (r, g, b) display primaries order per spec
    primary_y: tuple
    white_x: int
    white_y: int
    luminance_max: int
    luminance_min: int


@dataclass
class ItutT35:
    """§5.8.2 metadata_itut_t35."""
    country_code: int
    payload: bytes = b""
    country_code_extension: int = 0


def write_hdr_cll_obu(cll: ContentLight) -> bytes:
    w = BitWriter()
    w.f(cll.max_cll, 16)
    w.f(cll.max_fall, 16)
    w.bit(1)                           # trailing bits
    w.byte_align()
    return wrap_obu(OBU_METADATA,
                    leb128_encode(METADATA_TYPE_HDR_CLL) + w.data())


def write_hdr_mdcv_obu(md: MasteringDisplay) -> bytes:
    w = BitWriter()
    for i in range(3):
        w.f(md.primary_x[i], 16)
        w.f(md.primary_y[i], 16)
    w.f(md.white_x, 16)
    w.f(md.white_y, 16)
    w.f(md.luminance_max, 32)
    w.f(md.luminance_min, 32)
    w.bit(1)
    w.byte_align()
    return wrap_obu(OBU_METADATA,
                    leb128_encode(METADATA_TYPE_HDR_MDCV) + w.data())


def write_itut_t35_obu(t35: ItutT35) -> bytes:
    body = bytes([t35.country_code & 0xFF])
    if t35.country_code == 0xFF:
        body += bytes([t35.country_code_extension & 0xFF])
    # T.35 payloads define their own termination; no trailing bits
    # (libaom av1_write_metadata_obu does the same)
    body += bytes(t35.payload)
    return wrap_obu(OBU_METADATA,
                    leb128_encode(METADATA_TYPE_ITUT_T35) + body)


def parse_metadata_payload(payload: bytes):
    """Parse one OBU_METADATA payload → (type, dataclass-or-bytes)."""
    mtype, pos = leb128_decode(payload, 0)
    body = payload[pos:]
    if mtype == METADATA_TYPE_HDR_CLL:
        r = BitReader(body)
        return mtype, ContentLight(r.f(16), r.f(16))
    if mtype == METADATA_TYPE_HDR_MDCV:
        r = BitReader(body)
        px, py = [], []
        for _ in range(3):
            px.append(r.f(16))
            py.append(r.f(16))
        return mtype, MasteringDisplay(tuple(px), tuple(py), r.f(16),
                                       r.f(16), r.f(32), r.f(32))
    if mtype == METADATA_TYPE_ITUT_T35:
        cc = body[0]
        if cc == 0xFF:
            return mtype, ItutT35(cc, body[2:], body[1])
        return mtype, ItutT35(cc, body[1:])
    return mtype, body                 # scalability/timecode: raw bytes


# ------------------------------------------------------------------ #
# CLI string parsing — same formats as SvtAv1EncApp (Docs/Parameters.md
# "--mastering-display G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min)" with
# chromaticities as reals scaled by 1<<16 and luminances by 1<<8;
# "--content-light max_cll,max_fall").

_MD_RE = re.compile(
    r"G\(([\d.]+),([\d.]+)\)B\(([\d.]+),([\d.]+)\)R\(([\d.]+),([\d.]+)\)"
    r"WP\(([\d.]+),([\d.]+)\)L\(([\d.]+),([\d.]+)\)")


def parse_mastering_display_str(s: str) -> MasteringDisplay:
    m = _MD_RE.fullmatch(s.replace(" ", ""))
    if not m:
        raise ValueError(
            "mastering display must be G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min)")
    gx, gy, bx, by, rx, ry, wx, wy, lmax, lmin = map(float, m.groups())

    def chroma(v):
        return min(65535, int(round(v * (1 << 16))))

    # bitstream order is R,G,B (display_primaries per CICP order)
    return MasteringDisplay(
        primary_x=(chroma(rx), chroma(gx), chroma(bx)),
        primary_y=(chroma(ry), chroma(gy), chroma(by)),
        white_x=chroma(wx), white_y=chroma(wy),
        luminance_max=int(round(lmax * (1 << 8))),
        luminance_min=int(round(lmin * (1 << 14))))


def parse_content_light_str(s: str) -> ContentLight:
    parts = s.split(",")
    if len(parts) != 2:
        raise ValueError("content light must be max_cll,max_fall")
    return ContentLight(int(parts[0]), int(parts[1]))


def build_metadata_obus(mastering_display: str = None,
                        content_light: str = None,
                        t35: ItutT35 = None) -> bytes:
    out = b""
    if mastering_display:
        out += write_hdr_mdcv_obu(parse_mastering_display_str(
            mastering_display))
    if content_light:
        out += write_hdr_cll_obu(parse_content_light_str(content_light))
    if t35 is not None:
        out += write_itut_t35_obu(t35)
    return out
