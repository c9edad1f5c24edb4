"""AV1 multi-symbol range (entropy) coder, Daala EC per AV1 spec §8.2.

Copy of ``svtav1_tpu/ec/range_coder.py`` (bit-exact to the reference
encoder, EbBitstreamUnit.c:107-406, and its decoder,
EbDecBitstreamUnit.c).  CDFs use the "inverse CDF" convention: icdf[s] =
32768 - cum_prob(<= s); icdf[nsyms-1] = 0.  The partition path's tile
coder (``encoder/tile_codec.py``) writes through RangeEncoder (the flat
path uses the native C coder); the decoder reads through RangeDecoder,
whose state the native coefficient reader advances in place.
"""

from __future__ import annotations

EC_PROB_SHIFT = 6
EC_MIN_PROB = 4
CDF_PROB_TOP = 32768
WINDOW = 32
_WMASK = (1 << WINDOW) - 1


def _ilog_nz(x: int) -> int:
    return int(x).bit_length()


class RangeEncoder:
    def __init__(self) -> None:
        self.low = 0
        self.rng = 0x8000
        self.cnt = -9
        self.precarry: list[int] = []

    # -- core ---------------------------------------------------------------

    def _normalize(self, low: int, rng: int) -> None:
        d = 16 - _ilog_nz(rng)
        c = self.cnt
        s = c + d
        if s >= 0:
            c += 16
            m = (1 << c) - 1
            if s >= 8:
                self.precarry.append((low >> c) & 0xFFFF)
                low &= m
                c -= 8
                m >>= 8
            self.precarry.append((low >> c) & 0xFFFF)
            s = c + d - 24
            low &= m
        self.low = (low << d) & _WMASK
        self.rng = (rng << d) & 0xFFFF
        self.cnt = s

    def encode_q15(self, fl: int, fh: int, s: int, nsyms: int) -> None:
        fl, fh = int(fl), int(fh)
        l, r = self.low, self.rng
        n = nsyms - 1
        if fl < CDF_PROB_TOP:
            u = (((r >> 8) * (fl >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + \
                EC_MIN_PROB * (n - (s - 1))
            v = (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + \
                EC_MIN_PROB * (n - s)
            l += r - u
            r = u - v
        else:
            r -= (((r >> 8) * (fh >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + \
                EC_MIN_PROB * (n - s)
        self._normalize(l, r)

    # -- public -------------------------------------------------------------

    def encode_symbol(self, s: int, icdf, nsyms: int | None = None) -> None:
        """Encode symbol s with inverse-CDF table.

        `icdf` is a CDF slice in storage layout: nsyms icdf entries
        (icdf[nsyms-1] == 0) followed by one adaptation counter; nsyms
        defaults to len(icdf) - 1.
        """
        if nsyms is None:
            nsyms = len(icdf) - 1
        self.encode_q15(icdf[s - 1] if s > 0 else CDF_PROB_TOP,
                        int(icdf[s]), s, nsyms)

    def encode_bool(self, val: int, f: int = 0x4000) -> None:
        """f = P(val==1) in Q15."""
        l, r = self.low, self.rng
        v = (((r >> 8) * (f >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + \
            EC_MIN_PROB
        if val:
            l += r - v
            r = v
        else:
            r -= v
        self._normalize(l, r)

    def encode_literal(self, value: int, bits: int) -> None:
        """Raw bits, MSB first, each as a p=1/2 bool (spec L(n))."""
        for i in range(bits - 1, -1, -1):
            self.encode_bool((value >> i) & 1, 0x4000)

    def tell(self) -> int:
        return self.cnt + 10 + len(self.precarry) * 8

    def done(self) -> bytes:
        l = self.low
        c = self.cnt
        s = 10
        m = 0x3FFF
        e = ((l + m) & ~m) | (m + 1)
        s += c
        buf = list(self.precarry)
        if s > 0:
            n = (1 << (c + 16)) - 1
            while True:
                buf.append((e >> (c + 16)) & 0xFFFF)
                e &= n
                s -= 8
                c -= 8
                n >>= 8
                if s <= 0:
                    break
        # carry propagation
        out = bytearray(len(buf))
        carry = 0
        for i in range(len(buf) - 1, -1, -1):
            carry = buf[i] + carry
            out[i] = carry & 0xFF
            carry >>= 8
        return bytes(out)


class RangeDecoder:
    """The decoder's mirror of RangeEncoder over one tile's bytes."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.bptr = 0
        self.dif = (1 << (WINDOW - 1)) - 1
        self.rng = 0x8000
        self.cnt = -15
        self._refill()

    def _refill(self) -> None:
        s = WINDOW - 9 - (self.cnt + 15)
        while s >= 0 and self.bptr < len(self.data):
            self.dif ^= self.data[self.bptr] << s
            self.cnt += 8
            self.bptr += 1
            s -= 8
        if self.bptr >= len(self.data):
            self.cnt = (1 << 14)  # effectively "lots of bits" of zeros

    def decode_symbol(self, icdf, nsyms: int | None = None) -> int:
        """Mirror of encode_symbol; icdf layout includes the counter slot.
        The renormalisation is inlined here and in decode_bool (the
        parse's innermost calls)."""
        if nsyms is None:
            nsyms = len(icdf) - 1
        r = self.rng
        c = self.dif >> (WINDOW - 16)
        r8 = r >> 8
        n4 = EC_MIN_PROB * (nsyms - 1)
        v = r
        ret = -1
        while True:
            ret += 1
            u = v
            v = (((r8 * (icdf.item(ret) >> EC_PROB_SHIFT))
                  >> (7 - EC_PROB_SHIFT)) + n4 - EC_MIN_PROB * ret)
            if c >= v:
                break
        r = u - v
        d = 16 - r.bit_length()
        self.cnt -= d
        self.dif = ((((self.dif - (v << (WINDOW - 16))) + 1) << d) - 1) & \
            _WMASK
        self.rng = (r << d) & 0xFFFF
        if self.cnt < 0:
            self._refill()
        return ret

    def decode_bool(self, f: int = 0x4000) -> int:
        dif, r = self.dif, self.rng
        v = (((r >> 8) * (f >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) + \
            EC_MIN_PROB
        vw = v << (WINDOW - 16)
        if dif >= vw:
            ret = 0
            dif -= vw
            r -= v
        else:
            ret = 1
            r = v
        d = 16 - r.bit_length()
        self.cnt -= d
        self.dif = (((dif + 1) << d) - 1) & _WMASK
        self.rng = (r << d) & 0xFFFF
        if self.cnt < 0:
            self._refill()
        return ret

    def decode_literal(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            v = (v << 1) | self.decode_bool(0x4000)
        return v
