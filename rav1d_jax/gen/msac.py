"""The msac range *encoder* and the symbol chooser that drives it.

`MsacEncoder` is the exact inverse of `entropy.msac.PyMsacContext`: the AV1
`od_ec_enc` scheme (15-bit inverse CDFs, `EC_MIN_PROB` floor per symbol,
carry propagation at the end). Every symbol is given as the two inverse-CDF
bounds the decoder compares against, so one entry point covers adaptive
symbols, adaptive bools, fixed-probability bools and equiprobable bits.

`SymbolChooser` has `PyMsacContext`'s decode interface, but it *chooses*
each symbol instead of reading it: an adaptive symbol is drawn from the very
CDF the syntax walk passes in (so statistics follow the default and adapted
CDFs), a fixed-probability bool follows its probability and a literal bit is
uniform. It applies the same CDF adaptation as the decoder and records every
primitive as `(n, fl, fh, symbol)`: the inverse-CDF snapshot the symbol was
coded with. `MsacEncoder.encode_all` turns the record into the tile payload.
"""

from __future__ import annotations

import numpy as np

from ..entropy.msac import EC_MIN_PROB, EC_PROB_SHIFT, _inv_recenter

_TOP = 1 << 15


class MsacEncoder:
    __slots__ = ("_pre", "_low", "_rng", "_cnt")

    def __init__(self):
        self._pre = []  # pre-carry output words (may exceed 255)
        self._low = 0
        self._rng = 0x8000
        self._cnt = -9

    def encode(self, n: int, fl: int, fh: int, s: int):
        """Code symbol `s` of `n + 1` whose inverse-CDF interval is
        (fh, fl]: fl = icdf[s-1] (32768 for s == 0), fh = icdf[s] (0 for
        the last symbol)."""
        low, r = self._low, self._rng
        v = ((r >> 8) * (fh >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) \
            + EC_MIN_PROB * (n - s)
        if fl < _TOP:
            u = ((r >> 8) * (fl >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) \
                + EC_MIN_PROB * (n - s + 1)
            low += r - u
            r = u - v
        else:
            r -= v
        # normalize: keep rng in [32768, 65535], flush whole bytes of low
        d = 16 - r.bit_length()
        c = self._cnt
        s_ = c + d
        if s_ >= 0:
            c += 16
            m = (1 << c) - 1
            if s_ >= 8:
                self._pre.append(low >> c)
                low &= m
                c -= 8
                m >>= 8
            self._pre.append(low >> c)
            s_ = c + d - 24
            low &= m
        self._low = low << d
        self._rng = r << d
        self._cnt = s_

    def encode_all(self, record) -> bytes:
        enc = self.encode
        for n, fl, fh, s in record:
            enc(n, fl, fh, s)
        return self.finish()

    def finish(self) -> bytes:
        """Flush the fewest bits that decode correctly whatever follows."""
        pre = list(self._pre)
        c = self._cnt
        m = 0x3FFF
        e = ((self._low + m) & ~m) | (m + 1)
        s = 10 + c
        if s > 0:
            n = (1 << (c + 16)) - 1
            while s > 0:
                pre.append(e >> (c + 16))
                e &= n
                s -= 8
                c -= 8
                n >>= 8
        out = bytearray(len(pre))
        carry = 0
        for i in range(len(pre) - 1, -1, -1):
            carry += pre[i]
            out[i] = carry & 0xFF
            carry >>= 8
        return bytes(out)


class SymbolChooser:
    """`PyMsacContext`'s interface, choosing symbols from a seeded generator.

    `biases` maps `id()` of a CDF table (e.g. `cdf.m.partition`) to
    `(symbol, probability)`: when a row of that table is coded, the symbol
    is forced with that probability before the CDF draw.
    """

    __slots__ = ("allow_update_cdf", "record", "_u", "_ui", "_rng",
                 "_biases", "cnt", "rng")

    _BATCH = 1 << 14

    def __init__(self, rng: np.random.Generator, disable_cdf_update: bool,
                 biases=None):
        self.allow_update_cdf = not disable_cdf_update
        self.record = []
        self._rng = rng
        self._u = []
        self._ui = 0
        self._biases = biases or {}
        self.cnt = 0  # read by the decoder's overread check
        self.rng = 0x8000  # read by trace lines

    def _uniform(self) -> float:
        i = self._ui
        if i >= len(self._u):
            self._u = self._rng.random(self._BATCH).tolist()
            i = 0
        self._ui = i + 1
        return self._u[i]

    # -- primitives ---------------------------------------------------------

    def decode_bool_equi(self) -> int:
        bit = 1 if self._uniform() < 0.5 else 0
        self.record.append((1, _TOP, 1 << 14, 0) if not bit else (1, 1 << 14, 0, 1))
        return bit

    def decode_bool(self, f: int) -> int:
        f = int(f)
        bit = 1 if self._uniform() * _TOP < f else 0
        self.record.append((1, _TOP, f, 0) if not bit else (1, f, 0, 1))
        return bit

    def decode_bool_adapt(self, cdf) -> int:
        f = int(cdf[0])
        bias = self._biases.get(id(cdf.base))
        if bias is not None and self._uniform() < bias[1]:
            bit = bias[0]
        else:
            bit = 1 if self._uniform() * _TOP < f else 0
        self.record.append((1, _TOP, f, 0) if not bit else (1, f, 0, 1))
        if self.allow_update_cdf:
            count = int(cdf[1])
            rate = 4 + (count >> 4)
            if bit:
                cdf[0] = f + ((_TOP - f) >> rate)
            else:
                cdf[0] = f - (f >> rate)
            cdf[1] = count + (1 if count < 32 else 0)
        return bit

    def decode_symbol_adapt(self, cdf, n_symbols: int) -> int:
        icdf = cdf[: n_symbols + 1].tolist()
        icdf[n_symbols] = 0  # the counter slot doubles as the terminal zero
        bias = self._biases.get(id(cdf.base))
        if bias is not None and self._uniform() < bias[1]:
            val = bias[0]
        else:
            u = self._uniform() * _TOP
            val = 0
            while val < n_symbols and icdf[val] > u:
                val += 1
        fl = icdf[val - 1] if val else _TOP
        self.record.append((n_symbols, fl, icdf[val], val))
        if self.allow_update_cdf:
            count = int(cdf[n_symbols])
            rate = 4 + (count >> 4) + (1 if n_symbols > 2 else 0)
            for i in range(n_symbols):
                c = icdf[i]
                icdf[i] = c + ((_TOP - c) >> rate) if i < val else c - (c >> rate)
            icdf[n_symbols] = count + (1 if count < 32 else 0)
            cdf[: n_symbols + 1] = icdf
        return val

    # -- composites (built on the primitives, as in PyMsacContext) ----------

    def decode_hi_tok(self, cdf) -> int:
        tok = 3
        for _ in range(4):
            br = self.decode_symbol_adapt(cdf, 3)
            tok += br
            if br != 3:
                break
        return tok

    def decode_bools(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bool_equi()
        return v

    def decode_uniform(self, n: int) -> int:
        l = n.bit_length()
        m = (1 << l) - n
        v = self.decode_bools(l - 1)
        if v < m:
            return v
        return (v << 1) - m + self.decode_bool_equi()

    def decode_subexp(self, ref: int, n: int, k: int) -> int:
        a = 0
        if self.decode_bool_equi():
            if self.decode_bool_equi():
                k += self.decode_bool_equi() + 1
            a = 1 << k
        v = self.decode_bools(k) + a
        if ref * 2 <= n:
            return _inv_recenter(ref, v)
        return n - 1 - _inv_recenter(n - 1 - ref, v)
