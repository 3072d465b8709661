"""Bit reader unit tests (GetBits semantics vs src/getbits.rs)."""

from rav1d_jax.bits import GetBits, inv_recenter


def test_get_bits_basic():
    gb = GetBits(bytes([0b10110100, 0xFF, 0x00, 0x0F]))
    assert gb.get_bit() == 1
    assert gb.get_bits(3) == 0b011
    assert gb.get_bits(4) == 0b0100
    assert gb.get_bits(16) == 0xFF00
    assert gb.get_bits(8) == 0x0F
    assert gb.error == 0


def test_get_bits_past_end():
    gb = GetBits(b"\xff")
    assert gb.get_bits(8) == 0xFF
    v = gb.get_bits(8)
    assert gb.error == 1
    assert v == 0


def test_get_sbits():
    gb = GetBits(bytes([0b11110000]))
    assert gb.get_sbits(4) == -1
    assert gb.get_sbits(4) == 0


def test_uleb128():
    gb = GetBits(bytes([0x80 | 0x01, 0x02]))  # 1 | (2<<7) = 257
    assert gb.get_uleb128() == 257
    gb = GetBits(bytes([0x7F]))
    assert gb.get_uleb128() == 0x7F


def test_uniform():
    # ns(max): for max=5, l=3, m=3: values 0..2 take 2 bits, 3..4 take 3.
    gb = GetBits(bytes([0b00000000]))
    assert gb.get_uniform(5) == 0
    gb = GetBits(bytes([0b11000000]))  # v=3 (>=m) -> (3<<1)-3+bit = 3+0
    assert gb.get_uniform(5) == 3


def test_vlc():
    gb = GetBits(bytes([0b10000000]))
    assert gb.get_vlc() == 0
    gb = GetBits(bytes([0b01100000]))  # 0, then 1 -> n_bits=1, read 1 bit (1) -> 1+1 = 2
    assert gb.get_vlc() == 2


def test_inv_recenter():
    assert inv_recenter(5, 0) == 5
    assert inv_recenter(5, 1) == 4
    assert inv_recenter(5, 2) == 6
    assert inv_recenter(5, 11) == 11


def test_bytealign_pos():
    gb = GetBits(bytes([0xAB, 0xCD, 0xEF]))
    gb.get_bits(3)
    gb.bytealign()
    assert gb.pos == 8
    assert gb.byte_pos == 1
    assert gb.get_bits(8) == 0xCD
