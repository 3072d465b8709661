"""Engine v3 frame blob: ONE flat int32 staging buffer per frame.

Every host-produced array the dense pass needs — header, coefficients,
descriptor chunks, filter maps, masks — packs sequentially into one flat
int32 numpy buffer that uploads with one `device_put`. All device-side
consumers read it at *traced* word offsets recorded in the header region,
so the packing layout never enters an XLA compile key: the only traced
shape is the buffer's bucketed capacity.

Staging buffers are persistent per capacity bucket and double-buffered
(the device copy of frame N may still be in flight while frame N+1 packs),
so a stream reuses a few host buffers instead of allocating one per frame.

Role parity: this is the engine's answer to rav1d's shared-memory access
to the frame's coef/mask/descriptor state from worker threads
(src/internal.rs:481-504 frame_thread buffers).
"""

from __future__ import annotations

import numpy as np


def bucket_pow2(n, lo=4096):
    b = lo
    while b < n:
        b <<= 1
    return b


def bucket_fine(n, lo=4096):
    """{1, 1.5} * pow2 steps: bounds upload waste to <= 50%% while keeping
    the distinct staging sizes (and so the distinct staging buffers and
    program shapes) small: two steps per octave."""
    if n <= lo:
        return lo
    b = lo
    while True:
        for num in (4, 6):
            c = (b * num) // 4
            if n <= c:
                return c
        b <<= 1


# program capacity high-water marks, keyed by frame geometry: the device
# blob length is a traced shape of every program, so it must NOT follow
# per-frame content (that was round-3's recompile churn); it only grows,
# and the first (key)frame is almost always the high-water mark
_HWM = {}


class _Staging:
    """Persistent pinned staging buffers, double-buffered per capacity."""

    def __init__(self):
        self.bufs = {}  # cap -> [buf0, buf1]
        self.turn = {}

    def get(self, cap):
        if cap not in self.bufs:
            self.bufs[cap] = [np.zeros(cap, np.int32), np.zeros(cap, np.int32)]
            self.turn[cap] = 0
        t = self.turn[cap]
        self.turn[cap] ^= 1
        return self.bufs[cap][t]


_staging = _Staging()


class FrameBlob:
    """Sequential word allocator over the frame's staging buffer."""

    __slots__ = ("parts", "zparts", "pos")

    def __init__(self, hdr_len):
        self.parts = []
        self.zparts = []  # (off, n) regions explicitly zeroed at upload
        self.pos = hdr_len  # header region occupies [0, hdr_len)

    def alloc_zeros(self, n):
        """Reserve an n-word all-zero region (e.g. a no-op filter map);
        zeroed at upload since the staging buffer is reused across frames."""
        off = self.pos
        self.pos += n
        self.zparts.append((off, n))
        return off

    def add_words(self, arr_i32):
        """Append an int32 ndarray; returns its word offset."""
        a = np.ascontiguousarray(arr_i32, dtype=np.int32).reshape(-1)
        off = self.pos
        self.parts.append((off, a))
        self.pos += a.size
        return off

    def add_i16(self, arr):
        """Append an int16 array packed two-per-word (little-endian pair
        order matches lax.bitcast_convert_type int32->int16 lane order).
        Returns the word offset; element i lives at word off + i//2."""
        a = np.ascontiguousarray(arr, dtype=np.int16).reshape(-1)
        if a.size & 1:
            a = np.concatenate([a, np.zeros(1, np.int16)])
        return self.add_words(a.view(np.int32))

    def add_u8(self, arr):
        """Append a uint8 array packed four-per-word; element i lives in
        byte lane i%4 of word off + i//4."""
        a = np.ascontiguousarray(arr, dtype=np.uint8).reshape(-1)
        pad = (-a.size) % 4
        if pad:
            a = np.concatenate([a, np.zeros(pad, np.uint8)])
        return self.add_words(a.view(np.int32))

    def upload(self, hdr, hwm_key=None, floor=0):
        """Fill a persistent staging buffer with the USED prefix, ship it,
        and zero-pad on device to the geometry's high-water capacity (the
        programs' traced blob length). Upload bytes track frame content;
        compile keys track only the stable capacity. `floor` is the
        deterministic per-geometry capacity (run2.det_cap_words) that the
        background warm predicted; frames overflowing it fall back to the
        power-of-2 high-water path (a recompile, rare)."""
        import jax
        import jax.numpy as jnp

        need = bucket_pow2(max(self.pos, hdr.size, floor))
        if hwm_key is not None:
            cap = max(_HWM.get(hwm_key, 0), need)
            _HWM[hwm_key] = cap
        else:
            cap = need
        prefix = min(bucket_fine(self.pos), cap)
        buf = _staging.get(prefix)
        buf[: hdr.size] = hdr
        for off, a in self.parts:
            buf[off : off + a.size] = a
        for off, n in self.zparts:
            buf[off : off + n] = 0
        buf[self.pos :] = 0  # stale words from this buffer's previous tenant
        pre = jax.device_put(buf)
        if prefix == cap:
            return pre, cap
        return jnp.pad(pre, (0, cap - prefix)), cap
