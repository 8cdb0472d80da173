"""Reference binary serialization format (byte-compatible).

The port's copy of the pure-Python codec of fhe_si_tpu/refserial.py: the
exact stream layout of the reference's Serialization.cpp (cited per
function), so artifacts written by the reference binaries, by
fhe_si_tpu or by this package read in any of them, byte for byte
(tests/test_torch_host.py, tests/test_torch_serialization.py):

  ZZ       : u32 nbytes | u8 neg | nbytes little-endian magnitude
             (Serialization.cpp:3-13)
  ZZX      : i32 degree | (degree+1) x ZZ            (:29-36)
  long     : 8 raw bytes (template Export)           (Serialization.h:27-30)
  vec_long : u32 len | len x raw long                (:83-89)
  vector<T>: u32 size | size x T                     (Serialization.h:37-44)
  DoubleCRT: u32 card | card x (raw long index, vec_long row)  (:56-65)
  Ciphertext: ScaleDown, then vector<ZZX>            (:109-114)
  SI context: raw u32 m, logQ | ZZ p | raw u32 generator, decompSize |
              u32 count | count x (raw long q, raw long root)
              (FHEContext.cpp:45-60)

The ZZX loops run through the native C++ codec core (native/, built with
g++ at first use and loaded with ctypes) where it builds; this module is
the complete pure-Python implementation and the fallback, which writes
and reads the same bytes.  native_available() says which path runs.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from . import native

STRIDE = 64  # bytes per coefficient on the native path: up to 512 bits


def native_available() -> bool:
    """True when the ZZX loops run on the native core (g++ built it)."""
    return native.get_lib() is not None


class Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def raw(self, n: int) -> bytes:
        b = self.buf[self.off:self.off + n]
        if len(b) != n:
            raise EOFError("truncated reference stream")
        self.off += n
        return b

    def u32(self) -> int:
        return struct.unpack("<I", self.raw(4))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.raw(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self.raw(8))[0]

    def zz(self) -> int:
        n = self.u32()
        neg = self.raw(1)[0] != 0
        mag = int.from_bytes(self.raw(n), "little")
        return -mag if neg else mag

    def zzx(self) -> list[int]:
        degree = self.i32()
        if degree == -1:
            return []
        n = degree + 1
        lib = native.get_lib()
        if lib is not None:
            out = np.empty((n, STRIDE), dtype=np.uint8)
            signs = np.empty(n, dtype=np.int8)
            new_off = lib.fsi_scan_zz_array(
                self.buf, len(self.buf), self.off, n, STRIDE,
                out.ctypes.data, signs.ctypes.data)
            if new_off == -1:
                raise EOFError("truncated reference stream")
            if new_off > 0:
                self.off = new_off
                return [-int.from_bytes(out[i].tobytes(), "little")
                        if signs[i] else
                        int.from_bytes(out[i].tobytes(), "little")
                        for i in range(n)]
            # new_off == -2: a record wider than STRIDE, the Python path
        return [self.zz() for _ in range(n)]

    def vec_long(self) -> np.ndarray:
        n = self.u32()
        return np.frombuffer(self.raw(8 * n), dtype="<i8").copy()

    def doublecrt(self) -> dict[int, np.ndarray]:
        card = self.u32()
        out = {}
        for _ in range(card):
            idx = self.i64()
            out[idx] = self.vec_long()
        return out

    def vector(self, elem):
        return [elem() for _ in range(self.u32())]


class Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def raw(self, b: bytes):
        self.parts.append(b)

    def u32(self, v: int):
        self.raw(struct.pack("<I", v))

    def i32(self, v: int):
        self.raw(struct.pack("<i", v))

    def i64(self, v: int):
        self.raw(struct.pack("<q", v))

    def zz(self, v: int):
        mag = abs(int(v))
        n = (mag.bit_length() + 7) // 8
        self.u32(n)
        self.raw(b"\x01" if v < 0 else b"\x00")
        self.raw(mag.to_bytes(n, "little"))

    def zzx(self, coeffs):
        coeffs = [int(c) for c in coeffs]
        while coeffs and coeffs[-1] == 0:
            coeffs.pop()
        self.i32(len(coeffs) - 1)
        lib = native.get_lib()
        if lib is not None and all(-1 << 512 < c < 1 << 512 for c in coeffs):
            n = len(coeffs)
            mags = np.frombuffer(
                b"".join(abs(c).to_bytes(STRIDE, "little") for c in coeffs),
                dtype=np.uint8).reshape(n, STRIDE)
            signs = np.array([c < 0 for c in coeffs], dtype=np.int8)
            out = np.empty(n * (5 + STRIDE), dtype=np.uint8)
            w = lib.fsi_emit_zz_array(mags.ctypes.data, n, STRIDE,
                                      signs.ctypes.data, out.ctypes.data)
            self.raw(out[:w].tobytes())
            return
        for c in coeffs:
            self.zz(c)

    def vec_long(self, arr):
        arr = np.asarray(arr, dtype="<i8")
        self.u32(len(arr))
        self.raw(arr.tobytes())

    def doublecrt(self, rows: dict[int, np.ndarray]):
        self.u32(len(rows))
        for idx in sorted(rows):
            self.i64(idx)
            self.vec_long(rows[idx])

    def vector(self, items, emit):
        self.u32(len(items))
        for it in items:
            emit(it)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


# ------------------------------------------------------------ object schemas
@dataclass
class RefContext:
    """FHEcontext::ExportSIContext payload (FHEContext.cpp:45-60)."""
    m: int
    log_q: int
    p: int
    generator: int
    decomp_size: int
    chain: list[tuple[int, int]] = field(default_factory=list)  # (q, root)


def read_context(buf: bytes) -> RefContext:
    r = Reader(buf)
    m = r.u32()
    log_q = r.u32()
    p = r.zz()
    generator = r.u32()
    decomp = r.u32()
    count = r.u32()
    chain = [(r.i64(), r.i64()) for _ in range(count)]
    return RefContext(m, log_q, p, generator, decomp, chain)


def write_context(ctx: RefContext) -> bytes:
    w = Writer()
    w.u32(ctx.m)
    w.u32(ctx.log_q)
    w.zz(ctx.p)
    w.u32(ctx.generator)
    w.u32(ctx.decomp_size)
    w.u32(len(ctx.chain))
    for q, root in ctx.chain:
        w.i64(q)
        w.i64(root)
    return w.getvalue()


def read_ciphertext(buf: bytes) -> list[list[int]]:
    """vector<CiphertextPart>, each a ZZX (Serialization.cpp:109-119)."""
    r = Reader(buf)
    return r.vector(r.zzx)


def write_ciphertext(parts: list[list[int]]) -> bytes:
    w = Writer()
    w.vector(parts, w.zzx)
    return w.getvalue()


def read_key(buf: bytes) -> list[dict[int, np.ndarray]]:
    """vector<DoubleCRT> (secret or public key, FHE-SI.cpp:72-78,137-143)."""
    r = Reader(buf)
    return r.vector(r.doublecrt)


def write_key(dcrts: list[dict[int, np.ndarray]]) -> bytes:
    w = Writer()
    w.vector(dcrts, w.doublecrt)
    return w.getvalue()


def read_matrix(r: Reader, elem) -> list[list]:
    """Matrix<T> (Serialization.h:58-81): raw u32 rows | raw u32 cols |
    rows*cols elements row-major (NO per-row length prefix — this is the
    templated Matrix framing, distinct from vector<vector<T>>)."""
    rows = r.u32()
    cols = r.u32()
    return [[elem() for _ in range(cols)] for _ in range(rows)]


def write_matrix(w: Writer, mat, emit):
    rows = len(mat)
    cols = len(mat[0]) if rows else 0
    w.u32(rows)
    w.u32(cols)
    for row in mat:
        assert len(row) == cols, "ragged matrix"
        for item in row:
            emit(item)


def read_keyswitch(buf: bytes) -> list[list[dict[int, np.ndarray]]]:
    """KeySwitchSI::Import payload: Matrix<DoubleCRT>
    (FHE-SI.cpp:270-276 -> Serialization.h:58-81)."""
    r = Reader(buf)
    return read_matrix(r, r.doublecrt)


def write_keyswitch(matrix) -> bytes:
    w = Writer()
    write_matrix(w, matrix, w.doublecrt)
    return w.getvalue()


def read_ciphertext_matrix(buf: bytes) -> list[list[list[list[int]]]]:
    """Matrix<Ciphertext> app state (Regression/Statistics blocks):
    each element a vector<CiphertextPart> of ZZX polys."""
    r = Reader(buf)
    return read_matrix(r, lambda: r.vector(r.zzx))


def write_ciphertext_matrix(mat) -> bytes:
    """mat: [rows][cols] of ciphertext part-lists (to_python_parts)."""
    w = Writer()
    write_matrix(w, mat, lambda ct: w.vector(ct, w.zzx))
    return w.getvalue()
