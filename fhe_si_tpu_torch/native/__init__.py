"""Native (C++) core of the reference byte-format codec, loaded with
ctypes: the ZZ scan and emit loops of refserial.py.

The port's own copy of the JAX package's g++ core.  get_lib() compiles
refserial_core.cpp with g++ at first use into fhe_si_tpu_torch/_build/
(never beside the source; the library's name carries a hash of the source
and flags, and it lands by an atomic rename, so processes that build at
once do not clash) and returns the loaded library, or None where g++ is
missing or fails: refserial.py then takes its pure-Python path, which
writes and reads the same bytes.  Host code: nothing here touches a
device.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "refserial_core.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
FLAGS = ["-O2", "-shared", "-fPIC"]


def _so_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"librefserial_core_{tag.hexdigest()[:12]}.so"


def build() -> Path | None:
    """The compiled library's path, building it when it is not there;
    None when g++ is missing or fails."""
    so = _so_path()
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    run = subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if run.returncode:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return so


@functools.cache
def get_lib():
    """The loaded codec core with its signatures, or None."""
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    i64, ptr = ctypes.c_longlong, ctypes.c_void_p
    lib.fsi_scan_zz_array.restype = i64
    lib.fsi_scan_zz_array.argtypes = [ctypes.c_char_p, i64, i64, i64, i64,
                                      ptr, ptr]
    lib.fsi_emit_zz_array.restype = i64
    lib.fsi_emit_zz_array.argtypes = [ptr, i64, i64, ptr, ptr]
    return lib
