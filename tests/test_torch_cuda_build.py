"""The kernel-launch seam of the port (ops/cuda_build.py), on the CPU: the
ctypes declarations of ENTRIES against the extern "C" blocks of
csrc/<library>.cu, read from the source text (no nvcc), and what
`launch` refuses before it loads a library or counts a launch.  The
launches themselves run only on a card (tests/test_torch_cuda.py)."""
import ctypes
import re

import pytest
import torch

from fhe_si_tpu_torch.ops import cuda_build

# a C parameter or return type of the entry points -> its ctypes type
C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
           "pointer": ctypes.c_void_p}
DEFINITION = re.compile(r"^(?P<ret>int|long long)\s+(?P<name>fsi_\w+)\("
                        r"(?P<args>[^)]*)\)\s*\{", re.M)


def _c_type(param: str):
    """The ctypes type of one C parameter ('const void* res', 'int n')."""
    if "*" in param:
        return C_TYPES["pointer"]
    return C_TYPES[" ".join(param.split()[:-1])]


def _extern_c(library: str) -> dict:
    """{entry point: (return type, [parameter types])} of the functions
    defined in the extern "C" block of csrc/<library>.cu."""
    src = (cuda_build.CSRC / f"{library}.cu").read_text()
    block = src[src.index('extern "C" {'):src.index('}  // extern "C"')]
    return {m["name"]: (C_TYPES[m["ret"]],
                        [_c_type(p) for p in m["args"].split(",")
                         if p.strip()])
            for m in DEFINITION.finditer(block)}


ENTRY_POINTS = [pytest.param(lib, entry, id=entry)
                for lib, entries in cuda_build.ENTRIES.items()
                for entry in entries]


@pytest.mark.parametrize("library,entry", ENTRY_POINTS)
def test_entry_declared_as_in_source(library, entry):
    """Each entry point of the table is defined in its source's extern "C"
    block with the same number and types of arguments and the return
    type that `library` declares."""
    defined = _extern_c(library)
    assert entry in defined, sorted(defined)
    ret, params = defined[entry]
    assert params == cuda_build.ENTRIES[library][entry]
    assert ret == cuda_build.RESTYPES.get(entry, ctypes.c_int)


@pytest.mark.parametrize("library", cuda_build.SOURCES)
def test_source_exports_only_declared_entries(library):
    """No extern "C" function of a source is missing from the table, so
    every one that a wrapper calls has its ctypes declaration."""
    assert set(_extern_c(library)) == set(cuda_build.ENTRIES[library])


def test_launch_refuses_cpu_operands():
    """An operand off a CUDA device raises with the wrapper's name and the
    operand's shape before the library is looked up or a launch counted."""
    cuda_build.reset_launches()
    loads = cuda_build.library.cache_info()
    x = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"crt_to_limbs: operand 0 \(2, 3\)"):
        cuda_build.launch("crt_to_limbs", "fsi_crt_to_limbs", (x, x, x),
                          (6, 3, 1, 1, 0, 0, 1), int32=True, contiguous=True)
    assert not any(cuda_build.LAUNCHES.values())
    assert not any(cuda_build.SCHEDULES.values())
    assert cuda_build.library.cache_info() == loads
