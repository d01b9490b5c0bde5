"""The ctypes declarations of the port's kernel library against its C sources.

Every `extern "C" int cips_*(...)` entry point in `cips_tpu_torch/csrc/*.cu`
must be declared by the op module that calls it, with the same number of
arguments of the same kinds: a pointer as `c_void_p` (a narrower type would
cut the address), an int as `c_int`, a long long as `c_longlong`, a float as
`c_float`. Nothing on the CPU
calls the library, so these declarations are checked here against the
sources, without building it.
"""

import ctypes
import glob
import os
import re

import pytest

from cips_tpu_torch.ops import cuda_library
from cips_tpu_torch.ops import flash_attention, group_norm, phase_conv

OP_MODULES = (flash_attention, group_norm, phase_conv)  # the modules that declare entry points
KINDS = {"pointer": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _c_entry_points() -> dict:
    """{name: [kind of each parameter]} of every extern "C" entry point."""
    found = {}
    for path in sorted(glob.glob(os.path.join(cuda_library.CSRC, "*.cu"))):
        with open(path, encoding="utf-8") as f:
            text = f.read()
        for name, params in re.findall(r'extern "C" int (cips_\w+)\(([^)]*)\)', text):
            kinds = []
            for param in (p.strip() for p in params.split(",")):
                kinds.append("pointer" if "*" in param else " ".join(param.split()[:-1]))
            found[name] = kinds
    return found


C_ENTRY_POINTS = _c_entry_points()


@pytest.fixture(scope="module")
def declared():
    """{name: argtypes} as the op modules declare them to `cuda_library.load`."""
    seen = {}

    def load(signatures):
        seen.update({name: list(argtypes) for name, argtypes in signatures.items()})
        return None

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_library, "load", load)
        for module in OP_MODULES:
            module._library.__wrapped__()
    return seen


def test_every_entry_point_is_declared(declared):
    assert len(C_ENTRY_POINTS) >= 4
    assert set(declared) == set(C_ENTRY_POINTS)


@pytest.mark.parametrize("name", sorted(C_ENTRY_POINTS))
def test_argtypes_match_the_c_declaration(declared, name):
    kinds = C_ENTRY_POINTS[name]
    assert set(kinds) <= set(KINDS), f"{name}: parameter kinds {kinds}"
    assert declared[name] == [KINDS[kind] for kind in kinds]
