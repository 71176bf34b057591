"""The ctypes signatures of the CUDA kernels' C entry points.

``kernels/_build.SIGNATURES`` sets each entry point's argtypes. A wrong
one does not fail loudly: ctypes passes a 64-bit pointer declared as
``c_int`` as a 32-bit int and cuts it. So every ``extern "C"`` declaration
in ``csrc/*.cu`` is parsed here and held against its entry: the same
number of arguments, ``c_void_p`` for each pointer and the stream,
``c_int`` for each int, ``c_longlong`` for each long long. Runs on the
CPU: nothing is compiled.
"""

import ctypes
import re

import pytest

from repro_torch.kernels import _build

DECL = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _declarations():
    out = {}
    for src in _build.sources():
        for name, args in DECL.findall(src.read_text()):
            out[name] = [" ".join(a.split()) for a in args.split(",")]
    return out


def _ctype(arg: str):
    if "*" in arg:
        return ctypes.c_void_p
    if re.fullmatch(r"(const )?int \w+", arg):
        return ctypes.c_int
    if re.fullmatch(r"(const )?long long \w+", arg):
        return ctypes.c_longlong
    raise AssertionError(f"no ctypes rule for argument {arg!r}")


def test_every_entry_point_has_a_signature():
    assert set(_declarations()) == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_the_c_declaration(name):
    args = _declarations()[name]
    assert [_ctype(a) for a in args] == _build.SIGNATURES[name], args
