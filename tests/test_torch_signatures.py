"""The ctypes binding of the CUDA kernels against their C sources.

`kernels/_build.SIGNATURES` declares, for every function a
`csrc/*.cu` file exports under `extern "C"`, the ctypes type of each
parameter. A mismatch does not fail loudly: a pointer declared as
`c_int` is cut to 32 bits, and a missing parameter shifts the rest. So
each exported function's parameters, parsed from its source, are held
against the declared list: the same count, and a pointer, an int or a
float in each place. Nothing here needs a card or a compiler.
"""
from __future__ import annotations

import ctypes
import re

import pytest

from repro_torch.kernels import _build

KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
         ctypes.c_float: "float"}


def _kind(param: str) -> str:
    if "*" in param:
        return "pointer"
    words = param.split()
    for word, kind in (("int", "int"), ("float", "float")):
        if word in words[:-1]:
            return kind
    raise ValueError(f"unparsed parameter {param!r}")


def exported(source: str):
    """{name: [parameter kinds]} of the functions after `extern "C"`."""
    block = source[source.index('extern "C"'):]
    block = re.sub(r"//[^\n]*", "", block)
    return {m.group(1): [_kind(p) for p in m.group(2).split(",")]
            for m in re.finditer(r"^int\s+(\w+)\s*\(([^)]*)\)\s*\{", block,
                                 re.M)}


SOURCES = {lib: exported((_build.CSRC / f"{lib}.cu").read_text())
           for lib in _build.SIGNATURES}
CASES = sorted({(lib, fn) for lib, fns in SOURCES.items() for fn in fns}
               | {(lib, fn) for lib, fns in _build.SIGNATURES.items()
                  for fn in fns})


def test_every_source_is_bound():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == \
        sorted(_build.SIGNATURES)
    assert len(CASES) == 11


@pytest.mark.parametrize("lib,fn", CASES)
def test_binding_matches_source(lib, fn):
    assert fn in SOURCES[lib], f"{fn} is declared but not in {lib}.cu"
    assert fn in _build.SIGNATURES[lib], f"{fn} is exported but not bound"
    declared = [KINDS[t] for t in _build.SIGNATURES[lib][fn]]
    assert declared == SOURCES[lib][fn]
