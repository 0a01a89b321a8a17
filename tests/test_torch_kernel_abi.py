"""The ctypes tables of the port's kernel libraries against their C sources.

Each CUDA source under ``dlrover_wuqiong_tpu_torch/csrc/`` exposes a plain C
interface, which its wrapper module calls through ctypes with the argtypes
of its ``_SIGNATURES`` table.  A table that disagrees with the source cuts
a pointer to 32 bits or shifts every argument after the wrong one, and shows
only as a crash or a wrong result on the card.  These tests parse every
``extern "C"`` declaration of the sources, in both forms (``extern "C" int
f(...)`` and an ``extern "C" { ... }`` block), and hold each against its
row: the same entry points, the same number of parameters, and each
parameter of the matching kind.
"""

import ctypes
import os
import re

import pytest

from dlrover_wuqiong_tpu_torch import _build
from dlrover_wuqiong_tpu_torch.ops import flash_attention as tfa
from dlrover_wuqiong_tpu_torch.ops import quantization as tq
from torch_threads import one_torch_thread  # noqa: F401

PKG = os.path.dirname(os.path.abspath(_build.__file__))
TABLES = {"flash_attention": tfa._SIGNATURES,
          "int8_blockwise": tq._SIGNATURES}

# C parameter type (qualifiers dropped) -> the ctypes type that passes it
SCALARS = {"int": ctypes.c_int, "float": ctypes.c_float,
           "long long": ctypes.c_longlong, "long long int": ctypes.c_longlong,
           "int64_t": ctypes.c_longlong}


def _strip_comments(src: str) -> str:
    src = re.sub(r"/\*.*?\*/", " ", src, flags=re.S)
    return re.sub(r"//[^\n]*", " ", src)


def _top_level(block: str) -> str:
    """The text of `block` outside any braces (function bodies dropped)."""
    out, depth = [], 0
    for c in block:
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
        elif depth == 0:
            out.append(c)
    return "".join(out)


def extern_c_declarations(src: str):
    """{name: (return type, [parameter declarations])} of every function
    declared extern "C" in `src`."""
    src = _strip_comments(src)
    heads = []
    for m in re.finditer(r'extern\s+"C"\s*', src):
        rest = src[m.end():]
        if rest.startswith("{"):
            depth = 0
            for end, c in enumerate(rest):
                depth += (c == "{") - (c == "}")
                if depth == 0:
                    break
            heads.append(_top_level(rest[1:end]))
        else:
            heads.append(rest[:rest.index(")") + 1])
    decls = {}
    for head in heads:
        for m in re.finditer(r"\b(\w+)\s+(\w+)\s*\(([^)]*)\)", head):
            params = [p.strip() for p in m.group(3).split(",") if p.strip()]
            if params == ["void"]:
                params = []
            decls[m.group(2)] = (m.group(1), params)
    return decls


def ctype_of(param: str):
    """The ctypes type that passes the C parameter declaration `param`."""
    if "*" in param:
        return ctypes.c_void_p
    words = [w for w in param.split()[:-1] if w not in ("const", "volatile")]
    kind = " ".join(words)
    if kind not in SCALARS:
        raise ValueError(f"no ctypes kind for C parameter {param!r}")
    return SCALARS[kind]


def _source_decls(lib: str):
    with open(os.path.join(PKG, _build.SOURCES[lib])) as f:
        return extern_c_declarations(f.read())


def test_parser_reads_both_forms():
    src = '''
    // extern "C" int commented_out(int a);
    extern "C" int single(const void* x, long long n, float s,
                          void* stream) { return f<int>(x, n); }
    extern "C" {
    int first(const void* q, int bh) { if (bh) { return 1; } return 0; }
    int second(void) { return 0; }
    }  // extern "C"
    '''
    decls = extern_c_declarations(src)
    assert decls == {
        "single": ("int", ["const void* x", "long long n", "float s",
                           "void* stream"]),
        "first": ("int", ["const void* q", "int bh"]),
        "second": ("int", []),
    }
    assert [ctype_of(p) for p in decls["single"][1]] == [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]


@pytest.mark.parametrize("lib", sorted(TABLES))
def test_every_entry_point_has_a_row(lib):
    assert set(TABLES) == set(_build.SOURCES)
    assert sorted(_source_decls(lib)) == sorted(TABLES[lib])


@pytest.mark.parametrize("lib,name", [(lib, name)
                                      for lib in sorted(TABLES)
                                      for name in sorted(TABLES[lib])])
def test_row_matches_the_c_declaration(lib, name):
    decls = _source_decls(lib)
    assert name in decls, f"{name} is not an extern \"C\" entry point of {lib}"
    ret, params = decls[name]
    assert ret == "int"  # the wrappers set restype c_int and raise on != 0
    row = TABLES[lib][name]
    assert len(row) == len(params), (
        f"{name}: {len(row)} argtypes for {len(params)} C parameters")
    for i, (want, param) in enumerate(zip(row, params)):
        assert ctype_of(param) is want, (
            f"{name} parameter {i} ({param!r}) is passed as {want.__name__}")
