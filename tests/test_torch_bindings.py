"""The ctypes bindings of the port's CUDA sources against their C entry
points, without nvcc or a card.

Every ``extern "C"`` function in ``src/repro_torch/csrc/*.cu`` is parsed
from its prototype and held against the ``argtypes`` that its binding in
``kernels/*/kernel.py`` hands to ``_build.function``: the same count, and
each parameter's C type the ctypes type that carries it (a pointer as
``c_void_p``, ``int`` as ``c_int``, ``int64_t`` as ``c_int64``, ``float``
as ``c_float``).  Then each wrapper is called on CPU tensors against a
stand-in entry point that converts every argument through its argtype,
as ctypes would before a launch: a signature that drifts from its
binding, or a call that drifts from its signature, fails here before a
chip call does.
"""

import ast
import ctypes
import importlib
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build

CSRC = Path(_build.CSRC)
KERNELS = Path(_build.PKG) / "kernels"
C_TYPES = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
           "float": ctypes.c_float}


def c_prototypes() -> dict:
    """{function: [ctypes type of each parameter]} of every extern "C"
    function in csrc/*.cu."""
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for name, params in re.findall(
                r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)\s*\{', text):
            types = []
            params = params.strip()
            for param in [] if params in ("", "void") else params.split(","):
                decl = " ".join(param.split())
                ctype = decl.rsplit(" ", 1)[0].replace("const ", "").strip()
                types.append(ctypes.c_void_p if "*" in decl else C_TYPES[ctype])
            found[name] = (src.stem, types)
    return found


def bindings() -> dict:
    """{function: (library, argtypes)} from every ``_build.function(lib,
    fn, ARGS)`` call in kernels/*/kernel.py, ARGS read off the module."""
    found = {}
    for path in sorted(KERNELS.glob("*/kernel.py")):
        module = importlib.import_module(
            f"repro_torch.kernels.{path.parent.name}.kernel")
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "function"):
                lib, fn, args = node.args
                found[fn.value] = (lib.value, list(getattr(module, args.id)))
    return found


PROTOTYPES = c_prototypes()
BINDINGS = bindings()


def test_every_entry_point_has_a_binding_and_back():
    assert sorted(PROTOTYPES) == sorted(BINDINGS)
    assert {"flash_attention_fwd", "flash_attention_fwd_mma", "fused_update",
            "multidot", "rank_update", "dequant_update",
            "dequant_sub"} <= set(PROTOTYPES)


@pytest.mark.parametrize("fn", sorted(PROTOTYPES))
def test_binding_argtypes_match_the_c_prototype(fn):
    lib, params = PROTOTYPES[fn]
    blib, argtypes = BINDINGS[fn]
    assert blib == lib, (fn, blib, lib)
    assert len(argtypes) == len(params), (fn, len(argtypes), len(params))
    for i, (want, got) in enumerate(zip(params, argtypes)):
        assert got is want, (fn, i, want, got)


def _calls(monkeypatch) -> list:
    """Replace `_build.function` by a stand-in that converts each argument
    through the binding's argtypes and records (fn, the arguments)."""
    calls = []

    def function(lib, fn, argtypes):
        def call(*args):
            assert len(args) == len(argtypes), (fn, len(args), len(argtypes))
            for t, a in zip(argtypes, args):
                t.from_param(a)  # raises as ctypes would on a mismatched type
            calls.append((fn, [getattr(a, "value", a) for a in args]))
            return 0
        return call

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream_of", lambda t: ctypes.c_void_p(0))
    return calls


def _wrappers():
    from repro_torch.kernels.dequant_update import kernel as dq
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fused_update import kernel as fu
    from repro_torch.kernels.lbfgs import kernel as lb

    m, p = 2, 40
    f = lambda *s: torch.zeros(*s)  # noqa: E731
    bf = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)  # noqa: E731
    q8 = torch.zeros(p, dtype=torch.int8)
    ends = torch.tensor([10, p])
    return {
        "multidot": lambda: lb.multidot(f(m, p), f(m, p), f(p), f(3, 14), f(12)),
        "rank_update": lambda: lb.rank_update(f(m, p), f(m, p), f(p), f(5), f(p)),
        "fused_update": lambda: fu.deltagrad_update(f(p), f(p), f(p), f(p), f(p),
                                                    None, 0.1, 60.0, 2.0, 1.0),
        "dequant_update": lambda: dq.dequant_update(
            f(p), q8, f(p), f(p), f(p), f(2), ends, f(p), f(p), 0.1, 60.0, 2.0, 1.0),
        "dequant_sub": lambda: dq.dequant_sub(f(p), q8, None, f(2), ends, f(p)),
        "flash_attention_fwd": lambda: fa.flash_attention(
            bf(2, 65, 4, 64), bf(2, 65, 2, 64), bf(2, 65, 2, 64), bf(2, 65, 4, 64), True),
        "flash_attention_fwd_mma": lambda: fa.flash_attention_mma(
            bf(2, 65, 4, 64), bf(2, 65, 2, 64), bf(2, 65, 2, 64), bf(2, 65, 4, 64), True),
    }


@pytest.mark.parametrize("fn", sorted(PROTOTYPES))
def test_wrapper_calls_convert_through_their_argtypes(fn, monkeypatch):
    calls = _calls(monkeypatch)
    _wrappers()[fn]()
    assert [c[0] for c in calls] == [fn]


def test_flash_bindings_pass_the_same_shape_arguments(monkeypatch):
    """Both flash entry points take the pointers, shape, strides, scale and
    causal flag alike; the wgmma one adds the dtype code before the stream."""
    calls = _calls(monkeypatch)
    wrap = _wrappers()
    wrap["flash_attention_fwd"]()
    wrap["flash_attention_fwd_mma"]()
    (_, fwd), (_, mma) = calls
    assert fwd[4:-2] == mma[4:-1]
    assert fwd[-2] == _build.DTYPE_CODES[torch.bfloat16]
    # B, H, Hkv, Sq, Sk, D, then the strides of q (B, S, H, D) contiguous
    assert fwd[4:13] == [2, 4, 2, 65, 65, 64, 65 * 4 * 64, 4 * 64, 64]


def test_flash_mma_binding_takes_bf16_only(monkeypatch):
    from repro_torch.kernels.flash_attention import kernel as fa

    calls = _calls(monkeypatch)
    t = torch.zeros(1, 64, 2, 16)
    with pytest.raises(ValueError, match="bf16 only"):
        fa.flash_attention_mma(t, t, t, t, True)
    assert calls == []
