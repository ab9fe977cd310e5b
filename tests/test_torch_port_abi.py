"""The C interface of the port's CUDA kernels against its Python callers.

Each kernel is a C entry point (`extern "C"` in orv_tpu_torch/ops/csrc/)
called through ctypes: `_build.kernel(name, ARGS)(...)` in
orv_tpu_torch/ops/*.py. ctypes checks nothing against the C declaration: a
wrong argument count or kind passes garbage to the kernel, and a `c_int`
where the C side takes a `long` or a pointer cuts it to 32 bits. These tests
parse both sides and hold each call to its declaration: the entry point
exists, and the `ARGS` list and the call site pass as many arguments as it
declares, of the same kinds. They need no card.
"""

import ast
import ctypes
import importlib
import re
from pathlib import Path

import pytest

OPS = Path(__file__).resolve().parents[1] / "orv_tpu_torch" / "ops"
# every kernel entry point the ops modules call
ENTRY_POINTS = ("orv_flash_attn_static_max", "orv_flash_attn_online", "orv_flash_attn_q8",
                "orv_flash_attn_bwd_dq", "orv_flash_attn_bwd_dkv", "orv_modulate_norm",
                "orv_modulate_norm_q8", "orv_modulate_norm_bwd", "orv_gated_residual",
                "orv_gated_residual_bwd", "orv_modulate_norm_bwd_limits",
                "orv_gated_residual_bwd_limits", "orv_exclusive_scan", "orv_voxel_cells",
                "orv_voxel_group", "orv_voxel_scatter", "orv_raster_preprocess",
                "orv_raster_bin", "orv_raster_forward", "orv_raster_backward",
                "orv_raster_backward_occupancy", "orv_flash_attn_general",
                "orv_flash_attn_general_bwd_dq", "orv_flash_attn_general_bwd_dkv",
                "orv_flash_attn_general_bwd_info", "orv_flash_attn_general_info",
                "orv_modulate_norm_general", "orv_modulate_norm_bwd_general",
                "orv_modulate_norm_bwd_general_limits",
                "orv_gated_residual_f32", "orv_gated_residual_bwd_general",
                "orv_modulate_norm_general_info", "orv_gated_residual_f32_info")
_DECL = re.compile(r'extern\s+"C"\s+([\w\s\*]+?)\s*\b(orv_\w+)\s*\(([^)]*)\)', re.S)


def _kind(param: str):
    """The ctypes type a C parameter declaration takes."""
    if "*" in param:
        return ctypes.c_void_p
    words = param.replace("const", " ").split()[:-1]  # drop the parameter's name
    kinds = {("int",): ctypes.c_int, ("long",): ctypes.c_long, ("float",): ctypes.c_float}
    if tuple(words) not in kinds:
        raise AssertionError(f"no ctypes kind for C parameter {param!r}")
    return kinds[tuple(words)]


def c_declarations():
    """name -> (return type, [ctypes kind per parameter]) of every extern "C"
    function under csrc/."""
    decls = {}
    for path in sorted(OPS.glob("csrc/*.cu*")):
        text = re.sub(r"//[^\n]*", "", path.read_text())
        for ret, name, params in _DECL.findall(text):
            assert name not in decls, f"{name} declared twice"
            decls[name] = (" ".join(ret.split()),
                           [_kind(p) for p in params.split(",") if p.strip()])
    return decls


def python_calls():
    """name -> [(module, ARGS value, number of arguments at the call site)]
    of every `_build.kernel(name, ARGS)(...)` call in ops/*.py."""
    calls = {}
    for path in sorted(OPS.glob("*.py")):
        module = importlib.import_module(f"orv_tpu_torch.ops.{path.stem}")
        for node in ast.walk(ast.parse(path.read_text())):
            inner = node.func if isinstance(node, ast.Call) else None
            if not (isinstance(inner, ast.Call) and isinstance(inner.func, ast.Attribute)
                    and inner.func.attr == "kernel" and isinstance(inner.func.value, ast.Name)
                    and inner.func.value.id == "_build"):
                continue
            name_node, args_node = inner.args
            assert isinstance(name_node, ast.Constant) and isinstance(args_node, ast.Name), (
                f"{path.name}:{node.lineno}: name the entry point by a string and its "
                f"argument types by a module-level list")
            calls.setdefault(name_node.value, []).append(
                (path.name, getattr(module, args_node.id), len(node.args)))
    return calls


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_kernel_call_matches_its_c_declaration(name):
    decls, calls = c_declarations(), python_calls()
    assert name in decls, f"no extern \"C\" declaration of {name} under csrc/"
    ret, kinds = decls[name]
    assert ret == "int", f"{name} returns {ret}; every entry point returns its CUDA error"
    assert name in calls, f"no _build.kernel call of {name}"
    for module, argtypes, n_passed in calls[name]:
        assert list(argtypes) == kinds, (
            f"{module}: {name} declares {[k.__name__ for k in kinds]}, the ARGS list gives "
            f"{[k.__name__ for k in argtypes]}")
        assert n_passed == len(kinds), (
            f"{module}: {name} takes {len(kinds)} arguments, the call passes {n_passed}")


def test_every_entry_point_is_called_and_every_call_declared():
    decls, calls = c_declarations(), python_calls()
    entry = {n for n, (ret, _) in decls.items() if ret == "int"}
    assert entry == set(ENTRY_POINTS) == set(calls)
    assert decls["orv_cuda_error_string"] == ("const char*", [ctypes.c_int])
