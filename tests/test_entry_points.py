"""The card-only entry points (chip_smoke.py, bench.py) refuse a non-GPU
backend, chip_smoke's int8-GEMM check reads XLA's HLO correctly, and no
module of the repository imports a Pallas backend that cannot lower for a
GPU."""

import ast
import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_chip_smoke_refuses_cpu(argv, capsys):
    import chip_smoke
    assert chip_smoke.main(argv) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs a GPU" in out.err


def test_bench_refuses_cpu(monkeypatch):
    import bench
    monkeypatch.setattr("sys.argv", ["bench.py", "enc2048"])
    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.main()


_LOOP_DOT = """
%fused (param_0: s8[4096,640], param_1: s8[640,768]) -> s32[4096,768] {
  %param_0 = s8[4096,640]{1,0} parameter(0)
  %param_1 = s8[640,768]{1,0} parameter(1)
  ROOT %dot.2 = s32[4096,768]{1,0} dot(%param_0, %param_1), lhs_contracting_dims={1}
}
"""


def _entry(dtype, gemm, computations=""):
    """An optimized module whose entry computation ends in ``gemm``, on
    its two s8 parameters converted to ``dtype`` as %c0 and %c1."""
    return computations + f"""
ENTRY %main.1 (p0: s8[4096,640], p1: s8[640,768]) -> s32[4096,768] {{
  %p0 = s8[4096,640]{{1,0}} parameter(0)
  %p1 = s8[640,768]{{1,0}} parameter(1)
  %c0 = {dtype}[4096,640]{{1,0}} convert(%p0)
  %c1 = {dtype}[640,768]{{1,0}} convert(%p1)
  {gemm}
}}
"""


_CUBLAS = ('ROOT %custom-call.1 = (s32[4096,768]{1,0}, s8[3112960]{0}) '
           'custom-call(%c0, %c1), custom_call_target="__cublas$gemm"')
# XLA's nested Triton GEMM: the dot's operands are block fusions
_NESTED = """
%block (p: s8[4096,640]) -> s8[4096,640] {
  ROOT %p = s8[4096,640]{1,0} parameter(0)
}

%gemm_computation (parameter_0: s8[4096,640], parameter_1: s8[640,768]) -> s32[4096,768] {
  %parameter_0 = s8[4096,640]{1,0} parameter(0)
  %block_fusion = s8[4096,640]{1,0} fusion(%parameter_0), kind=kCustom, calls=%block
  %parameter_1 = s8[640,768]{0,1} parameter(1)
  %block_fusion.1 = s8[640,768]{0,1} fusion(%parameter_1), kind=kCustom, calls=%block
  ROOT %dot_general.77 = s32[4096,768]{1,0} dot(%block_fusion, %block_fusion.1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

ENTRY %main.1 (p0: s8[4096,640], p1: s8[640,768]) -> s32[4096,768] {
  %p0 = s8[4096,640]{1,0} parameter(0)
  %p1 = s8[640,768]{1,0} parameter(1)
  ROOT %gemm_fusion = s32[4096,768]{1,0} fusion(%p0, %p1), kind=kCustom, calls=%gemm_computation, backend_config={"fusion_backend_config":{"kind":"__triton_nested_gemm_fusion"}}
}
"""


@pytest.mark.parametrize("hlo,ok", [
    (_entry("s8", _CUBLAS), True),
    (_entry("f32", _CUBLAS), False),
    (_entry("s8", "ROOT %f = s32[4096,768]{1,0} fusion(%c0, %c1), "
                  "kind=kLoop, calls=%fused", _LOOP_DOT), False),
    (_NESTED, True),
    (_NESTED.replace("s8[", "f32["), False),
    (_entry("s8", "ROOT %neg = s8[4096,640]{1,0} negate(%c0)"), False)])
def test_int8_gemm_check(hlo, ok):
    """Operands print by name only: their dtypes come from the computation
    that defines them, whether the GEMM is a cuBLAS call or a Triton
    fusion; a dot in an elementwise fusion or an f32 GEMM is refused, and
    so is a module with no GEMM."""
    from chip_smoke import check_int8_gemms
    if ok:
        assert check_int8_gemms(hlo, "t") == 1
    else:
        with pytest.raises(AssertionError, match="s8 x s8"):
            check_int8_gemms(hlo, "t")


def _python_files():
    for sub in ("paillier_tpu", "tests", "scripts"):
        for dirpath, _, files in os.walk(os.path.join(ROOT, sub)):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(dirpath, f)
    for f in ("bench.py", "chip_smoke.py", "__graft_entry__.py"):
        yield os.path.join(ROOT, f)


# Pallas modules a GPU can lower: the front end and its two GPU routes.
_GPU_PALLAS = {"jax.experimental.pallas", "jax.experimental.pallas.triton",
               "jax.experimental.pallas.mosaic_gpu"}


def _pallas_imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            # "from jax.experimental.pallas import <backend>" names a module
            if node.module == "jax.experimental.pallas":
                for a in node.names:
                    name = f"{node.module}.{a.name}"
                    if importlib.util.find_spec(name) is not None:
                        yield name


def test_no_non_gpu_pallas_imports():
    bad = []
    for path in _python_files():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        bad += [(path, m) for m in _pallas_imports(tree)
                if m.startswith("jax.experimental.pallas")
                and m not in _GPU_PALLAS]
    assert not bad, bad
