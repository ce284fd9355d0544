"""The port's static analyzer (``repro_torch.analysis``) against the
reference's (``repro.analysis``), and its kernel rules on fixtures.

Every lint, typing-gate, concurrency and pragma fixture of
``tests/test_analysis.py`` (and the kernel-rtol-site one, a rule the
port keeps) runs through both analyzers' ``main`` in explicit mode: the
(rule, line) findings and the exit codes must be equal, and the
reference test's own assertions still hold.  The CLI's baseline, JSON
and invocation tests run against the port's ``main``.

The kernel rules (``ctypes-arity``, ``ctypes-type``, ``cuda-rounding``,
``cuda-fmad-flag``) each get a fixture that fires and one that does not,
among them copies of the shipped sources with one planted fault: a bare
add in ``sched_kernels.cu`` on a ``float`` operand or on one of the
kernels' template real type, a ``sched_wave_launch.argtypes`` one entry
short, a ``c_double`` where a float32 entry point takes a ``float``.
The shipped tree analyzes clean with an empty baseline.
"""
import inspect
import io
import re
import shutil
import subprocess
import sys
import textwrap
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest

import test_analysis as TA
from repro_torch.analysis import ALL_RULES
from repro_torch.analysis import main as port_main
from repro_torch.analysis.findings import load_baseline

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FINDING = re.compile(r"^.*?:(\d+): \[([a-z0-9-]+)\]", re.M)

SHARED = ["TestFloatArith", "TestSentinelScope", "TestNondeterminism",
          "TestSetIteration", "TestDeprecationRoute", "TestHostSync",
          "TestUnusedImport", "TestKernelRtolSite", "TestTypingGate",
          "TestRaceUnguardedShared", "TestAwaitUnderLock",
          "TestLoopBlockingCall", "TestCrossThreadFuture",
          "TestLeakExecutor", "TestGcTaskRef", "TestPragma"]
CLI = {"TestBaseline": None, "TestJsonFormat": None,
       "TestCli": ["test_unknown_rule_is_config_error",
                   "test_syntax_error_is_config_error",
                   "test_findings_carry_file_line_locations",
                   "test_directory_arguments_expand_sorted_and_deduped",
                   "test_missing_path_is_config_error",
                   "test_paths_filter_rejected_in_explicit_mode"]}


def _methods(cls_name, names=None):
    cls = getattr(TA, cls_name)
    return [(cls_name, n) for n, _ in inspect.getmembers(
        cls, inspect.isfunction) if n.startswith("test_")
        and (names is None or n in names)]


def run_port(argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        code = port_main(argv)
    return code, out.getvalue(), err.getvalue()


def findings(out):
    return sorted((rule, int(line)) for line, rule in FINDING.findall(out))


# ------------------------------------------------------ shared fixtures
@pytest.mark.parametrize("cls_name,method", [
    m for c in SHARED for m in _methods(c)], ids="::".join)
def test_fixture_findings_equal_reference(cls_name, method, tmp_path,
                                          monkeypatch):
    seen = []
    real = TA.analyze

    def both(tmp_path, source, rules=None, name="fixture.py"):
        code, out, err = real(tmp_path, source, rules=rules, name=name)
        argv = [str(tmp_path / name)] + (["--rules", rules] if rules
                                         else [])
        pcode, pout, _ = run_port(argv)
        assert (pcode, findings(pout)) == (code, findings(out)), (out, pout)
        seen.append(code)
        return code, out, err

    monkeypatch.setattr(TA, "analyze", both)
    getattr(getattr(TA, cls_name)(), method)(tmp_path)
    assert seen                                  # the fixture went through


@pytest.mark.parametrize("cls_name,method", [
    m for c, names in CLI.items() for m in _methods(c, names)],
    ids="::".join)
def test_cli_mechanics_on_the_port(cls_name, method, tmp_path, monkeypatch):
    """The reference's baseline, JSON and invocation tests, run against
    the port's ``main``."""
    monkeypatch.setattr(TA, "main", port_main)
    getattr(getattr(TA, cls_name)(), method)(tmp_path)


def test_list_rules():
    code, out, _ = run_port(["--list-rules"])
    assert code == 0
    rules = set(out.split())
    assert rules == set(ALL_RULES)
    for rule in ("float-arith", "sentinel-scope", "nondeterminism",
                 "set-iteration", "deprecation-route", "host-sync",
                 "unused-import", "protocol-missing", "protocol-signature",
                 "backend-name", "race-unguarded-shared",
                 "race-await-under-lock", "loop-blocking-call",
                 "race-cross-thread-future", "leak-executor",
                 "gc-task-ref", "ctypes-arity", "ctypes-type",
                 "cuda-rounding", "cuda-fmad-flag", "kernel-rtol-site"):
        assert rule in rules


# ------------------------------------------------------ the shipped tree
def test_shipped_port_analyzes_clean_with_an_empty_baseline():
    assert load_baseline(str(PKG / "analysis" / "baseline.txt")) == []
    code, out, _ = run_port([])
    assert code == 0, out
    assert "clean" in out and "baselined" not in out
    n = int(re.search(r"clean — (\d+) file", out).group(1))
    assert n == len([p for s in ("*.py", "*.cu") for p in PKG.rglob(s)
                     if "analysis" not in p.relative_to(PKG).parts])


def test_module_entry_point():
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--paths", "src/repro_torch/core/backends/"],
                         cwd=ROOT, capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "clean" in out.stdout


def test_host_sync_torch_fetches_only_where_torch_is_imported(tmp_path):
    """``.tolist()`` in a module that imports torch is a host sync; in a
    NumPy-only module (the vector backend) it is not."""
    code, out, _ = _run(tmp_path, {"m.py": """
        import torch
        def fetch(t):
            return t.tolist(), t.item(), torch.cuda.synchronize()
        """}, "host-sync")
    assert code == 1 and findings(out) == [("host-sync", 4)] * 3
    code, out, _ = _run(tmp_path / "np", {"m.py": """
        import numpy as np
        def fetch(a):
            return np.asarray(a).tolist()
        """}, "host-sync")
    assert code == 0, out


# ------------------------------------------------------- kernel rules
def _run(where, files, rules=None):
    where.mkdir(parents=True, exist_ok=True)
    for name, text in files.items():
        (where / name).write_text(textwrap.dedent(text))
    return run_port([str(where)] + (["--rules", rules] if rules else []))


BINDING = """
    import ctypes
    from pathlib import Path
    from repro_torch import _nvcc

    SOURCE = Path(__file__).resolve().parent / "k.cu"
    FLAGS = _nvcc.BASE_FLAGS + {flags}
    _P = ctypes.c_void_p
    _I = ctypes.c_int
    _D = ctypes.c_double


    def _load():
        built = _nvcc.build("k", [SOURCE], FLAGS)
        fn = built.lib.k_launch
        fn.argtypes = {argtypes}
        fn.restype = {restype}
        return built
"""
SOURCE = """
    #include <cuda_runtime.h>

    __device__ __forceinline__ double step(double a, double b, double c) {{
      {body}
    }}

    extern "C" int k_launch(const double* x, double* y, int n,
                            double alpha, void* stream) {{
      int i = 3 * n + 1;           // integer index arithmetic
      return i - n;
    }}
"""
ROUNDED = "return __dadd_rn(__dmul_rn(a, b), c);"
FMAD = '("--fmad=false",)'
GOOD_ARGS = "[_P] * 2 + [_I, _D, _P]"


def _kernel(tmp_path, body=ROUNDED, flags=FMAD, argtypes=GOOD_ARGS,
            restype="_I", rules=None):
    return _run(tmp_path, {
        "k.py": BINDING.format(flags=flags, argtypes=argtypes,
                               restype=restype),
        "k.cu": SOURCE.format(body=body)}, rules)


def test_kernel_fixture_clean(tmp_path):
    code, out, _ = _kernel(tmp_path)
    assert code == 0, out


@pytest.mark.parametrize("body,line", [
    ("return a * b + c;", 5),
    ("double t = a * b;\n  return __dadd_rn(t, c);", 5),
    ("double t = __dmul_rn(a, b);\n  t += c;\n  return t;", 6),
    ("return fma(a, b, c);", 5),
    ("return __fma_rn(a, b, c);", 5),
    ("return __dadd_rn(a, 1.0 * c);", 5)])
def test_cuda_rounding_fires(tmp_path, body, line):
    code, out, _ = _kernel(tmp_path, body=body, rules="cuda-rounding")
    assert code == 1 and ("cuda-rounding", line) in findings(out), out
    assert "k.cu" in out


def test_cuda_rounding_only_under_fmad_false(tmp_path):
    """A library built with FMA contraction on is a float library: its
    double arithmetic is not policed (its flag rule fires instead)."""
    code, out, _ = _kernel(tmp_path, body="return a * b + c;", flags="()",
                           rules="cuda-rounding")
    assert code == 0, out


@pytest.mark.parametrize("body,flags", [(ROUNDED, "()"),
                                        ("return a * b;", FMAD)])
def test_cuda_fmad_flag_fires(tmp_path, body, flags):
    code, out, _ = _kernel(tmp_path, body=body, flags=flags,
                           rules="cuda-fmad-flag")
    assert code == 1 and findings(out) == [("cuda-fmad-flag", 14)], out


def test_cuda_fmad_flag_clean_on_a_float_library(tmp_path):
    code, out, _ = _kernel(tmp_path, body="return a * b;", flags="()",
                           rules="cuda-fmad-flag")
    assert code == 0, out


@pytest.mark.parametrize("argtypes", [
    "[_P] * 2 + [_I, _D]",              # one entry short
    "[_P] * 3 + [_I, _D, _P]",          # one too many
    "list(_P for _ in range(5))",       # does not fold
    "ARGS"])                            # a name bound to nothing
def test_ctypes_arity_fires(tmp_path, argtypes):
    code, out, _ = _kernel(tmp_path, argtypes=argtypes,
                           rules="ctypes-arity")
    assert code == 1 and findings(out) == [("ctypes-arity", 16)], out


@pytest.mark.parametrize("argtypes,restype", [
    ("[_P] * 2 + [_I, _I, _P]", "_I"),   # c_int where the C side is double
    ("[_P] * 2 + [_D, _D, _P]", "_I"),   # c_double where it is int
    ("[_P] * 2 + [_I, _D, _I]", "_I"),   # c_int for the stream pointer
    (GOOD_ARGS, "_D")])                  # restype: the C side returns int
def test_ctypes_type_fires(tmp_path, argtypes, restype):
    code, out, _ = _kernel(tmp_path, argtypes=argtypes, restype=restype,
                           rules="ctypes-type")
    assert code == 1 and len(findings(out)) == 1, out
    assert findings(out)[0][0] == "ctypes-type"


def test_ctypes_rules_clean_on_equivalent_forms(tmp_path):
    """Tuples, ``ctypes.`` attributes, the ``lib.<fn>`` form and a list
    repeated on the left all fold to the C signature."""
    src = BINDING.format(flags=FMAD, argtypes="(ctypes.c_void_p,) * 2 + "
                         "(_I, ctypes.c_double, _P)", restype="_I")
    src = src.replace("fn = built.lib.k_launch\n        fn.argtypes",
                      "lib = built.lib\n        lib.k_launch.argtypes")
    src = src.replace("fn.restype", "lib.k_launch.restype")
    code, out, _ = _run(tmp_path, {"k.py": src,
                                   "k.cu": SOURCE.format(body=ROUNDED)})
    assert code == 0, out


def _copy_sched(tmp_path):
    """The shipped scheduling binding and its source, in ``tmp_path``."""
    (tmp_path / "csrc").mkdir(parents=True)
    shutil.copy(PKG / "core" / "backends" / "cuda.py", tmp_path)
    shutil.copy(PKG / "core" / "backends" / "csrc" / "sched_kernels.cu",
                tmp_path / "csrc")
    return tmp_path / "cuda.py", tmp_path / "csrc" / "sched_kernels.cu"


KERNEL_RULES = "ctypes-arity,ctypes-type,cuda-rounding,cuda-fmad-flag"


def _plant(tmp_path, site, fault):
    """The shipped scheduling binding and source with ``site`` (found
    once) replaced by ``fault``; returns the binding and the line."""
    py, cu = _copy_sched(tmp_path)
    text = cu.read_text()
    assert text.count(site) == 1, site
    cu.write_text(text.replace(site, fault))
    return py, text[:text.index(site)].count("\n") + 1


def test_shipped_sources_are_clean_and_checked(tmp_path):
    """Each shipped binding, with its source, is clean under the kernel
    rules, and the pass did read the scheduling source: a planted bare
    add in ``sched_kernels.cu`` (the hop's Eq. 14 sum, in the kernels'
    real type) is found at its line."""
    for py in (PKG / "core" / "backends" / "cuda.py",
               PKG / "kernels" / "flash_attention" / "kernel.py",
               PKG / "kernels" / "ssm_scan" / "kernel.py"):
        code, out, _ = run_port([str(py), "--rules", KERNEL_RULES])
        assert code == 0, out
    py, line = _plant(tmp_path, "const F x_ = radd(lst, x.c[i]);",
                      "const F x_ = lst + x.c[i];")
    code, out, _ = run_port([str(py), "--rules", KERNEL_RULES])
    assert code == 1 and findings(out) == [("cuda-rounding", line)], out


@pytest.mark.parametrize("site,fault", [
    # a float operand: the f32 rounding step itself
    ("  return __fadd_rn(a, b);", "  return a + b;"),
    ("  return __fdiv_rn(a, b);", "  return a / b;"),
    # a template-typed operand (the kernels' real type F): Def. 4.1's
    # 1 + lop * alpha, and Eq. 14's first hop
    ("c_bp = radd(F(1), rmul(c_lop, alpha));\n      }\n    }\n  } else {",
     "c_bp = F(1) + rmul(c_lop, alpha);\n      }\n    }\n  } else {"),
    ("  hi[0] = radd(lo[0], c[0]);", "  hi[0] = lo[0] + c[0];"),
    ("  value = rmul(a, D.is_exit ? F(1) : S.bp[q]);",
     "  value = a * (D.is_exit ? F(1) : S.bp[q]);")],
    ids=["float-add", "float-div", "template-def41", "template-eq14",
         "template-value"])
def test_planted_real_type_rounding_faults_are_found(tmp_path, site, fault):
    """A bare operator on a ``float`` operand, or on one of the kernels'
    template real type, in a copy of ``sched_kernels.cu`` is flagged at
    its line: in either instantiation it would round differently from
    the reference (a contraction, or a step in the wrong type)."""
    py, line = _plant(tmp_path, site, fault)
    code, out, _ = run_port([str(py), "--rules", "cuda-rounding"])
    assert code == 1 and findings(out) == [("cuda-rounding", line)], out


def test_shipped_f32_entry_points_are_bound_exactly(tmp_path):
    """The float32 entry points are bound with ``c_float`` scalars: a
    ``c_double`` alpha on ``sched_wave_launch_f32`` is a type finding,
    one entry short on ``sched_plan_launch_f32`` an arity finding."""
    py, _ = _copy_sched(tmp_path)
    text = py.read_text()
    good = "[_P] * 12 + [_F, _F] + [_P] * 18 + [_I] * 7 + [_P]"
    assert text.count(good) == 1
    py.write_text(text.replace(good, good.replace("[_F, _F]", "[_D, _F]")))
    code, out, _ = run_port([str(py), "--rules", KERNEL_RULES])
    assert code == 1 and [r for r, _ in findings(out)] == ["ctypes-type"]
    assert "sched_wave_launch_f32.argtypes[12] is c_double" in out
    good = "[_P] * 13 + [_F] + [_P] * 22 + [_I] * 12 + [_P]"
    assert text.count(good) == 1
    py.write_text(text.replace(good, good.replace("[_I] * 12", "[_I] * 11")))
    code, out, _ = run_port([str(py), "--rules", KERNEL_RULES])
    assert code == 1 and [r for r, _ in findings(out)] == ["ctypes-arity"]
    assert "sched_plan_launch_f32.argtypes has 48 entries" in out


def test_shipped_binding_one_entry_short(tmp_path):
    py, _ = _copy_sched(tmp_path)
    text = py.read_text()
    good = "[_P] * 12 + [_D, _D] + [_P] * 18 + [_I] * 7 + [_P]"
    assert text.count(good) == 1
    py.write_text(text.replace(good, good.replace("[_P] * 18",
                                                  "[_P] * 17")))
    code, out, _ = run_port([str(py), "--rules", KERNEL_RULES])
    assert code == 1 and [r for r, _ in findings(out)] == ["ctypes-arity"]
    assert "sched_wave_launch.argtypes has 39 entries" in out
