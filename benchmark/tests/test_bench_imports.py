"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program; names compared whole, up to the
first dot."""

import glob
import json
import os
import subprocess
import sys

import pytest

from benchmark.core import guard, spec as spec_mod

ROOT = spec_mod.ROOT
BENCH = os.path.join(ROOT, "benchmark")


def _modules(pattern):
    out = []
    for path in sorted(glob.glob(os.path.join(BENCH, pattern),
                                 recursive=True)):
        rel = os.path.relpath(path, ROOT)[:-3]
        if "/tests/" in path or "/_cache/" in path:
            continue
        out.append(rel)
    return out


def _loaded_after(imports, by_path=()):
    """Top-level names in sys.modules of a fresh process after importing
    ``imports`` (dotted) and loading ``by_path`` files."""
    code = ("import sys, json, importlib, importlib.util\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            f"for m in {list(imports)!r}: importlib.import_module(m)\n"
            f"for i, p in enumerate({list(by_path)!r}):\n"
            "    s = importlib.util.spec_from_file_location(f'm{i}', p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_top_level_names_compared_whole():
    mods = ["privacy_preserving_sfm_torch.optim", "jaxtyping", "jax.numpy",
            "privacy_preserving_sfm_tpu_extra", "privacy_preserving_sfm_tpu"]
    assert guard.loaded(guard.FORBIDDEN, mods) == [
        "jax.numpy", "privacy_preserving_sfm_tpu"]
    assert guard.loaded([guard.PROGRAM], mods) == [
        "privacy_preserving_sfm_torch.optim"]


def test_benchmark_modules_load_no_jax():
    mods = [m.replace("/", ".") for m in _modules("**/*.py")
            if not m.endswith("__init__") and "/metrics/" not in m
            and not m.endswith("run") and not m.endswith("readings")]
    readers = sorted(glob.glob(os.path.join(BENCH, "metrics", "*.py")))
    scripts = [os.path.join(BENCH, "run.py"),
               os.path.join(BENCH, "readings.py")]
    names = _loaded_after(mods, readers + scripts)
    assert guard.loaded(guard.FORBIDDEN, names) == []


@pytest.mark.parametrize("module", [m.replace("/", ".") for m in
                                    _modules("reference/*.py")])
def test_reference_loads_nothing_of_the_program(module):
    names = _loaded_after([module])
    assert guard.loaded([guard.PROGRAM], names) == []
    assert guard.loaded(guard.FORBIDDEN, names) == []
