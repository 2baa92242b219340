"""Harness for the PyTorch port's parity tests (``tests/test_torch_*.py``).

* :func:`jax_c1_shim` — jax 0.9 dropped ``jax.core.trace_state_clean``,
  which the JAX package calls on its eager paths (ROADMAP C1). The port's
  tests reach those paths as their reference, so this fixture installs
  ``jax._src.core.trace_state_clean`` under the old name for the
  duration of ONE test and restores the module afterwards. The reference
  suite's own tests run exactly as they would without the port.
  Other test files import the fixture and apply it with
  ``pytestmark = pytest.mark.usefixtures("jax_c1_shim")``.
* The no-JAX guard: the port imports neither ``jax`` nor ``repro``.
"""
import contextlib
import pathlib
import re
import subprocess
import sys

import jax
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@contextlib.contextmanager
def c1_shim():
    """``jax.core.trace_state_clean`` exists inside the block only."""
    mp = pytest.MonkeyPatch()
    if not hasattr(jax.core, "trace_state_clean"):
        from jax._src import core as jax_src_core
        mp.setattr(jax.core, "trace_state_clean",
                   jax_src_core.trace_state_clean, raising=False)
    try:
        yield
    finally:
        mp.undo()


@pytest.fixture
def jax_c1_shim():
    with c1_shim():
        yield


def test_shim_installs_and_restores():
    before = vars(jax.core).get("trace_state_clean")
    with c1_shim():
        assert jax.core.trace_state_clean()
    assert vars(jax.core).get("trace_state_clean") is before


_GUARD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in ("jax", "repro"))
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax_or_repro():
    """Every port module (and chip_smoke) imports with ``jax`` and
    ``repro`` blocked in ``sys.modules``."""
    prog = _GUARD.format(src=str(ROOT / "src"), root=str(ROOT))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 20


_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)",
                        re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_has_no_jax_or_repro_import(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.findall(text), path
