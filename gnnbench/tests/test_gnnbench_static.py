"""The benchmark's files against its contract, read without running."""
import ast
import json
import re
from pathlib import Path

import pytest

from gnnbench.harness import reader_path

from .conftest import BENCH, ROOT, SPEC

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: Path):
    """Top-level names of every module ``path`` imports, whole."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(node.args[0].value.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tops = imported_tops(path)
        assert "repro_torch" not in tops and not tops & FORBIDDEN, path
        assert "gnnbench" not in tops or path.name == "__init__.py", path


def test_whole_name_comparison(monkeypatch):
    import sys
    import types

    from gnnbench.harness import forbidden_modules
    for name in list(sys.modules):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "repro"):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_x", types.ModuleType("x"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("y"))
    assert forbidden_modules() == ["repro"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["gnnbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entry(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and len(cfg["why"]) <= 200
    assert len(cfg["source"]) <= 200
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert cfg["file"] == f"gnnbench/configs/{cfg['name']}.json"
    assert body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"]
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in body
        assert body[key] != body["published"][key]
    assert body["assumed"]
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])
    # the files the configuration names, and its size for the CPU tests
    for path in (f"graphs/{body['graph']}.py", f"reference/{body['app']}.py",
                 f"costs/model_{body['app']}.py"):
        assert (BENCH / path).is_file(), path
    assert isinstance(body["tiny"], dict) and body["tiny"]
    assert set(body["tiny"]) <= set(body) - {"tiny", "published"}


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_entry(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    body = json.loads((BENCH / "workloads"
                       / f"{cell['name']}.json").read_text())
    for key in ("config", "traffic", "chips", "why"):
        assert body[key] == cell[key]
    assert (BENCH / "modes" / f"{body['mode']}.py").is_file()
    assert body["limits"] and all(v > 0 for v in body["limits"].values())
    e2e = [m for m in SPEC["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any(cell["name"] in m["workloads"] for m in SPEC["per_layer"])


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in SPEC["end_to_end"]:
        allowed |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert reader_path(BENCH, metric["name"]).is_file()
        assert "\n" not in metric["layer"]
    assert set(metric) <= allowed
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    names = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", [])) <= names
    if "moves" in metric:
        moved = next(m for m in SPEC["end_to_end"]
                     if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads",
                                                         names))


def test_reader_falls_back_to_the_name_without_its_suffix(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "mfu.py").write_text("")
    (tmp_path / "metrics" / "mfu.serve.py").write_text("")
    assert reader_path(tmp_path, "mfu.train").name == "mfu.py"
    assert reader_path(tmp_path, "mfu.serve").name == "mfu.serve.py"
    assert not reader_path(tmp_path, "idle.train").is_file()
