"""A tiny copy of the benchmark for CPU runs of the harness: the real
files with each configuration shrunk to its ``tiny`` size; and the
cells of ``BENCHMARK.json`` that the tests run."""
import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def mode_of(cell: str) -> str:
    return json.loads((BENCH / "workloads"
                       / f"{cell}.json").read_text())["mode"]


TRAIN = [c for c in CELLS if mode_of(c) == "train_full"]


def make_tiny(dest: Path) -> Path:
    """``dest`` holds BENCHMARK.json and ``gnnbench/`` with each config
    shrunk by its own ``tiny`` keys; returns the copy's ``gnnbench``
    folder."""
    bench = dest / "gnnbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for p in (bench / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        cfg.update(cfg["tiny"])
        p.write_text(json.dumps(cfg))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    return bench


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(tmp_path)


def run_tiny(bench: Path, cell: str, trace: bool = False, seed: int = 7,
             seconds: float = 0.3):
    import torch

    from gnnbench.harness import run_cell
    torch.manual_seed(0)
    return run_cell(cell, seed, seconds, trace, device="cpu",
                    root=bench.parent, bench=bench)
