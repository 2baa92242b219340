"""A tiny copy of the benchmark for CPU runs of the harness: the real
files with each configuration shrunk to a few hundred nodes."""
import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TINY = {"nodes": 300, "edges": 3000, "features": 16, "classes": 5,
        "train_nodes": 180}
TINY_APP = {"sage": {"hidden": 8}, "gat": {"heads": 2, "hidden": 4}}


def make_tiny(dest: Path) -> Path:
    """``dest`` holds BENCHMARK.json and ``gnnbench/`` with tiny configs;
    returns the copy's ``gnnbench`` folder."""
    bench = dest / "gnnbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for p in (bench / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        cfg.update(TINY, **TINY_APP[cfg["app"]])
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
