"""Whole runs of the harness on the CPU at a tiny size (the port's plain
versions stand in for its kernels): the result line, the traced line, a
cell and a metric added by files alone, the reference against the port,
and the faults each cell can have, which must read ``correct`` false."""
import json
import os
import subprocess
import sys

import pytest
import torch

from .conftest import BENCH, ROOT, make_tiny, run_tiny

CELLS = ["sage-reddit.train", "gat-reddit.train", "gat-reddit.refresh"]
TRAIN = CELLS[:2]


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(tiny, cell):
    r = run_tiny(tiny, cell)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    spec = json.loads((tiny.parent / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(r["metrics"]) == want
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line(tiny, cell):
    r = run_tiny(tiny, cell, trace=True)
    assert r["correct"] is True
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "graph_build_s" in r["metrics"]
    host = "step_host_ms.train" if "train" in cell else \
        "refresh_store_ms.refresh"
    assert r["metrics"][host]["value"] > 0


def test_new_cell_and_metric_by_files_alone(tiny):
    """A configuration, a cell and a per-layer metric dropped in as files
    (and entries in BENCHMARK.json) run with no edit to any file."""
    spec_path = tiny.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    cfg = json.loads((tiny / "configs" / "sage-reddit.json").read_text())
    cfg.update(name="sage-wide", hidden=12, nodes=200, edges=1500)
    (tiny / "configs" / "sage-wide.json").write_text(json.dumps(cfg))
    wl = json.loads((tiny / "workloads"
                     / "sage-reddit.train.json").read_text())
    wl.update(name="sage-wide.train", config="sage-wide")
    (tiny / "workloads" / "sage-wide.train.json").write_text(json.dumps(wl))
    (tiny / "metrics" / "units_traced.py").write_text(
        "def read(obs):\n    return float(obs['units'])\n")
    spec["configs"].append(dict(spec["configs"][0], name="sage-wide",
                                file="gnnbench/configs/sage-wide.json"))
    spec["workloads"].append({"name": "sage-wide.train",
                              "config": "sage-wide", "traffic": wl["traffic"],
                              "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "units_traced", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "trainer and server",
                              "moves": "epoch_ms",
                              "workloads": ["sage-wide.train"]})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "sage-reddit.train" in m.get("workloads", []):
            m["workloads"].append("sage-wide.train")
    spec_path.write_text(json.dumps(spec))
    r = run_tiny(tiny, "sage-wide.train", trace=True)
    assert r["correct"] is True
    assert r["metrics"]["units_traced"]["value"] >= 3
    r = run_tiny(tiny, "sage-wide.train")
    assert "epoch_ms" in r["metrics"]


@pytest.mark.parametrize("app", ["sage", "gat"])
def test_reference_matches_port(app):
    """The plain reference and the port's app agree at a small size: the
    forward without dropout, and three training steps."""
    from gnnbench.data.graph import glorot_leaves, node_data, rmat_edges
    from gnnbench.inputs import port_model, port_module, reference_module
    from gnnbench.reference.common import ref_graph, train_steps
    from repro_torch.core.graph import from_coo
    from repro_torch.models.gnn import train as port_train
    from repro_torch.models.gnn.common import make_bundle

    cfg = json.loads((BENCH / "configs" / f"{app}-reddit.json").read_text())
    cfg.update(nodes=400, edges=5000, features=24, classes=6,
               train_nodes=250, hidden=8, heads=2)
    src, dst = rmat_edges(cfg["nodes"], cfg["edges"], 11, "cpu")
    data = node_data(cfg["nodes"], 24, 6, 250, 11, "cpu")
    ref = reference_module(cfg)
    leaves = glorot_leaves(ref.leaf_shapes(cfg), 11, "cpu")
    g = from_coo(src.numpy(), dst.numpy(), n_src=400, n_dst=400,
                 device="cpu")
    bundle = make_bundle(g)
    model = port_model(cfg, leaves, "cpu")
    inputs = {"graph": ref_graph(src, dst, 400), **data}
    mod = port_module(cfg)
    with torch.no_grad():
        got = mod.forward(model, bundle, data["x"], strategy="segment",
                          **{k: v for k, v in cfg["port_forward"].items()
                             if k != "drop"})
        want = ref.forward(leaves, inputs, cfg)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)

    import functools
    opt = cfg["optimizer"]
    init, step = port_train.make_train_step(
        functools.partial(mod.forward, **cfg["port_forward"]), "segment",
        lr=opt["lr"], weight_decay=opt["weight_decay"], clip=opt["clip"])
    state = init(model)
    gen = torch.Generator().manual_seed(5)
    losses = []
    for i in range(3):
        state, loss = step(model, state, i, bundle, data["x"],
                           data["labels"], data["train_mask"], gen)
        losses.append(float(loss))
    r = train_steps(lambda p, ins, gn: ref.forward(p, ins, cfg, gn), leaves,
                    inputs, opt, 3, torch.Generator().manual_seed(5))
    assert r["losses"] == pytest.approx(losses, rel=1e-5)
    for name, p in model.named_parameters():
        assert float((p.detach() - leaves[name]).norm()) == pytest.approx(
            r["change_norms"][name], rel=1e-4)


# ------------------------------------------------------------------ #
# faults: the timed path broken underneath, correct must read false
# ------------------------------------------------------------------ #
def _unchanged_step(real):
    def make(*a, **kw):
        init, step = real(*a, **kw)

        def broken(model, opt_state, i, *args):
            keep = [p.detach().clone() for p in model.parameters()]
            _, loss = step(model, opt_state, i, *args)
            with torch.no_grad():
                for p, k in zip(model.parameters(), keep):
                    p.copy_(k)
            return opt_state, loss
        return init, broken
    return make


def _half_batch_step(real):
    def make(*a, **kw):
        init, step = real(*a, **kw)

        def broken(model, opt_state, i, bundle, x, labels, mask, gen):
            idx = mask.nonzero()[:, 0]
            half = mask.clone()
            half[idx[: idx.numel() // 2]] = False
            return step(model, opt_state, i, bundle, x, labels, half, gen)
        return init, broken
    return make


def _one_leaf_frozen_step(real):
    def make(*a, **kw):
        init, step = real(*a, **kw)

        def broken(model, opt_state, i, *args):
            leaf = list(model.parameters())[-1]
            keep = leaf.detach().clone()
            out = step(model, opt_state, i, *args)
            with torch.no_grad():
                leaf.copy_(keep)
            return out
        return init, broken
    return make


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "one_leaf_frozen"])
def test_training_fault_reads_incorrect(tiny, monkeypatch, cell, fault):
    from repro_torch.models.gnn import train as port_train
    wrap = {"state_unchanged": _unchanged_step,
            "half_batch": _half_batch_step,
            "one_leaf_frozen": _one_leaf_frozen_step}[fault]
    monkeypatch.setattr(port_train, "make_train_step",
                        wrap(port_train.make_train_step))
    assert run_tiny(tiny, cell)["correct"] is False


@pytest.mark.parametrize("fault", ["answer_altered", "half_rows",
                                   "non_finite"])
def test_refresh_fault_reads_incorrect(tiny, monkeypatch, fault):
    from repro_torch.models.gnn import gat
    real = gat.infer

    def broken(*a, **kw):
        out = real(*a, **kw).clone()
        if fault == "answer_altered":
            out[3] = out[4]
        elif fault == "half_rows":
            out[: out.shape[0] // 2] = 0.0
        else:
            out[5, 1] = float("nan")
        return out
    monkeypatch.setattr(gat, "infer", broken)
    r = run_tiny(tiny, "gat-reddit.refresh")
    assert r["correct"] is False
    assert r["failed"] == (r["attempted"] if fault == "non_finite" else 0)


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_incorrect(tiny, cell):
    """The control (the reference in TF32 in the program's place) fails
    at least one of the cell's limits, here at a tiny size."""
    from gnnbench.control import readings
    from gnnbench.harness import Cell, compare
    limits = Cell(cell, tiny.parent, tiny).workload["limits"]
    row = readings(cell, [9], device="cpu", root=tiny.parent, bench=tiny,
                   seconds=0.3)[0]
    assert compare(row["program"], limits)[0] is True
    assert compare(row["control_tf32"], limits)[0] is False
    for kind, nums in row.items():
        if kind.startswith("fault"):
            assert compare(nums, limits)[0] is False, kind


def test_no_card_no_result(tmp_path):
    """Without the cell's CUDA devices the run exits non-zero and prints
    no result; so it does in a folder holding only BENCHMARK.json and
    ``gnnbench/``."""
    make_tiny(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd in (ROOT, tmp_path):
        r = subprocess.run([sys.executable, "gnnbench/run.py", "--workload",
                            "sage-reddit.train", "--seed", "1", "--seconds",
                            "1", "--trace", "0"], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and r.stdout.strip() == ""
