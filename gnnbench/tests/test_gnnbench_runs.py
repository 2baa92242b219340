"""Whole runs of the harness on the CPU at each configuration's tiny
size (the port's plain versions stand in for its kernels), for every
cell of ``BENCHMARK.json``: the result line, the traced line, the
reference against the port, and the faults each cell can have, which
must read ``correct`` false; and a cell, a metric, an app and a graph
kind added by files alone."""
import functools
import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from .conftest import BENCH, CELLS, ROOT, SPEC, TRAIN, make_tiny, run_tiny

# the configurations that a training cell runs, with one such cell each
TRAIN_CONFIGS = {}
for _w in SPEC["workloads"]:
    if _w["name"] in TRAIN:
        TRAIN_CONFIGS.setdefault(_w["config"], _w["name"])
APPS = {c: json.loads((BENCH / "configs" / f"{c}.json").read_text())["app"]
        for c in TRAIN_CONFIGS}


def config_id(config: str) -> str:
    """The app's name where one training configuration runs the app."""
    app = APPS[config]
    return app if list(APPS.values()).count(app) == 1 else config


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
    host = [m["name"] for m in SPEC["per_layer"] if m["source"]
            == "host_clock" and cell in m.get("workloads", [cell])]
    assert host
    for name in host:                # the host's clock reads on the CPU
        assert r["metrics"][name]["value"] > 0, name


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


GCN_REFERENCE = '''"""GCN, plain PyTorch (Kipf & Welling 2017): h' = Σ over in-edges
(u → v) of (h·W + b)[u] / sqrt(deg_out(u)·deg_in(v)), degrees at least
1, ReLU between layers, dropout on each layer's input while training."""
import torch

from .common import dropout, matmul, neighbour_sum


def leaf_shapes(cfg):
    dims = ([cfg["features"]] + [cfg["hidden"]] * (cfg["layers"] - 1)
            + [cfg["classes"]])
    shapes = {}
    for i in range(cfg["layers"]):
        shapes[f"layers.{i}.w"] = (dims[i], dims[i + 1])
        shapes[f"layers.{i}.b"] = (dims[i + 1],)
    return shapes


def forward(params, inputs, cfg, gen=None):
    g = inputs["graph"]
    deg_out = torch.bincount(g.src, minlength=g.n).clamp(min=1).double()
    deg_in = g.in_deg.clamp(min=1).double()
    norm = (1.0 / torch.sqrt(deg_out[g.src] * deg_in[g.dst])).float()
    h = inputs["x"]
    for i in range(cfg["layers"]):
        if gen is not None:
            h = dropout(gen, h, cfg["dropout"])
        h = matmul(h, params[f"layers.{i}.w"]) + params[f"layers.{i}.b"]
        h = neighbour_sum(g, h, norm)
        if i < cfg["layers"] - 1:
            h = torch.relu(h)
    return h
'''

GCN_COSTS = '''"""Model FLOPs of GCN: the products and the weighted sums."""


def _dims(cfg):
    return ([cfg["features"]] + [cfg["hidden"]] * (cfg["layers"] - 1)
            + [cfg["classes"]])


def forward(cfg, n, e):
    d = _dims(cfg)
    return sum(2.0 * n * d[i] * d[i + 1] + 2.0 * e * d[i + 1]
               for i in range(cfg["layers"]))


def train_step(cfg, n, e):
    return 3.0 * forward(cfg, n, e)
'''

GCN_TOY_GRAPH = '''"""The rmat graph kind under another name."""
from gnnbench.graphs.rmat import (build, make_inputs, n_edges,
                                  reference_inputs)

__all__ = ["build", "make_inputs", "n_edges", "reference_inputs"]
'''


def file_hashes(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_app_and_graph_kind_by_files_alone(tiny):
    """An app that no configuration names (the port's GCN), its graph
    kind, reference, model costs, workload and entries in BENCHMARK.json,
    all new files: its training cell runs untraced and traced, correct,
    and no file that was there changes."""
    before = file_hashes(tiny.parent)
    spec_path = tiny.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    small = {"nodes": 240, "edges": 2000, "features": 12, "classes": 4,
             "train_nodes": 150, "hidden": 8}
    sage = json.loads((tiny / "configs" / "sage-reddit.json").read_text())
    source = "GCN, 2 layers, hidden 16: Kipf & Welling 2017, arXiv:1609.02907"
    cfg = {"name": "gcn-toy", "source": source, "app": "gcn",
           "graph": "gcn_toy", "layers": 2, "dropout": 0.5,
           "self_loops": True, "precision": "fp32", "tf32": False,
           **{k: sage[k] for k in ("rmat_a", "rmat_b", "rmat_c",
                                   "optimizer")},
           "port_forward": {"drop": 0.5}, "published": {}, "reduced": [],
           "assumed": ["R-MAT edges, as the rmat graph kind makes them"],
           **small, "tiny": small}
    wl = json.loads((tiny / "workloads"
                     / "sage-reddit.train.json").read_text())
    wl.update(name="gcn-toy.train", config="gcn-toy", why="a test cell")
    new = {"configs/gcn-toy.json": json.dumps(cfg),
           "workloads/gcn-toy.train.json": json.dumps(wl),
           "graphs/gcn_toy.py": GCN_TOY_GRAPH,
           "reference/gcn.py": GCN_REFERENCE,
           "costs/model_gcn.py": GCN_COSTS}
    for rel, text in new.items():
        assert not (tiny / rel).exists(), rel
        (tiny / rel).write_text(text)
    spec["configs"].append({"name": "gcn-toy", "source": source,
                            "file": "gnnbench/configs/gcn-toy.json",
                            "reduced": [], "why": "a test configuration"})
    spec["workloads"].append({"name": "gcn-toy.train", "config": "gcn-toy",
                              "traffic": wl["traffic"], "chips": 1,
                              "why": "a test cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "sage-reddit.train" in m.get("workloads", []):
            m["workloads"].append("gcn-toy.train")
    spec_path.write_text(json.dumps(spec))
    r = run_tiny(tiny, "gcn-toy.train", seed=3)
    assert r["correct"] is True and r["failed"] == 0
    assert {"epoch_ms", "setup_s", "peak_gib"} <= set(r["metrics"])
    r = run_tiny(tiny, "gcn-toy.train", trace=True, seed=3)
    assert r["correct"] is True
    assert r["metrics"]["graph_build_s"]["value"] > 0
    assert r["metrics"]["step_host_ms.train"]["value"] > 0
    changed = [p for p, h in before.items() if p != spec_path
               and hashlib.sha256(p.read_bytes()).hexdigest() != h]
    assert changed == []


@pytest.mark.parametrize("config", sorted(TRAIN_CONFIGS), ids=config_id)
def test_reference_matches_port(tiny, config):
    """The plain reference and the port's app agree at the configuration's
    tiny size, on inputs and a graph from its graph kind: the forward
    without dropout, and three training steps."""
    from gnnbench.harness import Cell, Context
    from gnnbench.inputs import (build_graph, make_inputs, port_model,
                                 port_module, reference_inputs,
                                 reference_module)
    from gnnbench.reference.common import train_steps
    from repro_torch.models.gnn import train as port_train

    cell = Cell(TRAIN_CONFIGS[config], tiny.parent, tiny)
    ctx = Context(cell, 11, torch.device("cpu"), False, 0.3)
    cfg = ctx.config
    inp = make_inputs(ctx)
    graph = build_graph(ctx, inp)
    model = port_model(cfg, inp["leaves"], "cpu")
    ref = reference_module(ctx)
    inputs = reference_inputs(ctx, inp)
    mod = port_module(cfg)
    with torch.no_grad():
        got = mod.forward(model, graph, inp["x"], strategy="segment",
                          **{k: v for k, v in cfg["port_forward"].items()
                             if k != "drop"})
        want = ref.forward(inp["leaves"], inputs, cfg)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)

    opt = cfg["optimizer"]
    init, step = port_train.make_train_step(
        functools.partial(mod.forward, **cfg["port_forward"]), "segment",
        lr=opt["lr"], weight_decay=opt["weight_decay"], clip=opt["clip"])
    state = init(model)
    gen = torch.Generator().manual_seed(5)
    losses = []
    for i in range(3):
        state, loss = step(model, state, i, graph, inp["x"],
                           inp["labels"], inp["train_mask"], gen)
        losses.append(float(loss))
    r = train_steps(lambda p, ins, gn: ref.forward(p, ins, cfg, gn),
                    inp["leaves"], inputs, opt, 3,
                    torch.Generator().manual_seed(5))
    assert r["losses"] == pytest.approx(losses, rel=1e-5)
    for name, p in model.named_parameters():
        assert float((p.detach() - inp["leaves"][name]).norm()) == \
            pytest.approx(r["change_norms"][name], rel=1e-4)


def test_gat_reference_kink_as_the_port():
    """At a logit of exactly 0.0 the reference's leaky-relu has the
    port's gradient (1; ``F.leaky_relu``'s is the slope): a logit that
    rounds to 0.0 on both sides must not part them."""
    from gnnbench.reference.gat import leaky_relu
    from repro_torch.substrate.nn import leaky_relu as port_leaky_relu
    grads = []
    for fn in (lambda e: leaky_relu(e, 0.2), port_leaky_relu):
        e = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
        grads.append(torch.autograd.grad(fn(e).sum(), e)[0])
    assert torch.equal(grads[0], grads[1])
    assert grads[0].tolist() == pytest.approx([0.2, 1.0, 1.0])


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
