"""The port's examples (``examples/torch_*.py``), each the counterpart of
the JAX example of the same name on ``repro_torch`` alone, run on the CPU
(``--device cpu``) at a few steps: the quickstart's Copy-Reduce is the
same under every strategy (and equal to the graph's adjacency), its GCN
loss falls; the GAT example's composed and fused edge softmax agree; the
LM example serves a smoke config; the training driver writes checkpoints
and a second run resumes from the last one.
"""
import importlib.util
import os

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    outs, hist = _example("torch_quickstart").main(
        ["--device", "cpu", "--epochs", "3"])
    want = np.zeros((3, 3), np.float32)
    for s, d in ((0, 2), (1, 2), (2, 1), (0, 1)):
        want[d, s] = 1.0
    for strategy, got in outs.items():
        np.testing.assert_allclose(got, want, err_msg=strategy)
    assert np.isfinite(hist["loss"]).all()
    assert hist["loss"][-1] < hist["loss"][0]
    assert "planner chose:" in capsys.readouterr().out


def test_gat_attention():
    res = _example("torch_gat_attention").main(["--device", "cpu",
                                                "--reps", "1"])
    assert res["max_err"] <= 1e-5
    assert len(res["ms"]) == 2


def test_serve_lm():
    res = _example("torch_serve_lm").main(
        ["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen",
         "4"])
    assert res["arch"] == "qwen2-7b-smoke"
    assert tuple(res["tokens"].shape) == (2, 4)


def test_train_gnn_e2e_resumes(tmp_path):
    e2e = _example("torch_train_gnn_e2e")
    args = ["--device", "cpu", "--dataset", "tiny", "--ckpt-every", "3",
            "--ckpt-dir", str(tmp_path)]
    first = e2e.main(args + ["--steps", "3"])
    assert first["start"] == 0 and np.isfinite(first["loss"])
    assert os.path.isdir(tmp_path / "step_3")
    second = e2e.main(args + ["--steps", "5"])
    assert second["start"] == 3 and np.isfinite(second["loss"])
