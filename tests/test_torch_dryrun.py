"""The port's dry run (``repro_torch.launch.dryrun``, ``dryrun_all``)
against JAX's (``repro.launch.dryrun``), on the CPU.

Each cell runs as JAX's own smoke test runs it: ``python -m
<package>.launch.dryrun`` in a subprocess on the debug mesh
(``REPRO_DRYRUN_MESH=2x4``; JAX with 8 placeholder devices, the port as
rank 0 of an 8-rank ``fake`` group), JAX's and the port's of a cell at
the same time, under a timeout. Held: ``params``, ``active_params``,
``tokens_global`` and each rank's ``argument_size_in_bytes`` equal to
JAX's cell JSON; the FLOPs counted positive, their ratio to JAX's
``flops_hlo`` in the message and held near JAX's where the model axis
splits the cell's compute as GSPMD does (the dense train step, the SSM
decode's Mamba2 mixer over its heads, the SSM train step), and the
collective bytes a rank moves at most JAX's where the split moves what
GSPMD moves (the train steps: reductions in the activations' bf16, the
Mamba2 conv on the rank's heads with no gather). This file: the dense
train cell, the SSM long-context decode cell, the SSM train cell,
``llama3p2_3b × train_4k`` on the 256-rank pod mesh, and
``dryrun_all``'s skip and error JSONs; ``test_torch_dryrun_serve.py``
the enc-dec prefill and MoE decode cells; ``test_torch_dryrun_remat.py``
what attention keeps for the backward. The SSM decode cell's temp is
held at most 2.0 GB: its blocks are gathered one at a time; the dense
train cell's at most JAX's, with no collective on attention scores.
"""
import json
import os
import subprocess
import sys
import time

import pytest

CELL_TIMEOUT_S = 300
# the closure that sums a head_dim split's partial scores over 'model'
SCORES_SITE = "models/lm/layers.py:reduce"
CASES = [("llama3p2_3b", "train_4k"),       # dense train
         ("mamba2_1p3b", "long_500k"),      # SSM long-context decode
         ("mamba2_1p3b", "train_4k")]       # SSM train


def start_cell(package: str, arch: str, shape: str, out: str,
               mesh: str = "2x4", extra=()):
    """``python -m <package>.launch.dryrun`` of one cell, started."""
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    env.pop("REPRO_DRYRUN_MESH", None)
    if mesh:
        env["REPRO_DRYRUN_MESH"] = mesh
    if package == "repro":
        env["REPRO_DRYRUN_DEVICES"] = "8"
        env["JAX_PLATFORMS"] = "cpu"
    cmd = [sys.executable, "-m", f"{package}.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", out, *extra]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_cell(proc, out: str, deadline: float) -> dict:
    try:
        _, err = proc.communicate(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-3000:]
    with open(out) as f:
        cell = json.load(f)
    assert cell["ok"]
    return cell


def run_pairs(tmp, cases, port_extra=()) -> dict:
    """Every case's JAX cell and port cell (its CLI given ``port_extra``),
    all started at once."""
    procs = {}
    for arch, shape in cases:
        for pkg in ("repro", "repro_torch"):
            out = str(tmp / f"{pkg}__{arch}__{shape}.json")
            extra = port_extra if pkg == "repro_torch" else ()
            procs[(pkg, arch, shape)] = (
                start_cell(pkg, arch, shape, out, extra=extra), out)
    deadline = time.time() + CELL_TIMEOUT_S
    return {k: finish_cell(p, out, deadline)
            for k, (p, out) in procs.items()}


def check_pair(jax_cell: dict, port: dict) -> None:
    for k in ("arch", "shape", "kind", "n_chips", "params", "active_params",
              "tokens_global", "microbatch", "fsdp"):
        assert port[k] == jax_cell[k], k
    assert port["mesh"] == jax_cell["mesh"] == "debug-2x4"
    assert (port["memory_analysis"]["argument_size_in_bytes"]
            == jax_cell["memory_analysis"]["argument_size_in_bytes"])
    flops, jflops = port["tripaware"]["flops_hlo"], \
        jax_cell["tripaware"]["flops_hlo"]
    assert flops > 0 and port["cost_analysis"]["flops"] == flops, (
        f"port {flops:.4g} FLOPs a rank, JAX {jflops:.4g}: "
        f"{flops / jflops:.3f}×")
    for k in ("output_size_in_bytes", "alias_size_in_bytes",
              "temp_size_in_bytes"):
        assert port["memory_analysis"][k] > 0, k
    assert port["tripaware"]["collective_total"] > 0
    assert port["notes"]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    pod_out = str(tmp / "llama3p2_3b__train_4k__pod.json")
    pod = start_cell("repro_torch", "llama3p2_3b", "train_4k", pod_out,
                     mesh=None)
    res = run_pairs(tmp, CASES)
    res["pod"] = finish_cell(pod, pod_out, time.time() + CELL_TIMEOUT_S)
    return res


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}:{s}" for a, s in CASES])
def test_cell_matches_jax_on_debug_mesh(cells, arch, shape):
    check_pair(cells[("repro", arch, shape)],
               cells[("repro_torch", arch, shape)])


def _ratios(port: dict, jax_cell: dict, what: str) -> tuple:
    """Port / JAX FLOPs and collective bytes a device (JAX's loop bodies
    counted once per trip, as the port counts every op), printed."""
    flops, coll = (port["tripaware"][k] / jax_cell["tripaware"][k]
                   for k in ("flops_hlo", "collective_total"))
    print(f"{what}: port / JAX FLOPs a device {flops:.3f}, collective "
          f"bytes {coll:.3f}")
    return flops, coll


def test_train_cell_splits_the_model_axis(cells):
    """A rank of the port runs its share of the model axis's work on its
    data rows (TP / context-parallel attention, TP MLP, vocab-parallel
    head and CE, the sequence-parallel residual): at most JAX's FLOPs a
    device on (2, 4) (0.93× when this was written, with each KV block's
    scores recomputed in the backward as JAX's are; 0.91× before that;
    3.65× while every rank ran the whole model), with the residual's
    reduce-scatters, in bf16 as GSPMD's: at most JAX's collective bytes
    (0.64× when this was written; 1.13× while they reduced in float32).
    Its temp at most JAX's (130.2 of 224.3 GB when this was written;
    186.3 while every KV block's scores and probabilities were kept for
    the backward). No collective reduces attention scores: only a decode
    call's head_dim split posts ``reduce_scores``."""
    port = cells[("repro_torch", "llama3p2_3b", "train_4k")]
    jax_cell = cells[("repro", "llama3p2_3b", "train_4k")]
    ratio, coll = _ratios(port, jax_cell, "llama3p2_3b × train_4k")
    assert ratio <= 1.0, f"port / JAX FLOPs a device: {ratio:.3f}"
    assert coll <= 1.0, f"port / JAX collective bytes a device: {coll:.3f}"
    temp, jtemp = (c["memory_analysis"]["temp_size_in_bytes"]
                   for c in (port, jax_cell))
    assert temp <= jtemp, f"temp {temp / 1e9:.1f} GB, JAX's {jtemp / 1e9:.1f}"
    assert SCORES_SITE not in port["collective_sites"]
    assert port["collective_bytes"]["all-gather"] > 0
    assert port["collective_bytes"]["all-reduce"] > 0
    assert port["collective_bytes"]["reduce-scatter"] > 0


def test_ssm_train_cell_moves_at_most_jax_collective_bytes(cells):
    """The Mamba2 train step: the conv runs on the rank's heads' ``x``
    channels and all of ``B`` / ``C`` (no gather of its output; no
    collective site in ``mamba2_split``), the activations reduce in bf16:
    at most JAX's collective bytes a device (0.88× when this was written;
    3.14× with the conv's gather and float32 reductions), FLOPs within
    1.2× JAX's (a rank's ``in_proj`` runs its heads' ``x`` and all of
    ``B`` / ``C``, 2,320 columns where its conv chunk took 2,128)."""
    port = cells[("repro_torch", "mamba2_1p3b", "train_4k")]
    jax_cell = cells[("repro", "mamba2_1p3b", "train_4k")]
    ratio, coll = _ratios(port, jax_cell, "mamba2_1p3b × train_4k")
    assert ratio <= 1.2, f"port / JAX FLOPs a device: {ratio:.3f}"
    assert coll <= 1.0, f"port / JAX collective bytes a device: {coll:.3f}"
    sites = [r for r in port["top_collectives"]
             if r["site"] == "models/lm/mamba2.py:mamba2_split"]
    assert not sites, sites


def test_ssm_cell_splits_the_mixer(cells):
    """A rank runs its 16 of the 64 SSM heads of each Mamba2 mixer (its
    ``z`` / ``dt`` columns, its conv channels, ``out_proj``'s rows): its
    FLOPs within 1.2× JAX's a device (3.92× while every 'model' rank ran
    the mixer whole), its argument bytes JAX's."""
    port = cells[("repro_torch", "mamba2_1p3b", "long_500k")]
    jax_cell = cells[("repro", "mamba2_1p3b", "long_500k")]
    ratio = port["tripaware"]["flops_hlo"] / jax_cell["tripaware"][
        "flops_hlo"]
    print(f"mamba2_1p3b × long_500k: port / JAX FLOPs a device {ratio:.3f}")
    assert ratio <= 1.2, f"port / JAX FLOPs a device: {ratio:.3f}"
    assert (port["memory_analysis"]["argument_size_in_bytes"]
            == jax_cell["memory_analysis"]["argument_size_in_bytes"])


def test_long_decode_cell_gathers_per_block(cells):
    """A decode step gathers each block's leaves just before the block and
    frees them after it: ``mamba2_1p3b × long_500k``'s temp (the peak of
    live bytes) at most 2.0 GB (7.96 GB while a rank gathered a working
    copy of the whole model once a step; JAX's 0.68 GB)."""
    port = cells[("repro_torch", "mamba2_1p3b", "long_500k")]
    jax_cell = cells[("repro", "mamba2_1p3b", "long_500k")]
    temp = port["memory_analysis"]["temp_size_in_bytes"]
    print(f"mamba2_1p3b × long_500k: temp {temp / 1e9:.3f} GB, JAX's "
          f"{jax_cell['memory_analysis']['temp_size_in_bytes'] / 1e9:.3f}")
    assert temp <= 2.0e9, f"temp {temp / 1e9:.3f} GB"


def test_pod_mesh_cell(cells):
    pod = cells["pod"]
    assert (pod["mesh"], pod["n_chips"], pod["mesh_shape"]) == (
        "pod-16x16", 256, [16, 16])
    assert pod["tokens_global"] == 256 * 4096
    # a rank's data rows: 16 of 256 sequences (8× fewer than debug-2x4's
    # 128), its share of them 1/16 of the model axis's work (debug-2x4's
    # 1/4): a 32nd of the debug rank's FLOPs, a tenth of the 1.910e15 a
    # rank counted while it ran the whole model on its rows
    debug = cells[("repro_torch", "llama3p2_3b", "train_4k")]
    assert pod["tripaware"]["flops_hlo"] == pytest.approx(
        debug["tripaware"]["flops_hlo"] / 32, rel=1e-6)
    assert pod["tripaware"]["flops_hlo"] <= 1.91e14


def test_dryrun_all_skips_done_cells_and_writes_errors(tmp_path,
                                                       monkeypatch, capsys):
    from repro_torch.launch import dryrun_all

    monkeypatch.setattr(dryrun_all, "OUT_DIR", str(tmp_path))
    done = dryrun_all.cell_path("llama3p2_3b", "train_4k", False)
    with open(done, "w") as f:
        json.dump({"ok": True}, f)
    assert dryrun_all.run_one("llama3p2_3b", "train_4k", False)
    assert "[skip] llama3p2_3b__train_4k__pod.json" in capsys.readouterr().out
    # a cell that fails: its error JSON holds the stderr's tail
    assert not dryrun_all.run_one("no_such_arch", "train_4k", True,
                                  timeout=120)
    with open(dryrun_all.cell_path("no_such_arch", "train_4k", True)) as f:
        err = json.load(f)
    assert (err["ok"], err["mesh"]) == (False, "multipod")
    assert "no_such_arch" in err["stderr"]
    assert not dryrun_all.cell_done(dryrun_all.cell_path(
        "no_such_arch", "train_4k", True))
    # and one past its timeout
    assert not dryrun_all.run_one("mamba2_1p3b", "long_500k", False,
                                  timeout=0.01)
    with open(dryrun_all.cell_path("mamba2_1p3b", "long_500k", False)) as f:
        assert json.load(f)["stderr"] == "timeout"
