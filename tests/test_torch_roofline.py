"""The roofline at H100 constants (``repro_torch.launch.roofline``, port of
``repro.launch.roofline``): ``roofline_row`` on a cell JSON of each
package gives the terms computed here by hand at the stated constants
(989.4 TFLOP/s, 3.35 TB/s, NVLink 450 GB/s within a node, 50 GB/s a GPU
across nodes), and JAX's analytic memory model on its own pod mesh.
"""
import json

import pytest

from repro.launch import roofline as jax_roofline
from repro_torch.launch import roofline

N_LLAMA, N_WHISPER = 3_212_918_784, 811_108_352


def test_constants_are_the_datasheets():
    assert roofline.PEAK_FLOPS == 989.4e12
    assert roofline.HBM_BW == 3.35e12
    assert (roofline.NVLINK_BW, roofline.NET_BW) == (450e9, 50e9)


def test_port_cell_on_the_debug_mesh():
    """A port train cell on (2, 4): 8 GPUs, one node, NVLink."""
    r = {"arch": "llama3p2_3b", "shape": "train_4k", "kind": "train",
         "mesh": "debug-2x4", "mesh_shape": [2, 4], "n_chips": 8,
         "active_params": N_LLAMA, "tokens_global": 256 * 4096,
         "package": "repro_torch",
         "tripaware": {"flops_hlo": 1.5e16, "collective_total": 1.7e10},
         "memory_analysis": {"argument_size_in_bytes": 4_022_013_956,
                             "temp_size_in_bytes": 7e11}}
    row = roofline.roofline_row(r)
    # model 4, data 2: 128 sequences a rank
    act = 128 * 4096 * 3072 * 2 / 4
    hbm = (3 * 2 * N_LLAMA / 4 + 32 * N_LLAMA / 8 + 8 * act * 28
           + 2 * 2 * 128 * 4096 * 128256 * 4 / 4)
    assert row["t_compute_s"] == pytest.approx(1.5e16 / 989.4e12, rel=1e-12)
    assert row["t_memory_s"] == pytest.approx(hbm / 3.35e12, rel=1e-12)
    assert row["t_collective_s"] == pytest.approx(1.7e10 / 450e9, rel=1e-12)
    assert row["bottleneck"] == "compute"
    model_dev = 6 * N_LLAMA * 256 * 4096 / 8
    assert row["useful_ratio"] == pytest.approx(model_dev / 1.5e16,
                                                rel=1e-12)
    assert row["roofline_fraction"] == pytest.approx(
        model_dev / 989.4e12 / row["t_compute_s"], rel=1e-12)
    assert row["arg_bytes_dev"] == 4_022_013_956


def test_jax_cell_on_the_pod_mesh(tmp_path):
    """A JAX prefill cell as JAX writes it (no ``mesh_shape``: the label
    says 16 × 16); 256 GPUs span nodes, so 50 GB/s; the memory term is
    JAX's own model's."""
    r = {"arch": "whisper_medium", "shape": "prefill_32k", "kind": "prefill",
         "mesh": "pod-16x16", "n_chips": 256, "active_params": N_WHISPER,
         "tokens_global": 32 * 32768, "ok": True,
         "tripaware": {"flops_hlo": 7.2e13, "collective_total": 2.0e10},
         "memory_analysis": {}}
    row = roofline.roofline_row(r)
    act = 2 * 32768 * 1024 * 2 / 16                # B_loc 2, model 16
    cache = 48 * 2 * 16 * 64 * 32768 * 32 * 2
    hbm = 2 * N_WHISPER / 16 + 4 * act * 48 + cache / 256
    assert row["t_memory_s"] == pytest.approx(hbm / 3.35e12, rel=1e-12)
    assert jax_roofline.analytic_hbm_bytes(r) == pytest.approx(hbm,
                                                               rel=1e-12)
    assert row["t_collective_s"] == pytest.approx(2.0e10 / 50e9, rel=1e-12)
    assert row["t_compute_s"] == pytest.approx(7.2e13 / 989.4e12, rel=1e-12)
    assert row["bottleneck"] == "collective"
    assert row["package"] == "repro"
    # load_cells reads it back; --md prints its row
    with open(tmp_path / "whisper_medium__prefill_32k__pod.json", "w") as f:
        json.dump(r, f)
    assert [c["arch"] for c in roofline.load_cells("pod", str(tmp_path))] \
        == ["whisper_medium"]


def test_md_table(tmp_path, capsys):
    r = {"arch": "mamba2_1p3b", "shape": "long_500k", "kind": "decode",
         "mesh": "pod-16x16", "mesh_shape": [16, 16], "n_chips": 256,
         "active_params": 1_343_625_216, "tokens_global": 1, "ok": True,
         "tripaware": {"flops_hlo": 2.7e9, "collective_total": 1.7e9}}
    with open(tmp_path / "mamba2_1p3b__long_500k__pod.json", "w") as f:
        json.dump(r, f)
    roofline.main(["--md", "--out-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("| arch | shape | mesh |")
    assert lines[2].startswith("| mamba2_1p3b | long_500k | pod-16x16 |")
    assert "| collective |" in lines[2]
