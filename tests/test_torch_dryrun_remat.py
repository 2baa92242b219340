"""What attention keeps for the backward in the port's dry run, against
JAX's, on the CPU: ``zamba2_2p7b × train_4k`` (the shared attention block,
applied 9 times a step outside the block remat in both packages) and
``granite_moe_3b × train_4k`` (every attention block under it), each cell
run as ``test_torch_dryrun.py`` runs it, on the debug mesh, the port's with
``--peak-sites`` (what was alive at the temp's peak, by op and site).

JAX's ``blockwise_attention`` checkpoints each KV block's body
(``jax.checkpoint(body, nothing_saveable)``); the port's runs it under
``layers.remat``. Held, beside ``check_pair``'s equalities:

* each port temp (the peak of live bytes a rank) at most JAX's (when this
  was written: zamba2 410.5 of 646.8 GB, 1,741.3 while every KV block's
  scores and probabilities were kept; granite 55.0 of 127.7, 163.4);
* no ``exp`` / ``where`` of ``models/lm/layers.py`` alive at the peak
  holds more than one KV block's scores a rank (rows × heads × S × 512,
  float32: zamba2 8.59 GB, granite 6.44 GB) times the attention
  applications whose scores are alive at once. That number is 1 in both
  cells: a body's scores and probabilities are its locals, made by its
  forward or its recompute and dead when it returns, and the bodies run
  one at a time, inside a block's recompute or, for zamba2's shared
  block, in the step's own forward and backward. (With every block's
  kept it was 72 in zamba2, 9 applications × 8 KV blocks, and 8 in
  granite.) ``peak_sites`` lists the 20 largest sites; a site left out
  holds at most the 20th's bytes, held to the same bound;
* no collective reduces attention scores (``reduce_scores`` is set only
  by a decode call's head_dim split).
"""
import pytest

from repro_torch.configs import SHAPES, get_config
from tests.test_torch_dryrun import SCORES_SITE, check_pair, run_pairs

CASES = [("zamba2_2p7b", "train_4k"),     # hybrid: shared block outside
         ("granite_moe_3b", "train_4k")]  # MoE: every block rematted
IDS = [f"{a}:{s}" for a, s in CASES]
MESH = {"data": 2, "model": 4}            # debug-2x4
KV_BLOCK = 512
ALIVE_AT_ONCE = 1


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    return run_pairs(tmp_path_factory.mktemp("dryrun_remat"), CASES,
                     port_extra=("--peak-sites",))


def block_scores_bytes(arch: str, shape: str) -> int:
    """One KV block's float32 scores on a rank: its data rows, its heads
    of the model axis's split ('heads': the heads divide the axis), the
    whole sequence against ``KV_BLOCK`` keys."""
    cfg, sh = get_config(arch), SHAPES[shape]
    assert cfg.n_heads % MESH["model"] == 0
    rows = sh["global_batch"] // MESH["data"]
    return rows * cfg.n_heads // MESH["model"] * sh["seq_len"] * KV_BLOCK * 4


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_cell_matches_jax_on_debug_mesh(cells, arch, shape):
    check_pair(cells[("repro", arch, shape)],
               cells[("repro_torch", arch, shape)])


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_train_temp_at_most_jax(cells, arch, shape):
    port = cells[("repro_torch", arch, shape)]
    jax_cell = cells[("repro", arch, shape)]
    temp, jtemp = (c["memory_analysis"]["temp_size_in_bytes"]
                   for c in (port, jax_cell))
    print(f"{arch} × {shape}: temp {temp / 1e9:.2f} GB, JAX's "
          f"{jtemp / 1e9:.2f}")
    assert temp <= jtemp, f"temp {temp / 1e9:.1f} GB, JAX's {jtemp / 1e9:.1f}"


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_peak_holds_no_kv_blocks_scores(cells, arch, shape):
    port = cells[("repro_torch", arch, shape)]
    limit = block_scores_bytes(arch, shape) * ALIVE_AT_ONCE
    rows = port["peak_sites"]
    assert rows and sum(r["bytes"] for r in rows) > 0
    scores = [r for r in rows if r["site"].startswith("models/lm/layers.py:")
              and r["site"].split()[-1] in ("exp", "where")]
    for r in scores:
        assert r["bytes"] <= limit, (r, limit)
    if len(rows) == 20:
        assert rows[-1]["bytes"] <= limit, (rows[-1], limit)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_train_step_reduces_no_scores(cells, arch, shape):
    port = cells[("repro_torch", arch, shape)]
    assert port["collective_sites"]
    assert SCORES_SITE not in port["collective_sites"]
