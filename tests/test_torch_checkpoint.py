"""Port of ``tests/launch/test_checkpoint.py`` for
``repro_torch.checkpoint``, plus the cross-package reads:

* round trip, latest-good skips a corrupt step, an incomplete step is
  rejected, retention, shape mismatch, and the train CLI's resume with
  ``--device cpu`` (the resumed steps equal an uninterrupted run's);
* an fp32 LM train state written by either package restores in the other,
  leaf for leaf;
* a bfloat16 leaf written by JAX restores in the port (JAX's own
  ``load_pytree`` cannot cast its ``|V2`` array back, ROADMAP C8), and the
  port writes a bfloat16 leaf byte for byte as JAX does.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.checkpoint import save_pytree as jax_save_pytree
from repro.configs import get_smoke_config
from repro.launch import steps as jax_steps
from repro.launch.train import synthetic_batch as jax_synthetic_batch
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.launch import steps, train


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.tensor(rng.normal(size=(8, 4)),
                                         dtype=torch.float32),
                       "b": torch.tensor(rng.normal(size=(4,)),
                                         dtype=torch.float32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros_like(tree):
    return jax.tree.map(torch.zeros_like, tree)


def _assert_equal_trees(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_roundtrip(tmp_path):
    s = _state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(s, 10)
    restored, step = mgr.restore_latest(_zeros_like(s), device="cpu")
    assert step == 10
    _assert_equal_trees(s, restored)
    assert restored["step"].dtype == torch.int32


def test_latest_good_skips_corrupt(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    s1, s2 = _state(1), _state(2)
    mgr.save(s1, 1)
    mgr.save(s2, 2)
    (tmp_path / "step_2" / "params.w.npy").write_bytes(b"garbage")
    restored, step = mgr.restore_latest(_zeros_like(s1))
    assert step == 1
    _assert_equal_trees(s1["params"]["w"], restored["params"]["w"])


def test_incomplete_checkpoint_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    s = _state()
    mgr.save(s, 5)
    man = tmp_path / "step_9"
    man.mkdir()
    (man / "manifest.json").write_text(json.dumps({"complete": False,
                                                   "leaves": {}}))
    _, step = mgr.restore_latest(_zeros_like(s))
    assert step == 5


def test_retention_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    s = _state()
    for i in (1, 2, 3, 4):
        mgr.save(s, i)
    assert mgr.steps() == [3, 4]


def test_shape_mismatch_raises(tmp_path):
    save_pytree(_state(), str(tmp_path / "x"))
    bad = {"params": {"w": torch.zeros((9, 4)), "b": torch.zeros((4,))},
           "step": torch.zeros((), dtype=torch.int32)}
    with pytest.raises(ValueError):
        load_pytree(bad, str(tmp_path / "x"))


def test_train_resume_cli(tmp_path, capsys):
    """Train 4 steps, stop, resume from the checkpoint and finish at 6:
    the resumed steps' losses equal an uninterrupted 6-step run's."""
    base = ["--arch", "llama3p2_3b", "--smoke", "--batch", "2", "--seq",
            "16", "--ckpt-every", "2", "--log-every", "1", "--device", "cpu"]
    train.main(base + ["--ckpt-dir", str(tmp_path / "a"), "--steps", "4"])
    resumed = train.main(base + ["--ckpt-dir", str(tmp_path / "a"),
                                "--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert "step=5" in out
    whole = train.main(base + ["--ckpt-dir", str(tmp_path / "b"),
                              "--steps", "6"])
    assert resumed["start_step"] == 4
    assert resumed["losses"] == whole["losses"][4:]


def test_train_cli_mesh_raises():
    """``--mesh`` with no process group up (and no ``torchrun``
    environment) says how to start the ranks; the mesh run itself is
    ``tests/test_torch_lm_mesh.py``'s."""
    with pytest.raises(RuntimeError, match="needs 4 ranks, have 0.*torchrun"):
        train.main(["--arch", "llama3p2_3b", "--smoke", "--device", "cpu",
                    "--mesh", "2x2"])


def _jax_trained_state(cfg):
    """JAX's llama smoke train state after one step (moments non-zero)."""
    state = jax_steps.init_state(jax.random.PRNGKey(0), cfg)
    state, _ = jax.jit(jax_steps.make_train_step(cfg))(
        state, jax_synthetic_batch(cfg, 0, 2, 16))
    return state


def _port_state_tree(cfg):
    state = steps.init_state(cfg, seed=5, device="cpu")
    state, _ = steps.make_train_step(cfg)(
        state, train.synthetic_batch(cfg, 0, 2, 16, device="cpu"))
    return state, steps.state_tree(state)


def test_port_restores_jax_lm_checkpoint(tmp_path):
    cfg = get_smoke_config("llama3p2_3b")
    ref = _jax_trained_state(cfg)
    JaxManager(str(tmp_path)).save(ref, 1)
    state = steps.init_state(cfg, seed=1, device="cpu")
    tree, step = CheckpointManager(str(tmp_path)).restore_latest(
        steps.state_tree(state))
    state = steps.load_state_tree(state, tree)
    assert step == 1 and state.step == int(ref.step) == 1
    _assert_equal_trees(steps.state_tree(state), ref)


def test_jax_restores_port_lm_checkpoint(tmp_path):
    cfg = get_smoke_config("llama3p2_3b")
    state, tree = _port_state_tree(cfg)
    CheckpointManager(str(tmp_path)).save(tree, 1)
    template = jax_steps.init_state(jax.random.PRNGKey(0), cfg)
    restored, step = JaxManager(str(tmp_path)).restore_latest(template)
    assert step == 1 and int(restored.step) == state.step == 1
    _assert_equal_trees(restored, tree)


def test_jax_bf16_leaf_restores_in_port(tmp_path):
    """ROADMAP C8: JAX writes a bfloat16 leaf as ``<V2``; the port reads
    it by the manifest's dtype, bit for bit."""
    bits = np.random.default_rng(0).integers(0, 1 << 16, (3, 5)).astype(
        np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0x3F80   # no inf / nan patterns
    ref = jnp.asarray(bits.view(jnp.bfloat16))
    jax_save_pytree({"w": ref, "n": jnp.asarray(3, jnp.int32)},
                    str(tmp_path / "j"))
    got = load_pytree({"w": torch.zeros((3, 5), dtype=torch.bfloat16),
                       "n": torch.zeros((), dtype=torch.int32)},
                      str(tmp_path / "j"))
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(),
                                  bits.view(np.int16))
    assert int(got["n"]) == 3

    save_pytree({"w": got["w"], "n": got["n"]}, str(tmp_path / "p"))
    for name in ("w.npy", "n.npy"):
        assert ((tmp_path / "p" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    man = json.loads((tmp_path / "p" / "manifest.json").read_text())
    assert man == json.loads((tmp_path / "j" / "manifest.json").read_text())
    assert man["leaves"]["w"]["dtype"] == "bfloat16"
