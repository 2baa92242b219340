"""Port parity for the LM stack's training path (``repro_torch.models.lm``
and ``repro_torch.launch.{steps,train}`` against the JAX package).

Same numpy inputs (seeded), same weights (``from_jax_params`` of
``repro.models.lm.init_params`` at each smoke config), float32:

* per architecture: ``loss_fn`` within 1e-5 relative; grads leaf by leaf,
  through ``to_jax_tree``, within 1e-4·max|JAX| + 1e-6;
* the per-block checkpointing changes no result (bit-equal grads);
* three ``make_train_step`` steps against JAX's, microbatch 1 and 2 (the
  vlm positions split on axis 1): losses within 1e-5 relative, μ and ν
  within 1e-4·max|JAX| + 1e-6, and params within 1e-4·max|JAX| plus 1% of
  the most AdamW moves an element in those steps (lr per step): the
  normalised update of an element whose grad sits near rounding noise
  does not scale with the grad, so a leaf that starts at zero (the qkv
  biases) differs from JAX's by a fraction of lr, not of its values;
* ``synthetic_batch`` equal to JAX's, per architecture.

The train CLI's resume test is in ``tests/test_torch_checkpoint.py``, as
JAX's is in ``tests/launch/test_checkpoint.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.launch import steps as jax_steps
from repro.launch.train import synthetic_batch as jax_synthetic_batch
from repro.models.lm import model as J
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps, train
from repro_torch.models.lm import model as T
from tests.test_torch_lm import batch_np, close_tree, jax_case


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    cfg, params, model = jax_case(arch)
    batch = batch_np(cfg)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        functools.partial(J.loss_fn, cfg=cfg)))(
            params, batch={k: jnp.asarray(v) for k, v in batch.items()})
    loss_t = T.loss_fn(model, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    grads_t = torch.autograd.grad(loss_t, list(model.parameters()))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    close_tree(T.to_jax_tree(model, grads_t), grads_j, "grad")


@pytest.mark.parametrize("arch", ["whisper_medium", "zamba2_2p7b",
                                  "granite_moe_3b"])
def test_block_checkpointing_changes_no_result(arch, monkeypatch):
    cfg, _, model = jax_case(arch)
    batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg).items()}
    out = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(T, "_remat", lambda fn, *args: fn(*args))
        loss = T.loss_fn(model, batch)
        out.append([loss] + list(torch.autograd.grad(
            loss, list(model.parameters()))))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def _port_state(cfg, params):
    model = T.from_jax_params(cfg, jax.tree.map(np.asarray, params), "cpu")
    zeros = [torch.zeros(p.shape) for p in model.parameters()]
    return steps.TrainState(model, zeros, [z.clone() for z in zeros], 0)


@pytest.mark.parametrize("arch,microbatch", [
    ("llama3p2_3b", 1), ("qwen2_vl_2b", 2), ("granite_moe_3b", 2)])
def test_train_steps_match_jax(arch, microbatch):
    cfg = get_smoke_config(arch)
    state_j = jax.jit(jax_steps.init_state, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    state_t = _port_state(cfg, state_j.params)
    step_j = jax.jit(jax_steps.make_train_step(cfg, microbatch=microbatch))
    step_t = steps.make_train_step(cfg, microbatch=microbatch)
    for i in range(3):
        batch = jax_synthetic_batch(cfg, i, 4, 16)
        state_j, mj = step_j(state_j, batch)
        state_t, mt = step_t(state_t, {k: torch.tensor(np.asarray(v))
                                       for k, v in batch.items()})
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-4)
    assert state_t.step == int(state_j.step) == 3
    tree = steps.state_tree(state_t)
    close_tree(tree.mu, state_j.mu, "mu")
    close_tree(tree.nu, state_j.nu, "nu")
    moved = 1e-2 * 3e-4 * 3     # 1% of lr (the default) × 3 steps
    for (path, ref), got in zip(
            jax.tree_util.tree_flatten_with_path(state_j.params)[0],
            jax.tree_util.tree_leaves(tree.params)):
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max() + moved, \
            (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_batch_matches_jax(arch):
    cfg = get_smoke_config(arch)
    ref = jax_synthetic_batch(cfg, 7, 2, 12, seed=3)
    got = train.synthetic_batch(cfg, 7, 2, 12, seed=3, device="cpu")
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
