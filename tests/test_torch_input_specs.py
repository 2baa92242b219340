"""Port parity for the dry run's abstract inputs
(``repro_torch.launch.input_specs`` against ``repro.launch.input_specs``).

For every live (arch × shape) cell of ``configs.cells()`` (33), the
port's meta tensors have the keys, shapes and dtypes of JAX's
``ShapeDtypeStruct`` trees: the train batch (tokens, labels, frames,
positions), the serve tokens / token, ``pos``, the extras and the whole
cache tree; and the kind, B, S and config are JAX's.
"""
import dataclasses

import jax
import pytest
import torch

from repro.configs import cells as jax_cells
from repro.launch.input_specs import input_specs as jax_input_specs
from repro_torch.configs import cells
from repro_torch.launch.input_specs import input_specs

CELLS = cells()


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat(tree[key], path + (key,)).items()}
    return {"/".join(path): tree}


def test_the_grid_is_jaxs():
    assert CELLS == jax_cells()
    assert len(CELLS) == 33


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}:{s}" for a, s in CELLS])
def test_input_specs_match_jax(arch, shape):
    got, want = input_specs(arch, shape), jax_input_specs(arch, shape)
    assert set(got) == set(want)
    for k in ("kind", "B", "S"):
        assert got[k] == want[k], k
    assert dataclasses.asdict(got["cfg"]) == dataclasses.asdict(want["cfg"])
    trees = [k for k in want if k not in ("kind", "cfg", "B", "S")]
    for k in trees:
        g, w = _flat(got[k]), _flat(jax.tree.map(lambda x: x, want[k]))
        assert set(g) == set(w), (k, sorted(g), sorted(w))
        for name, leaf in w.items():
            t = g[name]
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(leaf.shape), (k, name)
            assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), \
                (k, name, t.dtype, leaf.dtype)
    if want["kind"] == "decode":
        assert got["pos"].shape == torch.Size([])
