"""Port parity for the LM mesh's spec logic and the MoE's mesh-aligned
token blocks (``repro_torch.pjit_utils``, ``repro_torch.launch.shardings``,
``launch.steps.eval_param_shapes``, ``models/lm/moe._block_layout``)
against the JAX package; no process group.

* For every arch's FULL config: ``eval_param_shapes`` gives JAX's shapes
  and dtypes; on the (16, 16), (2, 16, 16), (2, 4) and (4, 2) meshes,
  with and without FSDP, ``param_specs`` equals JAX's ``PartitionSpec``s
  leaf for leaf and each leaf's per-rank shard shape equals JAX's
  ``NamedSharding.shard_shape``; ``batch_specs`` (train / prefill / decode
  at B = 1, 4, 256 and unsized) and ``cache_specs`` (prefill / decode,
  several S) equal JAX's. JAX's side uses an ``AbstractMesh``; the port's
  a ``MeshShape``.
* ``resolve_axis``, ``make_spec``, ``_attn_parallel_mode`` and
  ``_block_layout`` follow JAX's; ``shard_hint`` is the identity on a
  plain tensor.
* MoE blocking in one process: granite's and mixtral's smoke ``loss_fn``
  (B = 4, S = 32, fp32) under ``ambient_mesh(MeshShape((2, 4)))`` equal
  JAX's ``loss_fn`` under ``ambient_mesh`` of a real (2, 4) mesh (a
  ``run_multidevice`` child, 8 emulated devices) within 1e-5 relative,
  grads within 1e-4·max|JAX| + 1e-6; with no mesh, JAX's one-device
  loss. The case has power: JAX's one-device loss lies outside the
  tolerance of its mesh loss (gaps 3.4e-5 and 1.9e-4 relative).
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro import pjit_utils as jpj
from repro.configs import ARCHS, get_config
from repro.launch import shardings as JS
from repro.launch import steps as jax_steps
from repro.models.lm import layers as jlayers
from repro.models.lm import moe as jmoe
from repro_torch import pjit_utils as tpj
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_smoke_config
from repro_torch.launch import shardings as TS
from repro_torch.launch import steps, train
from repro_torch.models.lm import layers as tlayers
from repro_torch.models.lm import model as T
from repro_torch.models.lm import moe as tmoe
from tests.conftest import run_multidevice
from tests.test_torch_lm import close

MESHES = [(16, 16), (2, 16, 16), (2, 4), (4, 2)]
MOE_ARCHS = ("granite_moe_3b", "mixtral_8x22b")
MOE_TOL = 1e-5


def _names(shape):
    return ("pod", "data", "model")[-len(shape):]


def _meshes(shape):
    """(JAX's AbstractMesh, the port's MeshShape) of ``shape``."""
    return AbstractMesh(shape, _names(shape)), tpj.MeshShape(shape)


def _leaves(tree, path=()):
    """(path, leaf) of a tree of nested dicts, keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         path + (k,))]
    return [(path, tree)]


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    return jax_steps.eval_param_shapes(get_config(arch))


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    return steps.eval_param_shapes(t_get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_param_shapes_match_jax(arch):
    ref = _leaves(_jax_shapes(arch))
    got = _leaves(_port_shapes(arch))
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, r), (_, g) in zip(ref, got):
        assert tuple(g.shape) == tuple(r.shape), path
        assert str(g.dtype).split(".")[-1] == str(r.dtype), path
        assert g.device.type == "meta"


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_shard_shapes_match_jax(arch, mesh_shape, fsdp):
    jm, tm = _meshes(mesh_shape)
    ref = _leaves(JS.param_specs(_jax_shapes(arch), get_config(arch), jm,
                                 fsdp=fsdp))
    got = _leaves(TS.param_specs(_port_shapes(arch), t_get_config(arch), tm,
                                 fsdp=fsdp))
    shapes = _leaves(_port_shapes(arch))
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, r), (_, g), (_, leaf) in zip(ref, got, shapes):
        assert g == tuple(r), (path, g, r)
        want = NamedSharding(jm, r).shard_shape(tuple(leaf.shape))
        assert TS.shard_shape(leaf.shape, g, tm) == tuple(want), path


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_jax(arch, mesh_shape):
    jm, tm = _meshes(mesh_shape)
    jc, tc = get_config(arch), t_get_config(arch)
    for kind in ("train", "prefill", "decode"):
        for B in (None, 1, 4, 256):
            ref = JS.batch_specs(jc, kind, jm, batch_size=B)
            got = TS.batch_specs(tc, kind, tm, batch_size=B)
            assert got == {k: tuple(v) for k, v in ref.items()}, (kind, B)
    for kind in ("prefill", "decode"):
        for B, S in ((None, None), (1, 1), (4, 32), (256, 4096), (4, 100)):
            ref = jax.tree.map(tuple, JS.cache_specs(jc, jm, B, S, kind),
                               is_leaf=lambda x: isinstance(x, P))
            got = TS.cache_specs(tc, tm, B, S, kind)
            assert got == ref, (kind, B, S)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_resolve_axis_make_spec_and_hint_follow_jax(mesh_shape):
    jm, tm = _meshes(mesh_shape)
    for name in (None, "data", "model", ("data", "model"),
                 ("model", "data"), (None, "data")):
        assert tpj.resolve_axis(tm, name) == jpj.resolve_axis(jm, name)
        if name is not None:
            assert TS.resolve_axis(tm, name) == JS.resolve_axis(jm, name)
    axes = ("data", None, ("data", "model"))
    assert tpj.make_spec(tm, *axes) == tuple(jpj.make_spec(jm, *axes))
    x = torch.ones(2, 3)
    assert tpj.shard_hint(x, "data", None) is x
    with tpj.ambient_mesh(tm):
        assert tpj.current_mesh() is tm
        assert tpj.shard_hint(x, "data", "model") is x
    assert tpj.current_mesh() is None
    # placements: each mesh dim Shard(the dim naming it), mesh order
    from torch.distributed.tensor import Replicate, Shard
    spec = TS.pick_spec(tm, (4096, 4096, 128),
                        [(("data", "model"), None, None)])
    want = tuple(Shard(0) for _ in mesh_shape)
    assert TS.to_placements(spec, tm) == want
    assert TS.to_placements((None, None), tm) == tuple(
        Replicate() for _ in mesh_shape)


@pytest.mark.parametrize("mesh_shape", [None] + MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_mode_and_block_layout_follow_jax(arch, mesh_shape):
    jm, tm = _meshes(mesh_shape) if mesh_shape else (None, None)
    jc, tc = get_config(arch), t_get_config(arch)
    with jpj.ambient_mesh(jm), tpj.ambient_mesh(tm):
        for S in (1, 8, 16, 4096):
            assert tlayers._attn_parallel_mode(tc, S) == \
                jlayers._attn_parallel_mode(jc, S), S
        for B in (1, 2, 4, 32, 256):
            for S in (1, 32, 100, 4096):
                for small in (False, True):
                    assert tmoe._block_layout(B, S, small) == \
                        jmoe._block_layout(B, S, small), (B, S, small)
    if jc.n_experts:
        assert tmoe.small_ffn(tc) == (
            jc.n_experts * jc.d_ff * jc.d_model * 2 * 3 <= 512 * 1024 ** 2)


_MOE_PROG = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.launch.train import synthetic_batch
from repro.models.lm import model as J
from repro.pjit_utils import ambient_mesh

mesh = make_mesh((2, 4), ("data", "model"))
out = {}


def put(prefix, tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix, v, path + (k,))
    else:
        out[prefix + "/" + "/".join(path)] = np.asarray(tree)


for arch in sys.argv[2:]:
    cfg = get_smoke_config(arch)
    params = jax.jit(J.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                      cfg)
    batch = synthetic_batch(cfg, 0, 4, 32)
    put(arch + "/params", params)
    for where in ("mesh", "one"):
        f = jax.jit(jax.value_and_grad(lambda p, b: J.loss_fn(p, cfg, b)))
        with ambient_mesh(mesh if where == "mesh" else None):
            loss, grads = f(params, batch)
        out[f"{arch}/{where}/loss"] = np.asarray(loss)
        put(f"{arch}/{where}/grads", grads)
np.savez(sys.argv[1], **out)
print("MOE_MESH_OK")
"""


def _tree(flat: dict, prefix: str) -> dict:
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        *path, leaf = k[len(prefix) + 1:].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def jax_moe(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("moe_mesh") / "ref.npz")
    r = run_multidevice(_MOE_PROG, path, *MOE_ARCHS)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("where", ["mesh", "one"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_blocks_match_jax_mesh_loss(jax_moe, arch, where):
    cfg = get_smoke_config(arch)
    model = T.from_jax_params(cfg, _tree(jax_moe, arch + "/params"), "cpu")
    batch = train.synthetic_batch(cfg, 0, 4, 32, device="cpu")
    mesh = tpj.MeshShape((2, 4)) if where == "mesh" else None
    with tpj.ambient_mesh(mesh):
        loss = T.loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
    want = float(jax_moe[f"{arch}/{where}/loss"])
    np.testing.assert_allclose(float(loss.detach()), want, rtol=MOE_TOL)
    ref = _leaves(_tree(jax_moe, f"{arch}/{where}/grads"))
    got = _leaves(T.to_jax_tree(model, grads))
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, r), (_, g) in zip(ref, got):
        close(g, r, f"{arch} {where} grad {path}")
    # power: JAX's own mesh and one-device losses differ by more than
    # the tolerance, so a port without the blocking fails the mesh case
    mesh_l, one_l = (float(jax_moe[f"{arch}/{w}/loss"])
                     for w in ("mesh", "one"))
    assert abs(one_l - mesh_l) > MOE_TOL * abs(mesh_l), (one_l, mesh_l)
