"""Port parity: ``repro_torch.core.graph`` against ``repro.core.graph``.

Every index array of the port's :class:`Graph` — host copies and device
tensors — equals the JAX ``from_coo`` one on the same numpy COO input,
including empty destination rows and duplicate edges. The caller-order
endpoints ``src_caller`` / ``dst_caller`` equal the ``src_c`` / ``dst_c``
of the JAX ``gather`` plan (``repro/core/binary_reduce.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import add_self_loops as jax_add_self_loops
from repro.core.graph import from_coo as jax_from_coo
from repro_torch.core.graph import add_self_loops, from_coo
from tests.graphgen import random_edges
from tests.test_torch_harness import jax_c1_shim  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_c1_shim")

FIELDS = ("src", "dst", "eid", "indptr_dst", "indptr_src", "perm_src",
          "eid_inv")

# (n_src, n_dst, nnz, unique): duplicates, empty rows, rectangular
CASES = [(40, 30, 200, False), (50, 200, 60, False), (300, 20, 900, False),
         (64, 64, 256, True), (1, 5, 3, False), (7, 9, 0, False)]


@pytest.mark.parametrize("n_src,n_dst,nnz,unique", CASES)
def test_index_arrays_equal_jax(n_src, n_dst, nnz, unique):
    rng = np.random.default_rng(nnz + n_src)
    src, dst = random_edges(rng, n_src, n_dst, nnz, unique=unique)
    jg = jax_from_coo(src, dst, n_src=n_src, n_dst=n_dst)
    tg = from_coo(src, dst, n_src=n_src, n_dst=n_dst, device="cpu")
    assert (tg.n_src, tg.n_dst, tg.n_edges) == (jg.n_src, jg.n_dst,
                                                jg.n_edges)
    for f in FIELDS:
        ref = np.asarray(getattr(jg, f))
        host = getattr(tg.host, f)
        dev = getattr(tg, f)
        assert host.dtype == np.int32 and dev.dtype == torch.int32, f
        np.testing.assert_array_equal(host, ref, err_msg=f)
        np.testing.assert_array_equal(dev.numpy(), ref, err_msg=f)
        np.testing.assert_array_equal(tg.long(f).numpy(), ref, err_msg=f)
    np.testing.assert_array_equal(tg.in_degrees.numpy(),
                                  np.asarray(jg.in_degrees))
    np.testing.assert_array_equal(tg.out_degrees.numpy(),
                                  np.asarray(jg.out_degrees))


def test_duplicates_and_empty_rows_are_present():
    """The cases above really contain what they claim to cover."""
    rng = np.random.default_rng(200 + 50)
    src, dst = random_edges(rng, 50, 200, 60)
    g = from_coo(src, dst, n_src=50, n_dst=200, device="cpu")
    assert (g.host.in_degrees == 0).sum() > 100
    rng = np.random.default_rng(900 + 300)
    src, dst = random_edges(rng, 300, 20, 900)
    pairs = np.stack([src, dst], 1)
    assert len(np.unique(pairs, axis=0)) < len(pairs)


def test_add_self_loops_equals_jax():
    rng = np.random.default_rng(1)
    src, dst = random_edges(rng, 30, 30, 80)
    for a, b in zip(add_self_loops(src, dst, 30),
                    jax_add_self_loops(src, dst, 30)):
        np.testing.assert_array_equal(a, b)


def test_from_coo_validates_input():
    with pytest.raises(ValueError):
        from_coo([0, 5], [0, 1], n_src=3, n_dst=3, device="cpu")
    with pytest.raises(ValueError):
        from_coo([0, 1], [0], device="cpu")


def test_to_same_device_is_identity():
    g = from_coo([0, 1], [1, 0], device="cpu")
    assert g.to("cpu") is g


@pytest.mark.parametrize("n_src,n_dst,nnz,unique", CASES)
def test_caller_order_endpoints_match_jax_gather_plan(n_src, n_dst, nnz,
                                                      unique):
    rng = np.random.default_rng(nnz + n_src)
    src, dst = random_edges(rng, n_src, n_dst, nnz, unique=unique)
    jg = jax_from_coo(src, dst, n_src=n_src, n_dst=n_dst)
    tg = from_coo(src, dst, n_src=n_src, n_dst=n_dst, device="cpu")
    for name, canon, given in (("src_caller", "src", src),
                               ("dst_caller", "dst", dst)):
        got = getattr(tg, name)
        assert got.dtype == torch.int32 and got.device == tg.device
        assert got.is_contiguous() and got.shape == (tg.n_edges,)
        ref = np.asarray(jnp.take(getattr(jg, canon), jg.eid_inv))
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
        host = getattr(tg.host, canon)[tg.host.eid_inv]
        np.testing.assert_array_equal(got.numpy(), host, err_msg=name)
        # caller order is the order the edges were given in
        np.testing.assert_array_equal(got.numpy(), given, err_msg=name)


def test_caller_order_endpoints_are_built_once_per_graph():
    rng = np.random.default_rng(5)
    src, dst = random_edges(rng, 40, 30, 200)
    tg = from_coo(src, dst, n_src=40, n_dst=30, device="cpu")
    a, b = tg.src_caller, tg.dst_caller
    assert tg.src_caller is a and tg.dst_caller is b
    assert tg.long("src_caller") is tg.long("src_caller")
    other = from_coo(src, dst, n_src=40, n_dst=30, device="cpu")
    assert other.src_caller is not a
    assert torch.equal(other.src_caller, a)
