"""The op-count analysis of the dry run (``repro_torch.launch.
op_analysis``, the counterpart of ``repro.launch.hlo_analysis``).

* FLOPs are trip-aware by construction: a 7-iteration loop of 64 × 64
  matmuls counts exactly 7·2·64³ (JAX's own test of ``hlo_analysis``
  allows 5% for its trip-count parse), on real and on fake tensors;
* known ops give exact operand + result bytes; views add none;
* on an 8-rank ``fake`` process group, an all-gather, an all-reduce and a
  reduce-scatter of known sizes (``c10d`` and ``_c10d_functional``) are
  counted under JAX's kind names, by JAX's convention (an all-gather's
  operand is the shard, a reduce-scatter's the whole input); the
  transport's ``fake`` branch issues its gathers there; a site is named
  by the tensors its operand was copied from;
* the peak of live bytes made in the mode, what was alive at it (by op
  and site), and which arguments were read.
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.op_analysis import COLLECTIVES, OpAnalysis


def _loop(x, w):
    for _ in range(7):
        x = x @ w
    return x


@pytest.mark.parametrize("fake", [False, True])
def test_loop_flops_are_trip_aware(fake):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode() if fake else torch.no_grad()
    with mode:
        x, w = torch.randn(64, 64), torch.randn(64, 64)
        with OpAnalysis() as oa:
            _loop(x, w)
    res = oa.analyze()
    assert res["flops_hlo"] == 7 * 2 * 64 ** 3
    assert res["ops"] == 7
    # each mm reads two 64 × 64 fp32 operands and writes one
    assert res["hbm_bytes_est"] == 7 * 3 * 64 * 64 * 4


def test_backward_flops_counted():
    x = torch.randn(16, 32, requires_grad=True)
    w = torch.randn(32, 8, requires_grad=True)
    with OpAnalysis() as oa:
        (x @ w).sum().backward()
    # forward 2·16·32·8, backward ∂x and ∂w the same each
    assert oa.analyze()["flops_hlo"] == 3 * 2 * 16 * 32 * 8


def test_known_op_bytes():
    a = torch.ones(4, 8)                   # 128 bytes
    b = torch.ones(8, 16, dtype=torch.bfloat16)
    with OpAnalysis() as oa:
        c = a + a                          # 3 × 128
        c.t()                              # a view: none
        c.view(32)                         # a view: none
        c.to(torch.bfloat16)               # 128 + 64
        c.to(torch.bfloat16) @ b           # 128 + 64, then 64 + 256 + 128
        float(c.sum())                     # 128 + 4; the scalar read: none
    want = 3 * 128 + (128 + 64) + (128 + 64) + (64 + 256 + 128) + (128 + 4)
    assert oa.analyze()["hbm_bytes_est"] == want


def test_live_bytes_and_reads():
    a, dst = torch.ones(1024), torch.empty(1024)
    with OpAnalysis() as oa:
        t = a * 2                          # 4 KiB live
        u = t + 1                          # 8 KiB live
        del t
        v = u * 3                          # t freed: 8 KiB live again
        dst.copy_(v)                       # dst overwritten whole: not read
    assert oa.peak == 2 * 4096
    assert oa.was_read(a) and not oa.was_read(dst)


def test_peak_sites_name_what_is_alive_at_the_peak():
    """``peak_sites=True``: the storages alive at the peak, by the op that
    made them (and the port's site, none from a test's own frame)."""
    a = torch.ones(1024)
    with OpAnalysis(peak_sites=True) as oa:
        t = a * 2                          # 4 KiB live
        u = t + 1                          # 8 KiB live: the peak
        del t
        v = u * 3
        del u, v
    assert oa.peak == 2 * 4096
    assert sorted((r["site"], r["bytes"]) for r in oa.peak_sites()) == [
        ("add", 4096), ("mul", 4096)]


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_collectives_on_a_fake_group(fake_group):
    import torch.distributed._functional_collectives as fc

    x = torch.ones(4, 8)                   # 128 bytes a rank
    with OpAnalysis() as oa:
        parts = [torch.empty_like(x) for _ in range(8)]
        dist.all_gather(parts, x)          # operand: the shard, 128
        dist.all_reduce(x)                 # 128
        out = torch.empty(4, 8)
        dist.reduce_scatter_tensor(out, torch.ones(32, 8))   # input, 1024
        fc.all_gather_tensor(x, 0, fake_group).wait()        # 128
        fc.all_reduce(x, "sum", fake_group).wait()           # 128
    res = oa.analyze()
    assert set(res["collective_bytes"]) <= set(COLLECTIVES)
    assert res["collective_bytes"] == {"all-gather": 256.0,
                                       "all-reduce": 256.0,
                                       "reduce-scatter": 1024.0}
    assert res["collective_counts"] == {"all-gather": 2, "all-reduce": 2,
                                        "reduce-scatter": 1}
    assert res["collective_total"] == 1536.0


def test_transport_fake_branch_names_its_sites(fake_group):
    from repro_torch.core import transport

    w = torch.ones(3, 5, dtype=torch.bfloat16)       # 30 bytes, padded 32
    b = torch.ones(2)                                # 8 bytes
    with OpAnalysis() as oa:
        oa.name({"blocks.0.attn.wq": w, "blocks.0.norm1.scale": b})
        got = transport.all_gather_cat([w, b], fake_group, [0, 0])
        transport.all_reduce_sum([b], fake_group)
    assert [tuple(t.shape) for t in got] == [(24, 5), (16,)]
    top = oa.top_collectives()
    gather = next(r for r in top if r["kind"] == "all-gather")
    assert gather["bytes_each"] == 40 and gather["count"] == 1
    assert gather["names"] == "blocks.0.attn.wq, blocks.0.norm1.scale"
    assert oa.analyze()["collective_bytes"] == {"all-gather": 40.0,
                                                "all-reduce": 8.0}
