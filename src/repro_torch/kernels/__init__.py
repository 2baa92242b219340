"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each with
its plain PyTorch version and a launch counter on its wrapper:

* ``spmm.ops.spmm_csr`` — Copy-Reduce SpMM (ROADMAP B1);
* ``edge_softmax.ops.fused_attention_csr`` — fused GAT attention
  (ROADMAP B2, forward);
* ``sddmm.ops.sddmm_csr`` — gSDDMM in caller edge order (B3);
* ``binary_reduce.ops.binary_reduce_csr`` — fused Binary-Reduce (B4);
* ``edge_softmax.ops.edge_softmax_csr`` — edge softmax (B5).

``dispatch`` routes the lattice's specs onto them; ``rowsplit`` cuts the
graph's rows into bounded edge segments, the work list B1, B2 and B5
launch over.

``_build`` compiles the sources with ``nvcc`` at first use.
"""
