"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each with
its plain PyTorch version and a launch counter on its wrapper:

* ``spmm.ops.spmm_csr`` — Copy-Reduce SpMM (ROADMAP B1);
* ``edge_softmax.ops.fused_attention_csr`` — fused GAT attention
  (ROADMAP B2, forward).

``_build`` compiles the sources with ``nvcc`` at first use.
"""
