"""Core graph structures and aggregation primitives of the port."""
from .binary_reduce import (BRSpec, binary_reduce, copy_reduce, gspmm,
                            gsddmm, parse_op)
from .blocks import BlockGraph, block_gspmm, serve_block_signature
from .edge_softmax import (block_edge_softmax, block_fused_attention,
                           edge_softmax, edge_softmax_fused, fused_attention)
from .graph import Graph, add_self_loops, from_coo

__all__ = ["Graph", "from_coo", "add_self_loops", "BRSpec", "parse_op",
           "gspmm", "gsddmm", "copy_reduce", "binary_reduce", "edge_softmax",
           "edge_softmax_fused", "fused_attention", "BlockGraph",
           "block_gspmm", "serve_block_signature", "block_edge_softmax",
           "block_fused_attention"]
