"""Fused GAT attention (ROADMAP B2, forward) and edge softmax (B5) kernels."""
