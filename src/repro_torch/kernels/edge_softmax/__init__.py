"""Fused GAT attention kernel (ROADMAP B2, forward)."""
