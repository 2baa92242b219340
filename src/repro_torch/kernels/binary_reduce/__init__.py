"""Fused Binary-Reduce kernel (ROADMAP B4)."""
