"""Copy-Reduce SpMM kernel (ROADMAP B1)."""
