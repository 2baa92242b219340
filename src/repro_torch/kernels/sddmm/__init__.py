"""gSDDMM kernel: per-edge binary op in caller edge order (ROADMAP B3)."""
