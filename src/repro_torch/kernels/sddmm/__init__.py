"""gSDDMM kernel: per-edge binary op, gather and un-permute fused (ROADMAP B3)."""
