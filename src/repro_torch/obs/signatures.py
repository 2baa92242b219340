"""Compile-signature accounting (port of ``repro/obs/signatures.py``).

PyTorch runs eagerly, so no step recompiles; the tracker keeps the serve
tier's contract anyway — every served batch lands on one of a bounded
set of static signatures — and fails loudly when that bound breaks. A
new signature bumps the registry counter ``signatures.<name>.compiles``,
as in JAX, so signature counts appear in metrics snapshots.
"""
from typing import Set, Tuple

from . import metrics as _metrics

__all__ = ["SignatureTracker"]


class SignatureTracker:
    """Counts distinct static shape signatures seen by a step."""

    def __init__(self, limit: int = 4, name: str = "default"):
        self.limit = limit
        self.name = name
        self.seen: Set[Tuple] = set()

    def observe(self, signature: Tuple) -> bool:
        """Record a signature; True if it is new."""
        new = signature not in self.seen
        self.seen.add(signature)
        if new:
            _metrics.counter(f"signatures.{self.name}.compiles").inc()
        return new

    def assert_bounded(self) -> None:
        if len(self.seen) > self.limit:
            raise RuntimeError(
                f"{len(self.seen)} distinct shape signatures (> "
                f"{self.limit}) in {self.name!r}: static padding is broken")

    def observe_checked(self, signature: Tuple) -> bool:
        """Observe, and enforce the bound when the signature is new."""
        new = self.observe(signature)
        if new:
            self.assert_bounded()
        return new
