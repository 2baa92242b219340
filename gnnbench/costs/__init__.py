"""Bytes and operations each of the port's kernels needs for one call,
from its operands' shapes (``describe`` reads a call's arguments,
``cost`` gives ``(bytes, flops)``), and the model FLOPs of one unit of
each app (``model_<app>.py``). Bytes are counted as the port's kernel
table counts its ``bound`` column: index arrays, the node rows some edge
references, edge operands read once, the output written once."""
