"""Plain PyTorch references, one per app, in fp32 with TF32 off. They
work from the caller-order COO, the features and the weights the
benchmark made, and import nothing of the program."""
