"""NN building blocks of the port."""
