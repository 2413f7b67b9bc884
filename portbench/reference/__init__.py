"""Plain PyTorch references the benchmark holds the port against.

Nothing here imports the port, the JAX package or JAX, and nothing takes a
table, weight or state the port made: the base graph and the generator
matrix are read from their files by ``graph.py``, weights from the
configuration's own file, and every derived table is built here again.
"""
