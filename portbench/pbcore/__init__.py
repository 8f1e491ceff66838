"""The port benchmark's own code: the world cache, the traffic generator,
the child process and its streams, the plain reference that decides
`correct`, and the arithmetic that turns spans and traces into metrics.

Nothing here imports JAX, the JAX package or (outside `child.py`, which
runs the program) the PyTorch port.
"""
