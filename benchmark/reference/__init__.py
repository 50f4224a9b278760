"""Plain PyTorch and NumPy reference of the measured paths.

Nothing here imports the program (putting_dune_torch), JAX or the JAX
package: the reference reads the shipped weight files with its own
msgpack reader and recomputes what the program produced from the inputs
the benchmark hands both sides.
"""
