"""The plain reference and the comparison that decides ``correct``.

Plain PyTorch and NumPy only: nothing here imports ``jax``, the JAX
package or anything of the port, and nothing takes what the port made.
"""
