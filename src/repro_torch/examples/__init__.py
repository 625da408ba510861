"""The twin's example workflows on the port, one module each (the JAX
package's ``examples/``): run one as

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

on the CUDA card by default. Each module's functions take the config, the
tick count and the device, so that a caller can drive them small; its
``main`` runs the JAX example's sizes.
"""
