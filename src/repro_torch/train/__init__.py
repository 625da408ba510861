"""Serving steps of the dense LMs (the JAX package's ``repro.train``)."""
