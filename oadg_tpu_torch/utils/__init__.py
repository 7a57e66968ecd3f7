"""Utilities of the port: registry, checkpoint conversion, the host library
(``host_kernels``), the step's draws."""
