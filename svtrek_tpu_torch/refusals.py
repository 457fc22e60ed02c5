"""What the port does not run.

`Unsupported` is raised for an option or environment that the JAX package
runs and this port does not; its message says what is refused and why.
No option of audt, scan or disc is refused: the disc pipeline raises it
where the native GAF reader does not load, and the CLI reports it.
"""
from __future__ import annotations


class Unsupported(RuntimeError):
    """An option or environment this port does not run yet."""
