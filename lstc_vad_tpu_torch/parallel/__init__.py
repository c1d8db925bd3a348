"""Device layout.  Only the mesh factorization (for ``info``) is ported;
the device mesh itself is ROADMAP A18."""

from .mesh import factor_devices  # noqa: F401
