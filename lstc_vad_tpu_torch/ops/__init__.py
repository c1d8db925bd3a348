from .attention import plain_sdpa, sdpa  # noqa: F401
