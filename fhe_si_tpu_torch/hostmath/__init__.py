from . import numbth  # noqa: F401  (oracle is imported explicitly to avoid cycles)
