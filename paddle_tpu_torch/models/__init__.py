"""Models built on the port's layers."""
from . import llama, transformer  # noqa: F401
