"""Models built on the port's layers."""
from . import llama, resnet, transformer  # noqa: F401
