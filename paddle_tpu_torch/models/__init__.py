"""Models built on the port's layers."""
from . import (llama, mnist, resnet, se_resnext, transformer,  # noqa: F401
               vgg)
