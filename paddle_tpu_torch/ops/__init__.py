"""Op implementations; importing this package registers them all."""
from . import (rand, tensor, math, nn, sampling, attention, loss,  # noqa: F401
               metric, optimizer_ops, fused, sequence)
