"""paddle_tpu_torch.testing: fault injection for the port's failure paths.

Counterpart of paddle_tpu/testing.  `faults` arms named, deterministic
injection sites from the ``PT_FAULT`` environment variable or
`faults.configure()`.
"""
from . import faults  # noqa: F401

__all__ = ['faults']
