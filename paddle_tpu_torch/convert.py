"""Carry weights into the port's Scope.

`scope_from_numpy` takes parameters as numpy arrays by name — the JAX
package's `scope.vars` as host arrays, or the arrays of a `__params__.npz`
that either package wrote — and puts them into a Scope on a device.  The
fluid layout is kept: a `mul`/`fc` weight stays [in, out] and is used as
x @ W (no transpose into nn.Linear's [out, in]).  64-bit arrays narrow to
32 bits, as the JAX package holds them on its device.  `persistable_names`
lists what a program keeps in its scope, optimizer state included.
"""
import torch

from .core.executor import to_device

__all__ = ['scope_from_numpy', 'persistable_names']


def persistable_names(program):
    """Sorted names of every persistable var of `program`: parameters, and
    for a training program the optimizer state too (moments, beta powers,
    the LR decay counter) — what has to be carried for both packages to
    train from the same state."""
    return sorted({v.name for v in program.list_vars() if v.persistable})


def scope_from_numpy(arrays, scope, device):
    """arrays: mapping name -> numpy array; returns `scope`."""
    device = torch.device(device)
    for name in list(arrays.keys()):
        scope.set(name, to_device(arrays[name], None, device))
    return scope
