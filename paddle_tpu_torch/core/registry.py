"""Op registry: op type -> PyTorch implementation.

Counterpart of paddle_tpu/core/registry.py.  Each op registers one plain
function on tensors, used both for build-time shape inference (run on
`meta` tensors, see Block._infer_shapes) and by the executor's op-by-op
interpreter on the device.

Impl signature::

    @register('my_op')
    def my_op(ctx, ins, attrs):
        x = ins['X']              # tensor, or list of tensors for list slots
        return {'Out': ...}

`ctx.device` is where outputs the op creates from nothing belong;
`ctx.wants(slot)` says whether anything reads or keeps an output slot, so
an impl can skip computing an auxiliary output nobody uses (shape
inference wants every slot);
`ctx.generator(seed)` is a `torch.Generator` on that device, seeded from the
op's `seed` attr when it is non-zero, else from the program's
`random_seed`, the run counter and the op's stream: its `rng_stream` attr,
which the rewriter (core/passes) stamps with the op's ORIGINAL position so
that deleting or fusing ops never shifts a later draw, else its live
position in the block.  Every op and every run draws its own stream.
`ctx.upload(array)` puts a host constant on that device (through a CUDA
graph entry's recorder, `ctx.recorder`, core/graphs.py).
`ctx.sub_ctx(sub)` is the context of one sub-op of a `fused_elementwise`
op: it draws from that sub-op's own pinned stream.  `ctx.amp` says whether
the program runs under bf16 AMP.  `ctx.recomputing` is true while the
backward runs a recompute group's forward again (core/executor.py
`_run_group`): an op that writes a persistable in place skips it then.
The streams are not JAX's threefry streams: the two packages agree on
everything but random draws.
"""
import torch

_REGISTRY = {}

__all__ = ['register', 'has_op', 'get_op', 'InferCtx', 'ExecCtx',
           'run_seed', 'stream_seed']

_MASK = (1 << 63) - 1


def run_seed(random_seed, counter):
    """The seed of one run: the run counter mixed into the program seed,
    so every run of one program draws fresh streams while staying
    reproducible."""
    return (int(random_seed) * 0x9E3779B97F4A7C15 + int(counter)) & _MASK


def stream_seed(run_seed_, seed, stream):
    """The seed of one op stream in a run: a non-zero op `seed` as is,
    else the stream index mixed into the run's seed."""
    if seed:
        return int(seed) & _MASK
    return (run_seed_ ^ ((int(stream) + 1) * 1009
                         * 0xBF58476D1CE4E5B9)) & _MASK


def register(name):
    def deco(fn):
        if name in _REGISTRY:
            raise ValueError('op %s already registered' % name)
        _REGISTRY[name] = fn
        return fn
    return deco


def has_op(name):
    _ensure_ops_loaded()
    return name in _REGISTRY


def get_op(name):
    _ensure_ops_loaded()
    if name not in _REGISTRY:
        raise KeyError('no torch impl registered for op "%s"' % name)
    return _REGISTRY[name]


_ops_loaded = [False]


def _ensure_ops_loaded():
    # op modules register themselves on import; loaded lazily to avoid the
    # import cycle framework -> registry -> ops -> framework
    if not _ops_loaded[0]:
        _ops_loaded[0] = True
        from .. import ops as _ops  # noqa: F401


class InferCtx(object):
    """Context for shape-only runs: impls see `meta` tensors and must not
    draw random numbers.  `plan_device` set to 'cuda' asks a
    `fused_elementwise` impl to build its generated-kernel plan as well
    (the executor's planning pass, core/executor.py)."""

    is_infer = True
    device = torch.device('meta')
    recorder = None
    recomputing = False

    def __init__(self, op=None, amp=False, plan_device=None):
        self.op = op
        self.amp = amp
        self.plan_device = plan_device

    def generator(self, seed=0):
        return None

    def upload(self, host):
        return torch.from_numpy(host).to(self.device)

    def wants(self, slot):
        return True

    def sub_ctx(self, sub):
        return self


class ExecCtx(object):
    """Per-run context shared by all ops of one interpreted block.
    `cache` is a dict the executor keeps across runs for impls that hold
    device-side tables between steps (the multi-tensor Adam's)."""

    def __init__(self, device, random_seed, counter, cache=None, amp=False,
                 recorder=None):
        self.device = torch.device(device)
        self.amp = bool(amp)
        self.seed = run_seed(random_seed, counter)
        self.cache = cache if cache is not None else {}
        # None, or a CUDA graph entry's recorder (core/graphs.py): it hands
        # out the generators a capture registers and makes the host uploads
        self.recorder = recorder
        # set by core/executor.py _run_group while a group runs again
        self.recomputing = False

    def upload(self, host):
        """A host numpy array as a tensor on the device: through the CUDA
        graph entry's recorder when one is set (core/graphs.py: a capture
        may not copy from pageable memory), else a plain copy."""
        if self.recorder is not None:
            return self.recorder.upload(host, self.device)
        return torch.from_numpy(host).to(self.device)

    def generator(self, seed, stream):
        """The generator of one op stream: fixed `seed`, or `stream` (the
        op's rng_stream) mixed into this run's seed."""
        s = stream_seed(self.seed, seed, stream)
        if self.recorder is not None:
            return self.recorder.generator(self.device, (seed, stream), s)
        g = torch.Generator(device=self.device)
        g.manual_seed(s)
        return g

    def for_op(self, op_index, op, wanted=None):
        return OpCtx(self, op_index, op, wanted)


class _SubOpShim(object):
    """Op stand-in for one serialized sub-op of a fused_elementwise op:
    its type and attrs, all OpCtx reads."""
    __slots__ = ('type', 'attrs')

    def __init__(self, type, attrs):
        self.type = type
        self.attrs = attrs


class OpCtx(object):
    is_infer = False

    def __init__(self, exec_ctx, op_index, op, wanted=None):
        self._exec = exec_ctx
        self.op_index = op_index
        self.op = op
        self._wanted = wanted

    @property
    def device(self):
        return self._exec.device

    @property
    def amp(self):
        return self._exec.amp

    @property
    def cache(self):
        return self._exec.cache

    @property
    def recorder(self):
        return self._exec.recorder

    @property
    def recomputing(self):
        return self._exec.recomputing

    def upload(self, host):
        return self._exec.upload(host)

    def sub_ctx(self, sub):
        """Context for one replayed sub-op of a fused_elementwise op."""
        return OpCtx(self._exec, self.op_index,
                     _SubOpShim(sub['type'], sub['attrs']))

    def wants(self, slot):
        """True when a later op reads, or the run keeps, an output of
        `slot` (always True when the executor gave no liveness)."""
        if self._wanted is None:
            return True
        return any(n in self._wanted for n in self.op.outputs.get(slot, ()))

    def generator(self, seed=0):
        stream = None
        if not seed:
            stream = self.op.attrs.get('rng_stream')
            if stream is None:
                stream = self.op_index
        return self._exec.generator(seed, stream)
