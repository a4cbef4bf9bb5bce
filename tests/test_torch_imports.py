"""The port stands alone: no module of paddle_tpu_torch, and nothing in
chip_smoke.py, imports jax, jaxlib or the JAX package (paddle_tpu)."""
import ast
import os

import pytest
import _torch_threads  # noqa: F401,E402  (xdist: torch threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = ('jax', 'jaxlib', 'paddle_tpu')


def _sources():
    out = [os.path.join(ROOT, 'chip_smoke.py')]
    for d, dirs, files in os.walk(os.path.join(ROOT, 'paddle_tpu_torch')):
        dirs[:] = [x for x in dirs if x != '_build']   # build outputs only
        out += [os.path.join(d, f) for f in files if f.endswith('.py')]
    return sorted(os.path.relpath(p, ROOT) for p in out)


def _forbidden(module):
    # match the top-level package exactly: 'paddle_tpu_torch' starts with
    # 'paddle_tpu' but is the port itself
    return module.split('.')[0] in _FORBIDDEN


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, 'attr', getattr(node.func, 'id', None)) in (
                    'import_module', '__import__') and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_scan_covers_the_package():
    srcs = _sources()
    assert 'chip_smoke.py' in srcs
    assert os.path.join('paddle_tpu_torch', 'ops', 'attention.py') in srcs
    for mod in ('core/passes/__init__.py', 'core/passes/walker.py',
                'core/passes/dce.py', 'core/passes/const_fold.py',
                'core/passes/cse.py', 'core/passes/fuse.py',
                'core/passes/canon.py', 'core/amp.py', 'ops/fused.py',
                'ops/kernelgen/__init__.py', 'ops/kernelgen/rules.py',
                'ops/kernelgen/builder.py', 'testing/__init__.py',
                'testing/faults.py', 'core/graphs.py'):
        assert os.path.join('paddle_tpu_torch', *mod.split('/')) in srcs
    assert len(srcs) > 20


@pytest.mark.parametrize('path', _sources())
def test_no_jax_or_paddle_tpu_import(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = sorted({m for m in _imports(tree) if _forbidden(m)})
    assert not bad, '%s imports %s' % (path, bad)


def test_matcher_tells_the_port_from_the_reference():
    assert _forbidden('paddle_tpu') and _forbidden('paddle_tpu.ops.gather')
    assert _forbidden('jax.numpy') and _forbidden('jaxlib')
    assert not _forbidden('paddle_tpu_torch')
    assert not _forbidden('paddle_tpu_torch.ops.gather')
