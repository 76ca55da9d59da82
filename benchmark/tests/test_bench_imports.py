"""What the benchmark loads: no module of JAX or of the JAX package anywhere
(by whole top-level names: ``fv2p_torch`` begins with ``fv2p_t`` too), and
nothing of the program in the reference."""
import ast
import subprocess
import sys

import pytest

from conftest import BENCH, REPO

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'fv2p_tpu'}


def _loaded_after(imports):
    code = (f'import sys; sys.path[:0] = [{str(BENCH)!r}, {str(REPO)!r}]\n{imports}\n'
            'print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         cwd=REPO, timeout=300, check=True)
    return set(out.stdout.split())


def test_what_run_py_loads_holds_no_jax():
    loaded = _loaded_after('import run\nfrom fvbench import harness, control\n'
                           'import fv2p_torch.models.detectors.detector3d_template')
    assert 'fv2p_torch' in loaded and not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after('from fvbench import reference, compare, weights, scans, bounds\n'
                           'import refnet.models.detectors.detector3d_template\n'
                           'import refnet.train_utils.train_state')
    assert 'refnet' in loaded
    assert not loaded & (FORBIDDEN | {'fv2p_torch'})


def _imported_top_levels(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


@pytest.mark.parametrize('path', sorted(p.relative_to(BENCH) for p in BENCH.rglob('*.py')
                                        if 'tests' not in p.parts), ids=str)
def test_no_source_imports_jax_and_only_program_py_the_port(path):
    names = _imported_top_levels(BENCH / path)
    assert not names & FORBIDDEN
    if str(path) != 'fvbench/program.py':
        assert 'fv2p_torch' not in names
