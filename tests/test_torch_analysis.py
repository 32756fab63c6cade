"""The repo's static analysis (RPR001-RPR004) finds nothing in the port.

CI runs ``python -m repro.analysis src``, which walks ``src/repro_torch``
too: exception-clause order, lock discipline (``# guarded by``
annotations), jit purity and pre-initialized ``stats`` keys.
"""
import os

from repro.analysis.core import analyze_paths

import repro_torch

PORT_PKG = os.path.dirname(repro_torch.__file__)


def test_port_tree_is_clean():
    results = analyze_paths([PORT_PKG], cache_path=None)
    assert len(results) >= 20, "no files found under the port package"
    problems = [f.render() for r in results for f in r.findings]
    problems += [f"{r.path}: {r.error}" for r in results if r.error]
    assert not problems, "\n".join(problems)
