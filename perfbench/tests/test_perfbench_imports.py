"""What the harness loads: no JAX and no JAX package (``repro``) by whole
top-level name, and a reference that imports nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

import harness as H

HERE = Path(__file__).resolve().parents[1]
SRC = HERE.parent / "src"


def test_whole_names():
    assert H.forbidden_modules(["repro_torch.serving", "reprolike",
                                "jaxtyping", "numpy"]) == []
    assert H.forbidden_modules(["repro.serving.engine", "jaxlib.xla_client",
                                "flax", "torch"]) == ["flax", "jaxlib",
                                                      "repro"]


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True,
        env={"PYTHONPATH": f"{HERE}:{SRC}", "PATH": "/usr/bin:/bin"})
    return set(out.stdout.split())


def test_the_run_path_loads_no_jax():
    tops = _loaded("import run, serving, tracing, client, sweep, harness\n"
                   "harness.module_at('loops', 'sessions')\n"
                   "harness.module_at('loops', 'closed')\n"
                   "import repro_torch.serving\n"
                   "from reference import compare")
    assert "repro_torch" in tops
    assert not tops & set(H.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    tops = _loaded("from reference import compare, decoder")
    assert not tops & (set(H.FORBIDDEN) | {"repro_torch"})
    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] in {"torch", "math", "dataclasses",
                                           "typing", "__future__"}, \
                    f"{path.name} imports {n}"


def _run(root: Path):
    return subprocess.run(
        [sys.executable, str(root / "perfbench" / "run.py"), "--workload",
         "qwen2-1.5b.chat-sessions", "--seed", str(2 ** 31 + 7),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=root, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(root)})


def test_no_result_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and perfbench/ fails."""
    import shutil
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_without_a_card():
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would print a result")
    out = _run(HERE.parent)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
