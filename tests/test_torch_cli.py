"""The port's ``bebopc`` (``python -m repro_torch.core.cli``) against the
JAX package's, both run as child processes on the same ``.bop`` files.

``check`` and ``ids`` print the same lines; ``build`` writes the same
generated module (the JAX text with ``repro.core`` read as
``repro_torch.core``) and a byte-equal descriptor set; bad input exits 1
with ``error`` on stderr in both, and ``build`` with no output flag exits
2.  The generated module imports and round-trips in a child whose import
hook refuses ``repro``, ``jax`` and ``torch``.
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

DEMO = """
edition = "2026"
package demo
struct Point { x: float32; y: float32; }
message Meta { note(1): string; }
service Geo { Locate(Point): Point; Track(Point): stream Point; }
"""

EMBEDDING = '''edition = "2026"
package smoke
import "bebop/decorators.bop"
enum Kind : uint8 { QUERY = 0; DOCUMENT = 1; }
/// One record of the 1,536-wide embedding workload.
struct EmbeddingRecord { id: uuid; vector: bfloat16[1536]; model: uint32; kind: Kind; }
message SearchRequest { query(1): string; top_k(2): uint32; filters(3): map[string, string]; }
service Search { Embed(SearchRequest): EmbeddingRecord; }
'''

# a schema that imports another file of its directory and one of an
# include directory
SHARED = "struct Shared { v: uint16; }\n"
MAIN = """
import "shared.bop"
import "lib/extra.bop"
struct Uses { s: Shared; e: Extra; }
service Svc {
  A(Uses): Uses; B(stream Uses): stream Uses; C(stream Uses): Uses;
  D(Uses): stream Uses;
}
"""
EXTRA = "struct Extra { w: int64; }\n"

SCHEMAS = {"demo": DEMO, "embedding": EMBEDDING, "main": MAIN}

PACKAGES = {"jax": "repro.core.cli", "port": "repro_torch.core.cli"}


def _run(pkg, args, cwd):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", PACKAGES[pkg], *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.fixture
def tree(tmp_path):
    for name, src in SCHEMAS.items():
        (tmp_path / f"{name}.bop").write_text(src)
    (tmp_path / "shared.bop").write_text(SHARED)
    (tmp_path / "inc" / "lib").mkdir(parents=True)
    (tmp_path / "inc" / "lib" / "extra.bop").write_text(EXTRA)
    return tmp_path


def _flags(name):
    return ["-I", "inc"] if name == "main" else []


@pytest.mark.parametrize("cmd", ["check", "ids"])
@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_check_and_ids_print_the_same(tree, name, cmd):
    out = {pkg: _run(pkg, [cmd, f"{name}.bop", *_flags(name)], tree)
           for pkg in PACKAGES}
    assert out["port"].returncode == out["jax"].returncode == 0, \
        out["port"].stderr
    assert out["port"].stdout == out["jax"].stdout
    assert out["port"].stdout.strip()
    if cmd == "ids" and name != "embedding":
        assert "server_stream" in out["port"].stdout


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_build_writes_the_same_files(tree, name):
    for pkg in PACKAGES:
        r = _run(pkg, ["build", f"{name}.bop", *_flags(name),
                       "--python-out", f"gen_{pkg}",
                       "--descriptor-out", f"{name}_{pkg}.bin"], tree)
        assert r.returncode == 0, r.stderr
        assert r.stdout.splitlines() == [
            f"wrote {os.path.join(f'gen_{pkg}', f'{name}_bebop.py')}",
            f"wrote {name}_{pkg}.bin"]
    port = (tree / "gen_port" / f"{name}_bebop.py").read_text()
    jax = (tree / "gen_jax" / f"{name}_bebop.py").read_text()
    assert port == jax.replace("repro.core", "repro_torch.core")
    assert (tree / f"{name}_port.bin").read_bytes() == \
        (tree / f"{name}_jax.bin").read_bytes()


BAD = {
    "unknown_type": "struct S { x: not_a_type; }",
    "parse": "struct S { x int32; }",
    "lex": "struct S { x: int32; } $",
    "missing_import": 'import "nowhere.bop"\nstruct S { x: int32; }',
}


@pytest.mark.parametrize("cmd", ["check", "ids", "build"])
@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_input_exits_1_alike(tree, case, cmd):
    (tree / "bad.bop").write_text(BAD[case])
    extra = ["--python-out", "gen"] if cmd == "build" else []
    out = {pkg: _run(pkg, [cmd, "bad.bop", *extra], tree)
           for pkg in PACKAGES}
    assert out["port"].returncode == out["jax"].returncode == 1
    assert out["port"].stderr.startswith("error")
    assert out["port"].stderr == out["jax"].stderr
    assert out["port"].stdout == out["jax"].stdout == ""


def test_missing_file_exits_1_and_nothing_to_do_exits_2(tree):
    for pkg in PACKAGES:
        r = _run(pkg, ["check", "absent.bop"], tree)
        assert r.returncode == 1 and "error" in r.stderr
        r = _run(pkg, ["build", "demo.bop"], tree)
        assert r.returncode == 2
        assert "nothing to do" in r.stderr
    assert not (tree / "gen").exists()


_BLOCKED_CHILD = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("repro", "jax", "jaxlib", "torch"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import uuid
import numpy as np
import embedding_bebop as e
import demo_bebop as d

p = d.Point(x=1.5, y=-2.0)
q = d.Point.decode(p.encode())
assert (q.x, q.y) == (1.5, -2.0)
assert d.Meta.decode(d.Meta(note="hi").encode()).note == "hi"
vec = np.linspace(-1, 1, 1536, dtype=np.float32)
r = e.EmbeddingRecord(id=uuid.UUID(int=7), vector=vec, model=3,
                      kind=e.Kind.DOCUMENT)
blob = r.encode()
assert len(blob) == 3093
back = e.EmbeddingRecord.decode(blob)
assert bytes(back.id) == uuid.UUID(int=7).bytes
assert (int(back.model), int(back.kind)) == (3, 1)
req = e.SearchRequest(query="q", top_k=5, filters={"a": "b"})
got = e.SearchRequest.decode(req.encode())
assert (got.query, got.top_k, got.filters) == ("q", 5, {"a": "b"})
assert e.SearchClient._service.methods[0].name == "Embed"
assert not any(m.split(".")[0] in ("repro", "jax", "jaxlib", "torch")
               for m in sys.modules), sorted(sys.modules)
print("ok")
"""


def test_generated_module_runs_with_repro_jax_and_torch_blocked(tree):
    for name in ("demo", "embedding"):
        r = _run("port", ["build", f"{name}.bop", "--python-out", "gen"],
                 tree)
        assert r.returncode == 0, r.stderr
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([SRC, str(tree / "gen")]))
    r = subprocess.run([sys.executable, "-c", _BLOCKED_CHILD], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
