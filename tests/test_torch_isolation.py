"""The port stands alone: no JAX, no JAX package, no silent CPU fallback.

* Every module of ``repro_torch`` imports in a fresh interpreter whose
  import hook refuses ``jax``, ``repro`` and ``ml_dtypes`` (the card's
  machine has no ``ml_dtypes``: the checkpoint format reads bfloat16 as
  its bits); the schema toolchain's modules import with ``torch`` refused
  too.
* No file of the port (nor ``chip_smoke.py``) names ``jax``, ``repro`` or
  ``ml_dtypes`` in an import statement.
* Entry points default to the card and raise where CUDA is missing.
* A non-CPU tensor never reaches a plain version: with the kernel
  library unavailable, the wrappers raise instead of answering; and a
  plain answer for a CPU tensor moves no launch counter.
"""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import bebop_decode as bd
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.serving import Engine, PageIngest, ServeConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(repro_torch.__file__)
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    [PKG], prefix="repro_torch."))

_BLOCKING_IMPORT = r"""
import importlib, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "repro", "ml_dtypes"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
for name in sys.argv[1:]:
    importlib.import_module(name)
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")
               for m in sys.modules), sorted(sys.modules)
print("ok", len(sys.argv) - 1)
"""


def test_every_module_imports_with_jax_and_repro_blocked():
    assert len(MODULES) >= 20
    env = dict(os.environ, PYTHONPATH=os.path.dirname(PKG))
    out = subprocess.run([sys.executable, "-c", _BLOCKING_IMPORT, *MODULES],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"ok {len(MODULES)}"


# the schema toolchain and the host codecs: no device work, so no torch
TOOLCHAIN = [f"repro_torch.core.{m}" for m in (
    "schema", "lexer", "parser", "decorators", "compiler", "fastwire",
    "descriptor", "codegen", "cli", "varint")]


def test_schema_toolchain_imports_with_torch_blocked_too():
    script = _BLOCKING_IMPORT.replace(
        '("jax", "jaxlib", "repro", "ml_dtypes")',
        '("jax", "jaxlib", "repro", "ml_dtypes", "torch")')
    assert script.count('"torch"') == 2
    env = dict(os.environ, PYTHONPATH=os.path.dirname(PKG))
    out = subprocess.run([sys.executable, "-c", script, *TOOLCHAIN],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"ok {len(TOOLCHAIN)}"
    assert set(TOOLCHAIN) <= set(MODULES)


def _port_files():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_names_jax_or_repro(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro",
                                              "ml_dtypes"), \
                f"{path}:{node.lineno} imports {name}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config(get_config("qwen2-1.5b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        PageIngest()
    from repro_torch.serving import InferenceImpl
    engine = Engine(cfg, ServeConfig(cache_len=32), device="cpu")
    impl = InferenceImpl(engine)        # follows the engine's device
    try:
        assert impl.ingest.device.type == "cpu"
    finally:
        impl.close()


@pytest.fixture
def no_kernel_library(monkeypatch, tmp_path):
    """The kernel libraries cannot be found, built or loaded."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "find_nvcc", lambda: None)


def test_non_cpu_tensor_raises_instead_of_plain_result(no_kernel_library):
    # meta tensors stand in for device tensors: not on the CPU, so the
    # wrappers must take the kernel route, which is unavailable here
    page = torch.empty((4, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        bd.decode_columns(page, [(0, 2, "uint32", "int32")])
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        bd.decode_column(page, offset=0, count=2, wire_dtype="uint32")
    q = torch.empty((2, 4, 16), device="meta")
    pool = torch.empty((8, 2, 8, 16), device="meta")
    tables = torch.empty((2, 4), dtype=torch.int32, device="meta")
    ctx = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(build.KernelBuildError):
        pa.paged_attention(q, pool, pool, tables, ctx)
    with pytest.raises(build.KernelBuildError):
        pa.paged_prefill_attention(q[:, :, None], pool, pool, tables,
                                   ctx[:, None])


def test_launch_counters_do_not_move_on_the_plain_path():
    before = (bd.decode_columns.launches, pa.paged_attention.launches,
              pa.paged_prefill_attention.launches)
    page = torch.zeros((3, 8), dtype=torch.uint8)
    bd.decode_columns(page, [(0, 2, "uint32", "int32")])
    q = torch.zeros((1, 2, 8))
    pool = torch.zeros((3, 1, 4, 8))
    tables = torch.ones((1, 2), dtype=torch.int32)
    pa.paged_attention(q, pool, pool, tables, torch.tensor([3]))
    assert (bd.decode_columns.launches, pa.paged_attention.launches,
            pa.paged_prefill_attention.launches) == before


def test_dense_kernels_raise_for_non_cpu_tensors(no_kernel_library):
    q = torch.empty((1, 4, 8, 128), device="meta")
    kv = torch.empty((1, 2, 8, 128), device="meta")
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        fa.flash_attention(q, kv, kv)
    x = torch.empty((1, 8, 16), device="meta")
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        rg.rglru_scan(x, x)


def test_dense_kernel_counters_do_not_move_on_the_plain_path():
    before = (fa.flash_attention.launches, rg.rglru_scan.launches)
    fa.flash_attention(torch.zeros((1, 2, 3, 8)), torch.zeros((1, 1, 3, 8)),
                       torch.zeros((1, 1, 3, 8)))
    rg.rglru_scan(torch.zeros((1, 3, 4)), torch.zeros((1, 3, 4)))
    assert (fa.flash_attention.launches, rg.rglru_scan.launches) == before


def test_dense_entry_points_default_to_cuda(monkeypatch):
    """The hybrid model's engine and the dense batcher's service follow
    the same device rule as the paged path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config(get_config("recurrentgemma-9b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, ServeConfig())
    from repro_torch.serving import ContinuousBatcher, InferenceImpl
    impl = InferenceImpl(Engine(cfg, ServeConfig(cache_len=32),
                                device="cpu"))
    try:
        assert isinstance(impl.batcher, ContinuousBatcher)
        assert impl.ingest.device.type == "cpu"
    finally:
        impl.close()


def test_wkv_kernel_raises_for_non_cpu_tensors(no_kernel_library):
    x = torch.empty((1, 2, 8, 16), device="meta")
    u = torch.empty((2, 16), device="meta")
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        rw.rwkv6_scan(x, x, x, x, u)


def test_wkv_kernel_counter_does_not_move_on_the_plain_path():
    before = rw.rwkv6_scan.launches
    x = torch.zeros((1, 2, 3, 16))
    rw.rwkv6_scan(x, x, x, x, torch.zeros((2, 16)))
    assert rw.rwkv6_scan.launches == before


def test_rwkv_entry_points_default_to_cuda(monkeypatch):
    """rwkv6-7b's engine follows the same device rule; its service takes
    the dense batcher (no paged KV) on the engine's device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config(get_config("rwkv6-7b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, ServeConfig())
    from repro_torch.serving import ContinuousBatcher, InferenceImpl
    impl = InferenceImpl(Engine(cfg, ServeConfig(cache_len=32),
                                device="cpu"))
    try:
        assert isinstance(impl.batcher, ContinuousBatcher)
        assert impl.ingest.device.type == "cpu"
    finally:
        impl.close()
