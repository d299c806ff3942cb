"""Rules of the port: auron_tpu_torch and chip_smoke.py import nothing of
JAX or the JAX package, pyarrow and zstandard only inside functions, and
the TPC-DS harness (auron_tpu_torch/it/) no pyarrow at all; the
entry points run on the card unless asked for the CPU; the kernel
wrappers launch or raise on a CUDA tensor and never fall back."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from auron_tpu_torch.ops import kernels_cuda as K
from auron_tpu_torch.runtime import executor

import torch_parity as TP

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "auron_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "tools" / "chip_q27r.py"]
FORBIDDEN = ("jax", "jaxlib", "auron_tpu")
LAZY_ONLY = ("pyarrow", "zstandard")


def _imports(tree):
    """(module name, at module level) for every import in the tree."""
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module, id(node) in top


def _is(name, root):
    return name == root or name.startswith(root + ".")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, top_level in _imports(tree):
        if _is(name, "auron_tpu_torch"):
            continue
        assert not any(_is(name, f) for f in FORBIDDEN), \
            f"{path.name} imports {name}"
        if top_level:
            assert not any(_is(name, m) for m in LAZY_ONLY), \
                f"{path.name} imports {name} at module level"


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"kernels_cuda.py", "executor.py", "chip_smoke.py", "sort.py",
            "sort_keys.py", "radix_sort.py", "strategy.py",
            "partitioner.py", "writer.py", "typing.py", "cast.py",
            "compiler.py", "segments.py", "basic.py", "functions.py",
            "exec.py", "ipc.py", "planner.py", "session.py", "stage.py",
            "converters.py"} <= names


def test_import_rules_cover_the_session_and_stage_modules():
    rel = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"auron_tpu_torch/frontend/session.py",
            "auron_tpu_torch/frontend/converters.py",
            "auron_tpu_torch/parallel/stage.py"} <= rel


def test_import_leaves_jax_out():
    mods = ["auron_tpu_torch"] + sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "auron_tpu_torch").rglob("*.py"))
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in ('jax', 'jaxlib', 'auron_tpu', 'pyarrow', "
            "'zstandard') if m in sys.modules]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_import_rules_cover_the_intake_modules():
    rel = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"auron_tpu_torch/frontend/foreign.py",
            "auron_tpu_torch/frontend/expr_convert.py",
            "auron_tpu_torch/frontend/strategy.py",
            "auron_tpu_torch/it/__init__.py",
            "auron_tpu_torch/it/datagen.py",
            "auron_tpu_torch/it/queries.py"} <= rel


def test_import_rules_cover_the_memory_manager():
    rel = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"auron_tpu_torch/memmgr/__init__.py",
            "auron_tpu_torch/memmgr/manager.py",
            "auron_tpu_torch/memmgr/spill.py"} <= rel


IT_FILES = sorted((ROOT / "auron_tpu_torch" / "it").rglob("*.py"))


@pytest.mark.parametrize("path", IT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_harness_file_never_imports_pyarrow(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, _ in _imports(tree):
        assert not _is(name, "pyarrow"), f"{path.name} imports {name}"


def test_import_rules_cover_the_harness():
    rel = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    it = {str(p.relative_to(ROOT)) for p in IT_FILES}
    want = {f"auron_tpu_torch/it/{m}.py" for m in (
        "__init__", "__main__", "datagen", "queries", "compare", "runner")}
    assert want <= rel and want <= it


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card and without device='cpu', execute_task_bytes, the
    session's execute and execute_converted and the stage executor's
    execute_plan_stage raise before they read any input."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pulled = []

    def source():
        pulled.append(1)
        yield from ()
    from auron_tpu.ir import plan as JP
    from auron_tpu.ir import serde as jserde
    from auron_tpu_torch.runtime.resources import ResourceRegistry
    data = jserde.serialize(JP.TaskDefinition(plan=TP.partial_agg(
        TP.projection(JP.FFIReader(schema=TP.SRC_SCHEMA,
                                   resource_id="src")))), codec="zlib")
    res = ResourceRegistry()
    res.put("src", source())
    with pytest.raises(RuntimeError, match="CUDA"):
        executor.execute_task_bytes(data, res)
    with pytest.raises(RuntimeError, match="CUDA"):
        executor.execute_task_bytes(data, res, device="cuda")
    assert not pulled
    out = executor.execute_task_bytes(data, res, device="cpu")
    assert pulled and out.batches == []
    _session_and_stage_entries(monkeypatch)


def _session_and_stage_entries(monkeypatch):
    from auron_tpu_torch.frontend import converters, strategy
    from auron_tpu_torch.frontend.foreign import ForeignNode, fcol
    from auron_tpu_torch.frontend.session import AuronSession
    from auron_tpu_torch.ir.schema import DataType, Field, Schema
    from auron_tpu_torch.ops.scan.ipc import SourceTable
    from auron_tpu_torch.parallel.stage import execute_plan_stage

    class Counted(SourceTable):
        def columns(self, n_cols):
            pulled.append(1)
            return super().columns(n_cols)

        def for_partition(self, pid):
            pulled.append(1)
            return super().for_partition(pid)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pulled = []
    # the query through the intake: a projection over a local scan, whose
    # converted reader reads the table the caller passes for its source
    schema = Schema.of(Field("k", DataType.int64()))
    scan = ForeignNode("LocalTableScanExec", output=schema,
                       attrs={"rows": []})
    plan = ForeignNode("ProjectExec", children=(scan,), output=schema,
                       attrs={"project_list": [fcol("k", DataType.int64())]})
    ctx = converters.ConvertContext()
    root = converters.convert_recursively(plan, strategy.apply(plan), ctx)
    [rid] = ctx.sources
    src = {rid: Counted.from_columns([np.arange(5, dtype=np.int64)],
                                     [np.ones(5, bool)])}
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            AuronSession().execute_converted(root, ctx, src, device=dev)
        with pytest.raises(RuntimeError, match="CUDA"):
            execute_plan_stage(root, ctx, src, device=dev)
    assert not pulled
    res = AuronSession().execute_converted(root, ctx, src, device="cpu")
    assert pulled and res.spmd and res.num_rows == 5
    _foreign_plan_entry(monkeypatch)


def _foreign_plan_entry(monkeypatch):
    from auron_tpu_torch.config import conf
    from auron_tpu_torch.frontend.foreign import ForeignNode, fcol
    from auron_tpu_torch.frontend.session import AuronSession
    from auron_tpu_torch.ir.schema import DataType, Field, Schema
    from auron_tpu_torch.ops.scan.ipc import SourceTable

    class Engine:
        def execute(self, node, child_tables):
            pulled.append(node.op)
            return child_tables[0] if child_tables else \
                SourceTable.from_rows(node.attrs["rows"], node.output)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pulled = []
    schema = Schema.of(Field("k", DataType.int64()))
    scan = ForeignNode("LocalTableScanExec", output=schema,
                       attrs={"rows": [{"k": 1}, {"k": 2}]})
    plan = ForeignNode("ProjectExec", children=(scan,), output=schema,
                       attrs={"project_list": [fcol("k", DataType.int64())]})
    session = AuronSession(foreign_engine=Engine())
    for enabled in (True, False):
        with conf.scoped({"auron.enable": enabled}):
            for dev in (None, "cuda"):
                with pytest.raises(RuntimeError, match="CUDA"):
                    session.execute(plan, device=dev)
    assert not pulled
    assert session.execute(plan, device="cpu").num_rows == 2
    with conf.scoped({"auron.enable": False}):
        assert session.execute(plan, device="cpu").num_rows == 2
    assert pulled == ["LocalTableScanExec", "ProjectExec"]


def test_kernel_wrapper_never_falls_back(monkeypatch):
    """A CUDA tensor goes to the kernel or raises; here, with no toolkit
    and no card, it raises and the plain version is not called."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        data = torch.empty(64, dtype=torch.int64, device="cuda")
        valid = torch.empty(64, dtype=torch.bool, device="cuda")
    called = []
    monkeypatch.setattr(K, "hash_partition_ids_i64_plain",
                        lambda *a: called.append(a))
    monkeypatch.setattr(K, "_libs", {})
    before = dict(K.LAUNCHES)
    with pytest.raises(Exception):
        K.hash_partition_ids_i64(data, valid, 8)
    assert not called
    assert K.LAUNCHES == before
    meta = torch.empty(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="device"):
        K.hash_partition_ids_i64(meta, torch.empty(8, dtype=torch.bool,
                                                   device="meta"), 8)
    assert not called


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "contiguous",
                                 "n_parts"])
def test_kernel_wrapper_checks_its_inputs(bad):
    data = torch.arange(16, dtype=torch.int64)
    valid = torch.ones(16, dtype=torch.bool)
    n_parts = 4
    if bad == "dtype":
        data = data.to(torch.int32)
    elif bad == "shape":
        valid = valid[:8]
    elif bad == "device":
        valid = valid.to("meta")
    elif bad == "contiguous":
        data = torch.arange(32, dtype=torch.int64)[::2]
    else:
        n_parts = 0
    with pytest.raises((TypeError, ValueError)):
        K.hash_partition_ids_i64(data, valid, n_parts)


def test_radix_hist_wrapper_never_falls_back(monkeypatch):
    """A CUDA tensor goes to the histogram kernel or raises; here, with no
    toolkit and no card, it raises and the plain version is not called."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        words = torch.empty(8192, dtype=torch.int32, device="cuda")
    called = []
    monkeypatch.setattr(K, "radix_bucket_hist_plain",
                        lambda *a: called.append(a))
    monkeypatch.setattr(K, "_libs", {})
    before = dict(K.LAUNCHES)
    with pytest.raises(Exception):
        K.radix_bucket_hist(words, 8)
    assert not called
    assert K.LAUNCHES == before
    with pytest.raises(ValueError, match="device"):
        K.radix_bucket_hist(torch.empty(128, dtype=torch.int32,
                                        device="meta"), 8)
    assert not called


def test_radix_hist_misaligned_cuda_words_raise(monkeypatch):
    """The kernel reads 16-byte vectors: CUDA words 4 bytes off a vector
    boundary raise ValueError before any build or launch, and the plain
    version is not called."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    with FakeTensorMode():
        words = torch.empty(256, dtype=torch.int32, device="cuda")
    monkeypatch.setattr(FakeTensor, "data_ptr", lambda self: 4,
                        raising=False)
    called = []
    monkeypatch.setattr(K, "radix_bucket_hist_plain",
                        lambda *a: called.append(a))
    monkeypatch.setattr(K, "_library", lambda name: called.append(name))
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="boundary"):
        K.radix_bucket_hist(words, 8)
    assert not called
    assert K.LAUNCHES == before


def test_radix_hist_misaligned_cpu_words_run_plain():
    """The plain version has no alignment need: a CPU view 4 bytes off a
    vector boundary counts as its aligned copy does."""
    base = torch.arange(257, dtype=torch.int32) * 16_777_259
    view = base[1:]
    assert view.data_ptr() % K.VECTOR_BYTES
    assert torch.equal(K.radix_bucket_hist(view, 8),
                       K.radix_bucket_hist(view.clone(), 8))


@pytest.mark.parametrize("bad", ["dtype", "dim", "length", "empty",
                                 "contiguous", "b_bits"])
def test_radix_hist_wrapper_checks_its_inputs(bad):
    words = torch.zeros(256, dtype=torch.int32)
    b_bits = 8
    if bad == "dtype":
        words = words.to(torch.int64)
    elif bad == "dim":
        words = words.view(2, 128)
    elif bad == "length":
        words = words[:200]
    elif bad == "empty":
        words = words[:0]
    elif bad == "contiguous":
        words = torch.zeros(512, dtype=torch.int32)[::2]
    else:
        b_bits = 9
    with pytest.raises((TypeError, ValueError)):
        K.radix_bucket_hist(words, b_bits)
