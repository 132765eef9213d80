"""The port's public surface against the JAX package's.

An AST walk of ``byteps_tpu/`` collects each module's public names:
module-level functions, classes and assignments, the names each
``__init__`` re-exports from the package, and the public methods of
public classes.  Each must resolve by ``getattr`` in the port's
counterpart module, as the same kind (a submodule where the JAX name is
one, a callable where it is a function or class), or stand on
``byteps_tpu_torch._jax_only.JAX_ONLY`` with a reason.  Every keyword of
a ``core/api.py`` function must be accepted by the port's counterpart,
and by the port's top-level name where the JAX top level exports it.
Two controls: a name taken out of a copy of a port module is reported,
and a JAX-only entry that the port defines is reported as stale.

Then the names the port gained here, each against the JAX function on
the same inputs: the integer and enum results bit for bit.
"""

import ast
import inspect
import os
import subprocess
import sys
import types
from importlib import import_module
from pathlib import Path

import numpy as np
import pytest
import torch

import byteps_tpu.common.config as jax_config
import byteps_tpu.core.api as jax_api
from byteps_tpu import native as jax_native
from byteps_tpu.comm import collectives as jax_coll
from byteps_tpu.comm import mesh as jax_mesh
from byteps_tpu.common import handles as jax_handles
from byteps_tpu.common import partitioner as jax_part
from byteps_tpu.common import registry as jax_registry
from byteps_tpu.common import types as jax_types

import byteps_tpu_torch as port
import byteps_tpu_torch.common.config as port_config
from byteps_tpu_torch import native as port_native
from byteps_tpu_torch._jax_only import JAX_ONLY
from byteps_tpu_torch.comm import collectives as port_coll
from byteps_tpu_torch.comm import mesh as port_mesh
from byteps_tpu_torch.common import handles as port_handles
from byteps_tpu_torch.common import partitioner as port_part
from byteps_tpu_torch.common import registry as port_registry
from byteps_tpu_torch.common import types as port_types
from byteps_tpu_torch.core import api as port_api

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "byteps_tpu"
# JAX modules whose counterpart has another name
RENAMED = {"ops.pallas_kernels": "ops.onebit_kernels"}


def _jax_modules():
    """Dotted name below ``byteps_tpu`` ("" for the package) -> file."""
    out = {}
    for path in sorted(JAX_ROOT.rglob("*.py")):
        parts = path.relative_to(JAX_ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out[".".join(parts)] = path
    return out


JAX_MODULES = _jax_modules()


def _is_public(name):
    return not name.startswith("_") or name == "__version__"


def _is_submodule(base: Path, name: str) -> bool:
    return ((base / f"{name}.py").exists()
            or (base / name / "__init__.py").exists())


def public_names(path: Path):
    """[(name, kind)] of a JAX module: kind "def" for a function, class or
    method ("Cls.meth"), "value" for an assignment, "module" for a
    re-exported submodule, "name" for another re-export."""
    tree = ast.parse(path.read_text())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and _is_public(node.name):
            out.append((node.name, "def"))
            if isinstance(node, ast.ClassDef):
                out += [(f"{node.name}.{b.name}", "def") for b in node.body
                        if isinstance(b, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and _is_public(b.name)]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out += [(t.id, "value") for t in targets
                    if isinstance(t, ast.Name) and _is_public(t.id)]
        elif (isinstance(node, ast.ImportFrom) and path.name == "__init__.py"
              and (node.level or (node.module or "").startswith(
                  "byteps_tpu"))):
            if node.level:
                base = path.parents[node.level - 1]
            else:
                base = JAX_ROOT.parent
            base = base.joinpath(*(node.module or "").split(".")) \
                if node.module else base
            for a in node.names:
                name = a.asname or a.name
                if name != "*" and _is_public(name):
                    out.append((name, "module" if _is_submodule(base, a.name)
                                else "name"))
    return out


def _port_name(rel: str) -> str:
    rel = RENAMED.get(rel, rel)
    return "byteps_tpu_torch" + (f".{rel}" if rel else "")


def _listed(qualified: str, jax_only) -> bool:
    parts = qualified.split(".")
    return any(".".join(parts[:i]) in jax_only
               for i in range(1, len(parts) + 1))


def _resolve(obj, dotted: str):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def surface_gaps(rel, port_module, names, jax_only=JAX_ONLY):
    """The names of ``names`` that neither resolve in ``port_module`` as
    the same kind nor stand on ``jax_only``."""
    gaps = []
    for name, kind in names:
        if _listed(f"{rel}.{name}" if rel else name, jax_only):
            continue
        try:
            got = _resolve(port_module, name)
        except AttributeError:
            gaps.append(name)
            continue
        if ((kind == "module") != isinstance(got, types.ModuleType)
                or (kind == "def" and "." not in name and not callable(got))):
            gaps.append(f"{name} ({kind}, is a {type(got).__name__})")
    return gaps


def _accepts(fn, keyword: str) -> bool:
    params = inspect.signature(fn).parameters
    return (any(p.kind is p.VAR_KEYWORD for p in params.values())
            or (keyword in params and params[keyword].kind in (
                inspect.Parameter.POSITIONAL_OR_KEYWORD,
                inspect.Parameter.KEYWORD_ONLY)))


def _jax_api_keywords():
    """Public function of the JAX ``core/api.py`` -> its named arguments."""
    tree = ast.parse(JAX_MODULES["core.api"].read_text())
    return {n.name: [a.arg for a in n.args.args + n.args.kwonlyargs]
            for n in tree.body
            if isinstance(n, ast.FunctionDef) and _is_public(n.name)}


API_KEYWORDS = _jax_api_keywords()
# the JAX top level's names that are core/api.py's functions
TOP_FROM_API = {name for name, kind in public_names(JAX_MODULES[""])
                if name in API_KEYWORDS}


def keyword_gaps(fn_name, jax_only=JAX_ONLY):
    """The keywords of the JAX ``core.api.<fn_name>`` that its port
    counterpart (and the port's top-level name, where the JAX top level
    exports it) does not take, save those on ``jax_only``."""
    targets = [("core.api", getattr(port_api, fn_name, None))]
    if fn_name in TOP_FROM_API:
        targets.append(("top level", getattr(port, fn_name, None)))
    gaps = []
    for where, fn in targets:
        if fn is None:
            gaps.append(f"{where}: no {fn_name}")
            continue
        gaps += [f"{where}: {fn_name}({kw})" for kw in API_KEYWORDS[fn_name]
                 if f"core.api.{fn_name}({kw})" not in jax_only
                 and not _accepts(fn, kw)]
    return gaps


def _port_defines(dotted: str) -> bool:
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = import_module("byteps_tpu_torch." + ".".join(parts[:i]))
        except ImportError:
            continue
        try:
            _resolve(obj, ".".join(parts[i:])) if parts[i:] else obj
        except AttributeError:
            return False
        return True
    return False


def stale_entries(jax_only=JAX_ONLY):
    """The entries of ``jax_only`` that the port does define."""
    stale = []
    for key in jax_only:
        if key.endswith(")"):
            fn, kw = key[:-1].split("(")
            mod, name = fn.rsplit(".", 1)
            got = getattr(import_module(_port_name(mod)), name, None)
            if got is not None and _accepts(got, kw):
                stale.append(key)
        elif _port_defines(key):
            stale.append(key)
    return stale


# --------------------------------------------------------------- the walk

@pytest.mark.parametrize("rel", sorted(JAX_MODULES),
                         ids=lambda r: r or "top")
def test_every_public_name_resolves_or_is_jax_only(rel):
    if _listed(rel, JAX_ONLY):
        # the entry is true of both packages
        with pytest.raises(ImportError):
            import_module(_port_name(rel))
        return
    names = public_names(JAX_MODULES[rel])
    assert surface_gaps(rel, import_module(_port_name(rel)), names) == []


@pytest.mark.parametrize("fn_name", sorted(API_KEYWORDS))
def test_every_api_keyword_is_accepted(fn_name):
    assert keyword_gaps(fn_name) == []


def test_jax_only_entries_name_what_the_jax_side_has():
    """Each entry names a module, a name or a keyword that the JAX
    package (or, for ``tools.*``, the root ``tools/``) does have."""
    missing = []
    for key in JAX_ONLY:
        if key.endswith(")"):
            fn, kw = key[:-1].split("(")
            ok = kw in API_KEYWORDS.get(fn.removeprefix("core.api."), ())
        elif key.startswith("tools."):
            mod, _, name = key.removeprefix("tools.").partition(".")
            path = REPO / "tools" / f"{mod}.py"
            ok = path.exists() and (not name or any(
                n == name for n, _ in public_names(path)))
        else:
            mod = max((m for m in JAX_MODULES
                       if key == m or key.startswith(f"{m}.")), key=len)
            name = key[len(mod):].lstrip(".")
            ok = not name or any(
                n == name for n, _ in public_names(JAX_MODULES[mod]))
        if not ok:
            missing.append(key)
    assert missing == []
    assert all(reason.strip() for reason in JAX_ONLY.values())


def test_no_jax_only_entry_is_stale():
    assert stale_entries() == []


def test_a_removed_name_is_reported():
    rel = "common.types"
    names = public_names(JAX_MODULES[rel])
    mod = import_module(_port_name(rel))
    assert surface_gaps(rel, mod, names) == []
    copy = types.SimpleNamespace(**vars(mod))
    del copy.dtype_name
    assert surface_gaps(rel, copy, names) == ["dtype_name"]
    # a module where the JAX name is a function is a gap too
    ops = types.SimpleNamespace(**vars(import_module("byteps_tpu_torch.ops")))
    ops.flash_attention = import_module("byteps_tpu_torch.ops.flash_attention")
    assert surface_gaps("ops", ops, public_names(JAX_MODULES["ops"])) == [
        "flash_attention (name, is a module)"]
    # and a keyword the port's function does not take
    assert keyword_gaps("resume", {}) == [
        "core.api: resume(devices)", "top level: resume(devices)"]


def test_a_stale_entry_is_reported():
    extra = dict(JAX_ONLY)
    extra["common.partitioner.num_chunks"] = "the port has it"
    extra["core.api.resume(num_servers)"] = "the port takes it"
    extra["utils.timing"] = "the port has it"
    assert stale_entries(extra) == ["common.partitioner.num_chunks",
                                    "core.api.resume(num_servers)",
                                    "utils.timing"]


def test_importing_the_port_builds_and_touches_nothing():
    """Every package of the port imports with jax and the JAX package
    blocked, runs no compiler, loads no library and leaves CUDA alone."""
    pkgs = sorted({_port_name(rel) for rel, p in JAX_MODULES.items()
                   if p.name == "__init__.py" and not _listed(rel, JAX_ONLY)})
    code = (
        "import ctypes, importlib, subprocess, sys\n"
        "import torch\n"
        "cdll = ctypes.CDLL\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'import ran {a[:1]!r}')\n"
        "def load(path, *a, **k):\n"
        "    if 'byteps_tpu_torch' in str(path):\n"
        "        refuse(path)\n"
        "    return cdll(path, *a, **k)\n"
        "class Popen(subprocess.Popen):\n"
        "    def __init__(self, args, *a, **k):\n"
        "        if 'nvcc' in str(args) or 'g++' in str(args):\n"
        "            refuse(args)\n"
        "        super().__init__(args, *a, **k)\n"
        "subprocess.Popen = Popen\n"
        "ctypes.CDLL = load\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['byteps_tpu'] = None\n"
        f"for n in {pkgs!r}:\n"
        "    importlib.import_module(n)\n"
        "from byteps_tpu_torch import native\n"
        "from byteps_tpu_torch.ops import flash_attention, onebit_kernels\n"
        "assert native._lib is None and onebit_kernels._c_fns is None\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"


def test_the_package_level_names_resolve():
    from byteps_tpu_torch.fault import arm  # noqa: F401
    from byteps_tpu_torch.models import resnet50
    from byteps_tpu_torch.ops import flash_attention
    from byteps_tpu_torch.utils import CheckpointManager  # noqa: F401
    from byteps_tpu_torch.ops.flash_attention import flash_attention as f
    assert flash_attention is f and callable(resnet50)
    assert port.start_serving is port_api.start_serving
    star = {}
    exec("from byteps_tpu_torch import *", star)
    assert {"start_serving", "start_serving_tier", "durable_kv_store",
            "PullClient", "ServingPlane", "ServingTier", "SnapshotStore",
            "DistributedOptimizer", "push_pull"} <= set(star)
    assert port.__version__ == import_module("byteps_tpu").__version__


# ------------------------------------------------- the new names' parity

BOUNDS_CASES = [(0, 4, 4096), (1, 4, 4096), (1000, 4, 4096),
                (10_000, 4, 4096), (1_000_003, 2, 65536), (7, 8, 1),
                (25_557_032, 4, 4 << 20)]


@pytest.mark.parametrize("n,itemsize,bound", BOUNDS_CASES)
def test_num_chunks_and_native_chunk_bounds_match_jax(n, itemsize, bound):
    assert port_part.num_chunks(n, itemsize, bound) == \
        jax_part.num_chunks(n, itemsize, bound)
    for align in (512, 128):
        assert port_native.chunk_bounds(n, itemsize, bound, align) == \
            jax_native.chunk_bounds(n, itemsize, bound, align)


def test_flatten_array_matches_jax():
    a = np.random.RandomState(0).randn(3, 4, 5).astype(np.float32)
    np.testing.assert_array_equal(port_part.flatten_array(a),
                                  jax_part.flatten_array(a))
    t = torch.from_numpy(a)
    np.testing.assert_array_equal(port_part.flatten_array(t).numpy(),
                                  jax_part.flatten_array(a))
    assert port_part.flatten_array(t).data_ptr() == t.data_ptr()


def test_make_key_matches_jax():
    for declared, part in ((0, 0), (3, 5), (1 << 20, 0xFFFF), (7, 0x1_0003),
                           (123456, 42)):
        assert port_native.make_key(declared, part) == \
            jax_native.make_key(declared, part)
        if part <= 0xFFFF:
            assert port_types.make_key(declared, part) == \
                jax_types.make_key(declared, part)


def _same_bits(a, b):
    return a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype,strided", [(np.float32, False),
                                           (np.float32, True),
                                           (np.float64, False),
                                           (np.float16, False)])
def test_inplace_scaled_add_matches_jax(dtype, strided):
    rng = np.random.RandomState(5)
    dst = rng.randn(2, 300_001).astype(dtype)
    src = rng.randn(2, 300_001).astype(dtype)
    if strided:
        dst, src = dst[:, ::2], src[:, ::2]
    want, got = dst.copy(), dst.copy()
    jax_native.inplace_scaled_add(want, src, -0.37)
    assert port_native.inplace_scaled_add(got, src, -0.37) is got
    assert _same_bits(got, want)
    t = torch.from_numpy(dst.copy())
    port_native.inplace_scaled_add(t, torch.from_numpy(src.copy()), -0.37)
    if dtype == np.float32:       # the native reducer on tensors too
        assert _same_bits(t.numpy(), want)
    else:
        # torch keeps alpha unrounded where numpy rounds it to the dtype:
        # one step of the dtype apart at most
        step = np.finfo(dtype).eps * np.abs(want).max()
        np.testing.assert_allclose(t.numpy(), want, rtol=0, atol=step)


def test_native_available_matches_jax(monkeypatch):
    assert port_native.available() is jax_native.available() is True
    port_config.set_config(port_config.Config(use_native=False))
    jax_config.set_config(jax_config.Config(use_native=False))
    try:
        # a loaded library stays available; an unloaded one is not built
        assert port_native.available() is jax_native.available() is True
        monkeypatch.setattr(port_native, "_lib", None)
        monkeypatch.setattr(jax_native, "_lib", None)
        assert port_native.available() is jax_native.available() is False
        assert port_native.make_key(3, 5) == jax_native.make_key(3, 5)
        assert port_native.chunk_bounds(10_000, 4, 4096) == \
            jax_native.chunk_bounds(10_000, 4, 4096)
    finally:
        port_config.reset_config()
        jax_config.reset_config()


DTYPES = [np.float32, np.dtype("int64"), "float16", "f4", np.uint8,
          "bfloat16", "float64", np.int8, "int32", np.bool_, "complex64",
          np.int16, "nonsense"]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_dtype_name_matches_jax(dtype):
    try:
        want = jax_types.dtype_name(dtype)
    except TypeError as e:
        with pytest.raises(TypeError) as got:
            port_types.dtype_name(dtype)
        assert str(got.value) == str(e)
    else:
        assert port_types.dtype_name(dtype) == want


def test_data_types_and_torch_dtypes():
    assert list(port_types.DATA_TYPES) == list(jax_types.DATA_TYPES)
    for name, dt in port_types.DATA_TYPES.items():
        assert port_types.dtype_name(dt) == name
        assert torch.empty(0, dtype=dt).element_size() == \
            np.dtype(jax_types.DATA_TYPES[name]).itemsize


@pytest.mark.parametrize("enum_name", ["Stage", "DeviceKind", "StatusCode"])
def test_enums_match_jax(enum_name):
    want = {m.name: m.value for m in getattr(jax_types, enum_name)}
    assert {m.name: m.value for m in getattr(port_types, enum_name)} == want
    assert list(getattr(port_types, enum_name).__members__) == list(want)


def test_status_in_progress_matches_jax():
    got, want = port_types.Status.in_progress(), jax_types.Status.in_progress()
    assert got.code.value == want.code.value and got.reason == want.reason
    got.ok_or_raise()


def test_handle_manager_get_and_registry_clear_match_jax():
    for HM in (port_handles.HandleManager, jax_handles.HandleManager):
        hm = HM()
        h = hm.allocate("a")
        assert hm.get(h.id) is h and hm.get(h.id + 1) is None
        hm.release(h.id)
        assert hm.get(h.id) is None
    keys = []
    for TR in (port_registry.TensorRegistry, jax_registry.TensorRegistry):
        reg = TR()
        ks = [reg.declare(n).declared_key for n in ("a", "b")]
        reg.clear()
        ks += [reg.get("a") is None, reg.declare("b").declared_key,
               reg.names_in_declaration_order()]
        keys.append(ks)
    assert keys[0] == keys[1] == [0, 1, True, 0, ["b"]]


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_push_pull_array_scaled_one_gloo_rank_matches_jax(dtype,
                                                         monkeypatch):
    import jax
    x = np.random.RandomState(9).randn(10_000).astype(dtype)
    jcomm = jax_mesh.CommContext(
        mesh=jax_mesh._build_mesh(jax.devices()[:1], 1), n_dcn=1, n_ici=1)
    want = np.asarray(jax_coll.push_pull_array_scaled(jcomm, x[None], 0.37))
    # the context is process-wide: start this case from none
    monkeypatch.setattr(port_mesh, "_comm", None)
    assert not port_mesh.comm_initialized()
    with pytest.raises(RuntimeError):
        port_mesh.get_comm()
    comm = port_mesh.bootstrap(port_config.Config(), torch.device("cpu"))
    try:
        assert port_mesh.comm_initialized() and port_mesh.get_comm() is comm
        assert comm.num_ranks == 1
        got = port_coll.push_pull_array_scaled(comm, torch.from_numpy(x),
                                               0.37)
    finally:
        port_mesh.shutdown_comm()
    assert not port_mesh.comm_initialized()
    assert _same_bits(got.numpy(), want)


RESUME_ENV = ("DMLC_NUM_WORKER", "DMLC_NUM_SERVER", "DMLC_WORKER_ID",
              "BYTEPS_GLOBAL_RANK")


def _resume_writes(monkeypatch, resume, kwargs):
    for k in RESUME_ENV:
        monkeypatch.setenv(k, "")      # records the value to restore
        monkeypatch.delenv(k)
    resume(**kwargs)
    return {k: os.environ.get(k) for k in RESUME_ENV}


@pytest.mark.parametrize("kwargs", [
    {"num_servers": 1, "global_rank": 0},
    {"num_workers": 2, "num_servers": 3, "global_rank": 1},
    {"num_servers": 2}])
def test_resume_writes_the_environment_as_jax(monkeypatch, kwargs):
    """``resume`` as the reference signs it: the same environment writes
    as the JAX ``resume`` (each engine start stubbed; the environment is
    restored after)."""
    started = []
    monkeypatch.setattr(jax_api, "init",
                        lambda config=None, devices=None: started.append(
                            ("jax", config is not None)))
    monkeypatch.setattr(port_api, "_start",
                        lambda config, device, names: started.append(
                            ("port", config is not None)))
    want = _resume_writes(monkeypatch, jax_api.resume, kwargs)
    got = _resume_writes(monkeypatch, port.resume, kwargs)
    assert got == want
    assert want["DMLC_NUM_SERVER"] == str(kwargs["num_servers"])
    assert started == [("jax", "global_rank" in kwargs),
                       ("port", True)]


def test_top_level_push_pull_takes_op_and_priority():
    port.init(device="cpu")
    try:
        x = torch.arange(6, dtype=torch.float32)
        torch.testing.assert_close(
            port.push_pull(x, name="surface.sum", op="sum", priority=3), x)
        torch.testing.assert_close(
            port.push_pull_async(x, name="surface.avg", op="average").wait(),
            x)
        with pytest.raises(TypeError, match="name="):
            port.push_pull(x, "surface.positional")
        with pytest.raises(ValueError, match="op must be"):
            port.push_pull(x, name="surface.bad", op="max")
        with pytest.raises(ValueError, match="contradicts"):
            port.push_pull(x, name="surface.both", average=True, op="sum")
        torch.testing.assert_close(
            port.push_pull(x, name="surface.agree", average=False, op="sum"),
            x)
    finally:
        port.shutdown()
