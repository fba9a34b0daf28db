"""The port stands alone: no JAX, no JAX package, CUDA unless asked.

- No module of ``semantic_merge_tpu_torch`` and not ``chip_smoke.py``
  imports ``jax*``, ``optax``, ``orbax`` or ``semantic_merge_tpu``
  (checked on the syntax tree, so imports inside functions count).
- Importing every module of the port leaves ``jax`` and the JAX package
  out of ``sys.modules``.
- The strict, statement-op, native-scan and git-facing modules
  (faults, ladder, resolution tier, driver), the telemetry modules
  (``obs/``, ``runtime/trace.py``, ``utils/loggingx.py``,
  ``utils/workdir.py``) and the merge service's (``service/``,
  ``batch/``, ``utils/reqenv.py``) are among them; the service client's
  path imports neither torch nor numpy; the merge driver and ``obs/``
  import the standard library only (and their own package); the
  native scanner is the port's own build of its own copy of the C++
  source, never the JAX package's ``native/`` library.
- The other languages and the worker seam (``frontend/cfamily.py``,
  ``backends/``, ``runtime/worker.py``) are among them, and the
  subprocess backend's default worker is the port's own
  (``semantic_merge_tpu_torch.runtime.worker``), never the JAX
  package's, on the card unless the caller is on the CPU.
- The fleet (``fleet/``: the router, hash ring, WAL and transport) is
  among them and imports the standard library only (and its own
  package); importing the router loads neither torch nor JAX.
- The device CRDT, the keyed encode, the native op serializer and op
  factory, and the chaos soak (``ops/crdt.py``, ``core/encode.py``,
  ``frontend/native.py``, ``frontend/opfactory.c``,
  ``scripts/chaos_soak.py``) are among them; no module imports the
  repository's ``scripts/``; the soak imports the standard library only
  (and its own package), and importing it loads neither torch nor JAX;
  the op factory is the port's own build of its own copy of the C
  source, never the JAX package's ``native/`` extension.
- Without a CUDA device the CLI's three commands and ``train-matcher``
  (without ``--device cpu``) and
  ``chip_smoke.py`` exit non-zero and say why; neither carries on on
  the CPU, ``semmerge`` leaves the work tree as it was, and the smoke
  test prints no result.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO_ROOT / "semantic_merge_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "semantic_merge_tpu")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO_ROOT)))
def test_no_forbidden_imports(path):
    assert not (_imported_roots(path) & set(FORBIDDEN)), path


#: The fused engine's modules: each must be among the sources checked
#: above, with its own copies of the host code it needs.
FUSED_MODULES = ("ops/sha256.py", "ops/fused.py", "ops/oplog_view.py", "ops/render.py",
                 "runtime/applier.py", "backends/ts_torch.py")


@pytest.mark.parametrize("module", FUSED_MODULES)
def test_fused_modules_are_checked_and_stand_alone(module):
    path = PORT / module
    assert path in _port_sources()
    roots = _imported_roots(path)
    assert not roots & set(FORBIDDEN), roots
    assert (PORT / "kernels" / "sha256.cu").is_file()


#: The modules of the strict, statement-op and native-scan slice: each
#: checked above, the C++ scanner's source beside them.
STRICT_SCAN_MODULES = ("core/strict_conflicts.py", "core/difflift.py", "core/conflict.py",
                       "frontend/native.py", "frontend/declcache.py", "frontend/scanner.py")


@pytest.mark.parametrize("module", STRICT_SCAN_MODULES)
def test_strict_and_scan_modules_are_checked_and_stand_alone(module):
    path = PORT / module
    assert path in _port_sources()
    assert not _imported_roots(path) & set(FORBIDDEN)
    assert (PORT / "frontend" / "semmerge_native.cpp").is_file()


#: The modules of the git-facing slice (fault taxonomy and injection, the
#: CLI's ladder, the resolution tier, the merge driver): each checked
#: above.
GIT_SLICE_MODULES = ("errors.py", "utils/faults.py", "cli.py", "driver.py",
                     "resolve/__init__.py", "resolve/base.py", "resolve/search.py",
                     "resolve/engine.py", "runtime/verify.py", "ops/compose.py")


@pytest.mark.parametrize("module", GIT_SLICE_MODULES)
def test_git_slice_modules_are_checked_and_stand_alone(module):
    path = PORT / module
    assert path in _port_sources()
    assert not _imported_roots(path) & set(FORBIDDEN)


#: The telemetry slice: the port's own copies of the JAX package's
#: ``obs/`` (one-shot half), ``runtime/trace.py`` and the utils they use.
TELEMETRY_MODULES = ("obs/__init__.py", "obs/metrics.py", "obs/spans.py", "obs/flight.py",
                     "obs/device.py", "obs/anomaly.py", "obs/report.py", "runtime/trace.py",
                     "utils/loggingx.py", "utils/workdir.py")


@pytest.mark.parametrize("module", TELEMETRY_MODULES)
def test_telemetry_modules_are_checked_and_stand_alone(module):
    path = PORT / module
    assert path in _port_sources()
    roots = _imported_roots(path)
    assert not roots & set(FORBIDDEN), roots
    if module.startswith("obs/") or module.startswith("utils/"):
        # Imported at module top by every layer: the standard library
        # only (the device block asks torch inside its functions, once a
        # backend chose a CUDA device).
        allowed = {"torch"} if module == "obs/device.py" else set()
        assert roots <= set(sys.stdlib_module_names) | {"__future__"} | allowed, roots


#: The merge service slice: the daemon, its client and supervisor, the
#: batching subsystem, warm residency and the daemon-side telemetry.
SERVICE_MODULES = ("service/__init__.py", "service/protocol.py", "service/client.py",
                   "service/daemon.py", "service/supervisor.py", "service/resilience.py",
                   "service/residency.py", "service/telemetry.py", "batch/__init__.py",
                   "batch/packer.py", "batch/scheduler.py", "batch/dispatcher.py",
                   "utils/reqenv.py", "obs/agg.py", "obs/sampling.py", "obs/slo.py",
                   "obs/anomaly.py", "frontend/snapshot.py", "__main__.py")


@pytest.mark.parametrize("module", SERVICE_MODULES)
def test_service_modules_are_checked_and_stand_alone(module):
    path = PORT / module
    assert path in _port_sources()
    roots = _imported_roots(path)
    assert not roots & set(FORBIDDEN), roots
    if not module.startswith("batch/"):
        # The client path (``__main__`` → service.client) runs before
        # torch is imported; the daemon asks torch for the card's name
        # inside a function. The rest: the standard library.
        allowed = {"torch"} if module == "service/daemon.py" else set()
        assert roots <= set(sys.stdlib_module_names) | {"__future__"} | allowed, roots


#: The training slice: the loop, its evaluation, the backward kernel's
#: wrapper and the autograd Function around the attention.
TRAINING_MODULES = ("models/training.py", "models/evaluate.py", "models/matcher.py",
                    "models/encoder.py", "parallel/flash.py", "parallel/ring.py")


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_modules_are_checked_and_stand_alone(module):
    path = PORT / module
    assert path in _port_sources()
    assert not _imported_roots(path) & set(FORBIDDEN)


#: The other languages and the worker seam: the C-family scanner, the
#: backend registry, the C-family, routing and subprocess backends, the
#: worker.
LANGUAGE_MODULES = ("frontend/cfamily.py", "backends/base.py", "backends/cfamily.py",
                    "backends/java.py", "backends/cs.py", "backends/multi.py",
                    "backends/subproc.py", "runtime/worker.py", "runtime/git.py",
                    "config.py")


@pytest.mark.parametrize("module", LANGUAGE_MODULES)
def test_language_and_worker_modules_are_checked_and_stand_alone(module):
    path = PORT / module
    assert path in _port_sources()
    roots = _imported_roots(path)
    assert not roots & set(FORBIDDEN), roots
    text = path.read_text()
    assert "semantic_merge_tpu." not in text.replace("semantic_merge_tpu_torch.", "")


#: The fleet slice: the routing tier and the member side it needs.
FLEET_MODULES = ("fleet/__init__.py", "fleet/hashring.py", "fleet/wal.py",
                 "fleet/transport.py", "fleet/router.py", "service/supervisor.py",
                 "service/telemetry.py", "service/client.py", "service/daemon.py")


@pytest.mark.parametrize("module", FLEET_MODULES)
def test_fleet_modules_are_checked_and_stand_alone(module):
    path = PORT / module
    assert path in _port_sources()
    roots = _imported_roots(path)
    assert not roots & set(FORBIDDEN), roots
    allowed = {"torch"} if module == "service/daemon.py" else set()
    assert roots <= set(sys.stdlib_module_names) | {"__future__"} | allowed, roots
    text = path.read_text()
    assert "semantic_merge_tpu." not in text.replace("semantic_merge_tpu_torch.", "")


def test_router_import_loads_no_torch_and_no_jax():
    code = ("import sys\nimport semantic_merge_tpu_torch.fleet.router\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{('torch', 'numpy') + FORBIDDEN!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO_ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_default_worker_argv_names_only_the_port(device):
    from semantic_merge_tpu_torch.backends.subproc import default_worker_cmd
    argv = default_worker_cmd(device)
    modules = [a for a in argv if a.startswith("semantic_merge_tpu")]
    assert modules == ["semantic_merge_tpu_torch.runtime.worker"]
    assert ("--device" in argv) == (device == "cpu")
    assert argv[argv.index("-m") - 1] == sys.executable


def test_client_path_imports_no_torch():
    code = ("import sys\nfrom semantic_merge_tpu_torch.service import client\n"
            "client.delegate(['semdiff', 'a', 'b'])\n"
            "print(sorted(m for m in ('torch', 'numpy') if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(SEMMERGE_DAEMON="off"),
                         cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_driver_imports_the_standard_library_only():
    # Git starts the driver once per conflicted file: no torch, no numpy.
    roots = _imported_roots(PORT / "driver.py")
    assert roots <= set(sys.stdlib_module_names) | {"__future__"}, roots
    package_init = PORT / "__init__.py"
    assert _imported_roots(package_init) <= set(sys.stdlib_module_names)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ compiler (g++) on PATH")
def test_native_library_comes_from_the_port_build_dir():
    # The JAX package's own library (native/) may sit built beside it;
    # the port must load the one it built from its own copy.
    code = ("import pathlib\n"
            "from semantic_merge_tpu_torch.frontend import native, scanner\n"
            "scanner.scan_snapshot([{'path': 'a.ts', 'content': 'function f() {}'}])\n"
            "maps = pathlib.Path('/proc/self/maps').read_text()\n"
            "libs = sorted({l.split()[-1] for l in maps.splitlines() if 'semmerge' in l})\n"
            "print(native._lib._name); print(native.library_path()); print(libs)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO_ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    loaded, expected, libs = out.stdout.splitlines()
    build_dir = PORT / "frontend" / "_build"
    assert loaded == expected and pathlib.Path(loaded).parent == build_dir
    assert libs == repr([loaded])
    assert "native/" not in libs


#: The device CRDT, keyed encode, native op serializer and factory, and
#: the chaos soak.
SLICE15_MODULES = ("ops/crdt.py", "core/encode.py", "frontend/native.py",
                   "ops/oplog_view.py", "runtime/applier.py", "backends/multi.py",
                   "scripts/__init__.py", "scripts/chaos_soak.py")


@pytest.mark.parametrize("module", SLICE15_MODULES)
def test_slice15_modules_are_checked_and_stand_alone(module):
    path = PORT / module
    assert path in _port_sources()
    roots = _imported_roots(path)
    assert not roots & set(FORBIDDEN + ("scripts",)), roots
    text = path.read_text()
    assert "semantic_merge_tpu." not in text.replace("semantic_merge_tpu_torch.", "")
    if module.startswith("scripts/"):
        assert roots <= set(sys.stdlib_module_names) | {"__future__"}, roots
    assert (PORT / "frontend" / "opfactory.c").is_file()


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO_ROOT)))
def test_no_module_imports_the_repositorys_scripts(path):
    assert "scripts" not in _imported_roots(path), path


def test_soak_import_loads_no_torch_and_no_jax():
    code = ("import sys\nimport semantic_merge_tpu_torch.scripts.chaos_soak as soak\n"
            "assert soak.PACKAGE == 'semantic_merge_tpu_torch'\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{('torch',) + FORBIDDEN!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO_ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ compiler (g++) on PATH")
def test_op_factory_comes_from_the_port_build_dir():
    # The JAX package's own extension (native/) may sit built beside it;
    # the port must load the one it built from its own copy.
    code = ("import pathlib\n"
            "from semantic_merge_tpu_torch.frontend import native\n"
            "fac = native.load_opfactory()\n"
            "maps = pathlib.Path('/proc/self/maps').read_text()\n"
            "libs = sorted({l.split()[-1] for l in maps.splitlines() if 'semmerge' in l})\n"
            "print(fac.__file__); print(native.opfactory_path()); print(libs)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO_ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    loaded, expected, libs = out.stdout.splitlines()
    assert loaded == expected
    assert pathlib.Path(loaded).parent == PORT / "frontend" / "_build"
    assert libs == repr([loaded])
    assert "native/" not in libs


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), CUDA_VISIBLE_DEVICES="")
    env.update(extra)
    return env


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        "semantic_merge_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name not in ("__init__.py", "__main__.py"))
    code = (f"import sys, importlib\nfor m in {modules!r}:\n    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\nprint(len({modules!r}), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO_ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"{len(modules)} []"


def _tree_state(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("command,code", [("semdiff", 2), ("semmerge", 11), ("semrebase", 11),
                                          ("train-matcher", 2)])
def test_cli_without_cuda_fails_clearly(tmp_path, command, code):
    # semmerge exits with the KernelFault code (never 2, "type errors")
    # before it reads a revision or touches the work tree; train-matcher
    # exits 2, as semdiff does, before it trains or writes a checkpoint.
    repo = tmp_path / "repo"
    (repo / "src").mkdir(parents=True)
    (repo / "src" / "a.ts").write_text("export function f(): void {}\n")
    for args in (["init", "-q", "-b", "main"], ["add", "-A"],
                 ["-c", "user.email=t@example.com", "-c", "user.name=t",
                  "commit", "-q", "-m", "base"]):
        subprocess.run(["git", *args], cwd=repo, check=True)
    before = _tree_state(repo)
    argv = {"semdiff": ["HEAD", "HEAD", "--json-out"],
            "semmerge": ["HEAD", "HEAD", "HEAD", "--inplace"],
            "semrebase": ["HEAD", "HEAD", "--inplace"],
            "train-matcher": ["--steps", "1", "--ckpt-dir", "ck"]}[command]
    out = subprocess.run([sys.executable, "-m", "semantic_merge_tpu_torch", command, *argv],
                         env=_env(), cwd=repo, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, timeout=120)
    assert out.returncode == code
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
    assert _tree_state(repo) == before


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script-alone"])
def test_chip_smoke_refuses_without_cuda(tmp_path, alone):
    script = REPO_ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], env=_env(PYTHONPATH=""),
                         cwd=script.parent, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "FAIL" in out.stderr
