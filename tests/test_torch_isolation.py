"""The port stands alone: no JAX, no JAX package, CUDA unless asked.

- No module of ``semantic_merge_tpu_torch`` and not ``chip_smoke.py``
  imports ``jax*``, ``optax``, ``orbax`` or ``semantic_merge_tpu``
  (checked on the syntax tree, so imports inside functions count).
- Importing every module of the port leaves ``jax`` and the JAX package
  out of ``sys.modules``.
- Without a CUDA device the CLI (without ``--device cpu``) and
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


@pytest.mark.parametrize("command,code", [("semdiff", 2), ("semmerge", 11)])
def test_cli_without_cuda_fails_clearly(tmp_path, command, code):
    # semmerge exits with the KernelFault code (never 2, "type errors")
    # before it reads a revision or touches the work tree.
    repo = tmp_path / "repo"
    (repo / "src").mkdir(parents=True)
    (repo / "src" / "a.ts").write_text("export function f(): void {}\n")
    for args in (["init", "-q", "-b", "main"], ["add", "-A"],
                 ["-c", "user.email=t@example.com", "-c", "user.name=t",
                  "commit", "-q", "-m", "base"]):
        subprocess.run(["git", *args], cwd=repo, check=True)
    before = _tree_state(repo)
    argv = {"semdiff": ["HEAD", "HEAD", "--json-out"],
            "semmerge": ["HEAD", "HEAD", "HEAD", "--inplace"]}[command]
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
