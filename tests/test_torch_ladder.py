"""The port's degradation ladder and fault injection against the JAX CLI.

Each case runs ``python -m semantic_merge_tpu_torch semmerge ...
--device cpu`` and ``python -m semantic_merge_tpu semmerge ... --backend
tpu`` (``JAX_PLATFORMS=cpu``) in fresh copies of one repository (the
``repo`` fixture of ``tests/test_faults.py``: A renames ``foo``, B adds
a file and edits ``notes.txt``, so the semantic and the textual merge
agree) under the same ``SEMMERGE_FAULT`` and compares the exit code, the
work tree's bytes (``.semmerge-conflicts.json`` included), ``git status
--porcelain`` and both notes. The JAX CLI's flight-recorder dumps
(``.semmerge-postmortem/``, telemetry the port does not write yet) are
left out of both.

- ``LADDER``: scan, apply and emit × fault and raise in the default
  posture: both exit 0 on the textual rung, with the same tree, equal to
  an independent whole-tree textual merge.
- ``STRICT``: the JAX matrix's rows for these stages under
  ``SEMMERGE_STRICT=1``, and ``--no-degrade``: the same exit code, the
  tree untouched. ``scan:raise`` under ``--no-degrade`` exits 10 in
  both: the scan's own class, not the device engine's 11.
- Device faults: ``kernel:fault`` and ``kernel:raise`` exit 11 with the
  tree untouched under every posture (the JAX CLI instead merges a
  ``kernel:fault`` run on its host backend: the one difference), and a
  native scanner that cannot be built exits 10 without degrading; the
  engine runs once, on the one device asked for: there is no CPU rung.
"""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from semantic_merge_tpu import errors as jax_errors
from semantic_merge_tpu.utils import faults as jax_faults
from semantic_merge_tpu_torch import cli, errors
from semantic_merge_tpu_torch.utils import faults

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent

#: Written by the JAX CLI only (its flight recorder).
JAX_ONLY = ".semmerge-postmortem"


def _git(args, cwd):
    env = dict(os.environ, GIT_AUTHOR_DATE="2024-01-01T00:00:00Z",
               GIT_COMMITTER_DATE="2024-01-01T00:00:00Z")
    subprocess.run(["git", *args], cwd=cwd, check=True, env=env,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def make_repo(root):
    root.mkdir(parents=True)
    _git(["init", "-q", "-b", "main"], root)
    _git(["config", "user.email", "t@example.com"], root)
    _git(["config", "user.name", "t"], root)
    (root / "src").mkdir()
    (root / "src/util.ts").write_text(
        "export function foo(n: number): number {\n  return n;\n}\n")
    (root / "notes.txt").write_text("hello\n")
    _git(["add", "-A"], root)
    _git(["commit", "-q", "-m", "base"], root)
    _git(["branch", "basebr"], root)
    _git(["checkout", "-qb", "brA"], root)
    (root / "src/util.ts").write_text(
        "export function bar(n: number): number {\n  return n;\n}\n")
    _git(["commit", "-qam", "rename foo->bar"], root)
    _git(["checkout", "-q", "main"], root)
    _git(["checkout", "-qb", "brB"], root)
    (root / "extra.ts").write_text(
        "export function extra(s: string): string { return s; }\n")
    (root / "notes.txt").write_text("hello\nworld\n")
    _git(["add", "-A"], root)
    _git(["commit", "-qm", "add extra + edit notes"], root)
    _git(["checkout", "-q", "main"], root)
    return root


def tree_bytes(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and not {".git", JAX_ONLY} & set(p.relative_to(root).parts)}


def git_status(root):
    out = subprocess.run(["git", "status", "--porcelain", "--untracked-files=all"],
                         cwd=root, check=True, stdout=subprocess.PIPE, text=True).stdout
    return [line for line in out.splitlines() if JAX_ONLY not in line]


def notes(root):
    return [subprocess.run(["git", "notes", "--ref", "semmerge", "show", rev], cwd=root,
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL).stdout
            for rev in ("brA", "brB")]


def textual_oracle(root):
    """The whole-tree three-way text merge of basebr/brA/brB, computed
    from the tars by the JAX package's text layer."""
    from semantic_merge_tpu.runtime.git import archive_bytes, temp_tree
    from semantic_merge_tpu.runtime.textmerge import apply_text_fallback
    tars = [archive_bytes(rev, cwd=root) for rev in ("basebr", "brA", "brB")]
    with temp_tree(tars[0]) as tree:
        conflicts, deleted, _ = apply_text_fallback(tree, *tars,
                                                    indexed_extensions=frozenset())
        assert not conflicts and not deleted
        return tree_bytes(tree)


#: name → (SEMMERGE_FAULT, extra environment, extra flags)
LADDER = {f"{stage}:{kind}": (f"{stage}:{kind}", {}, [])
          for stage in ("scan", "apply", "emit") for kind in ("fault", "raise")}
#: name → (SEMMERGE_FAULT, extra environment, extra flags, exit code)
STRICT = {
    "scan:fault": ("scan:fault", {"SEMMERGE_STRICT": "1"}, [], 10),
    "apply:fault": ("apply:fault", {"SEMMERGE_STRICT": "1"}, [], 13),
    "apply:raise": ("apply:raise", {"SEMMERGE_STRICT": "1"}, [], 13),
    "emit:fault": ("emit:fault", {"SEMMERGE_STRICT": "1"}, [], 14),
    "apply:fault --no-degrade": ("apply:fault", {}, ["--no-degrade"], 13),
    "scan:raise --no-degrade": ("scan:raise", {}, ["--no-degrade"], 10),
}
#: Postures a device fault must exit 11 under.
POSTURES = {"default": ({}, []), "strict_env": ({"SEMMERGE_STRICT": "1"}, []),
            "no_degrade": ({}, ["--no-degrade"]), "resolve_auto": ({}, ["--resolve", "auto"]),
            "resolve_require": ({"SEMMERGE_RESOLVE": "require"}, [])}


def _run_all(jobs, limit=8):
    """Runs ``jobs`` ({key: (cwd, argv, env)}), at most ``limit`` at
    once; returns {key: (exit code, stdout, stderr)}."""
    pending, running, done = list(jobs.items()), {}, {}
    try:
        while pending or running:
            while pending and len(running) < limit:
                key, (cwd, argv, env) = pending.pop(0)
                running[key] = subprocess.Popen(
                    [sys.executable, "-m", *argv], cwd=cwd, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            key = next(iter(running))
            proc = running.pop(key)
            out, err = proc.communicate(timeout=300)
            done[key] = (proc.returncode, out, err)
    finally:
        for proc in running.values():
            proc.kill()
            proc.wait()
    return done


SIDES = {"jax": ("semantic_merge_tpu", ["--backend", "tpu"]),
         "port": ("semantic_merge_tpu_torch", ["--device", "cpu"])}


@pytest.fixture(scope="module")
def ladder_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("ladder")
    origin = make_repo(work / "origin")
    base_env = {k: v for k, v in os.environ.items()
                if k != "XLA_FLAGS" and not k.startswith("SEMMERGE_")}
    base_env.update(PYTHONPATH=str(REPO_ROOT), JAX_PLATFORMS="cpu", SEMMERGE_DAEMON="off")
    cases = {("ladder", name): spec for name, spec in LADDER.items()}
    cases.update({("strict", name): spec[:3] for name, spec in STRICT.items()})
    cases.update({("device", name): ("kernel:fault", env, flags)
                  for name, (env, flags) in POSTURES.items()})
    cases[("device", "kernel:raise")] = ("kernel:raise", {}, [])
    jobs, copies = {}, {}
    for (group, name), (fault, env, flags) in cases.items():
        for side, (module, extra) in SIDES.items():
            if group == "device" and side == "jax" and name != "default":
                continue
            copy = work / f"{group}-{name.replace(':', '_').replace(' ', '')}-{side}"
            shutil.copytree(origin, copy)
            copies[group, name, side] = copy
            jobs[group, name, side] = (
                copy, [module, "semmerge", "basebr", "brA", "brB", "--inplace", *flags,
                       *extra], dict(base_env, SEMMERGE_FAULT=fault, **env))
    runs = {}
    for key, (code, out, err) in _run_all(jobs).items():
        copy = copies[key]
        runs[key] = {"code": code, "stdout": out, "stderr": err, "tree": tree_bytes(copy),
                     "status": git_status(copy), "notes": notes(copy)}
    return {"runs": runs, "before": tree_bytes(origin), "status": git_status(origin),
            "textual": textual_oracle(origin)}


def _same(got, want):
    assert got["code"] == want["code"], got["stderr"]
    assert got["tree"] == want["tree"]
    assert got["status"] == want["status"]
    assert got["notes"] == want["notes"]


@pytest.mark.parametrize("name", sorted(LADDER))
def test_host_fault_degrades_to_the_jax_textual_tree(ladder_runs, name):
    runs = ladder_runs["runs"]
    want, got = runs["ladder", name, "jax"], runs["ladder", name, "port"]
    assert want["code"] == 0, want["stderr"]
    _same(got, want)
    assert got["tree"] == ladder_runs["textual"]
    assert "merge degrading torch -> text" in got["stderr"]
    assert not any(p.startswith(".semmerge-") for p in got["tree"])


@pytest.mark.parametrize("name", sorted(STRICT))
def test_strict_mode_exits_with_the_jax_code_tree_untouched(ladder_runs, name):
    runs = ladder_runs["runs"]
    want, got = runs["strict", name, "jax"], runs["strict", name, "port"]
    assert want["code"] == STRICT[name][-1], want["stderr"]
    _same(got, want)
    assert got["tree"] == ladder_runs["before"]
    assert got["status"] == ladder_runs["status"]
    assert "degrading" not in got["stderr"]


def test_no_degrade_equals_strict_env(ladder_runs):
    runs = ladder_runs["runs"]
    flag, env = runs["strict", "apply:fault --no-degrade", "port"], \
        runs["strict", "apply:fault", "port"]
    assert flag["code"] == env["code"] == errors.ApplyFault.exit_code
    assert flag["tree"] == env["tree"] == ladder_runs["before"]


def test_scan_raise_is_a_parse_fault_not_the_engines(ladder_runs):
    got = ladder_runs["runs"]["strict", "scan:raise --no-degrade", "port"]
    assert got["code"] == errors.ParseFault.exit_code != errors.KernelFault.exit_code
    assert "ParseFault" in got["stderr"] and "KernelFault" not in got["stderr"]


@pytest.mark.parametrize("name", sorted(POSTURES) + ["kernel:raise"])
def test_device_fault_never_degrades(ladder_runs, name):
    got = ladder_runs["runs"]["device", name, "port"]
    assert got["code"] == errors.KernelFault.exit_code, got["stderr"]
    assert got["tree"] == ladder_runs["before"]
    assert got["status"] == ladder_runs["status"]
    assert got["notes"] == [b"", b""]
    assert "degrading" not in got["stderr"] and "KernelFault" in got["stderr"]


def test_jax_cli_merges_a_kernel_fault_on_its_host_rung(ladder_runs):
    """The one deliberate difference: the JAX CLI hides this fault."""
    want = ladder_runs["runs"]["device", "default", "jax"]
    assert want["code"] == 0
    assert want["tree"] != ladder_runs["before"]


def _checked_out(tmp_path, monkeypatch):
    repo = make_repo(tmp_path / "repo")
    monkeypatch.chdir(repo)
    for key in [k for k in os.environ if k.startswith("SEMMERGE_")]:
        monkeypatch.delenv(key)
    faults.reset()
    return repo


def test_no_cpu_rung_the_engine_runs_once_on_the_device_asked_for(tmp_path, monkeypatch):
    """A device fault ends the run: one backend, one engine attempt, no
    second attempt on another device, no text rung."""
    from semantic_merge_tpu_torch.backends.ts_torch import TorchTSBackend
    repo = _checked_out(tmp_path, monkeypatch)
    before, status = tree_bytes(repo), git_status(repo)
    devices, merges, texts = [], [], []
    init, merge = TorchTSBackend.__init__, TorchTSBackend.merge

    def counting_init(self, *a, **kw):
        init(self, *a, **kw)
        devices.append(self.device.type)

    def counting_merge(self, *a, **kw):
        merges.append(self.device.type)
        return merge(self, *a, **kw)

    monkeypatch.setattr(TorchTSBackend, "__init__", counting_init)
    monkeypatch.setattr(TorchTSBackend, "merge", counting_merge)
    monkeypatch.setattr(cli, "_textual_rung", lambda args: texts.append(args) or 0)
    monkeypatch.setenv("SEMMERGE_FAULT", "kernel:fault")
    assert cli.main(["semmerge", "basebr", "brA", "brB", "--inplace",
                     "--device", "cpu"]) == errors.KernelFault.exit_code
    assert devices == ["cpu"] and merges == ["cpu"] and texts == []
    assert tree_bytes(repo) == before and git_status(repo) == status
    # The same run without the fault takes the one semantic attempt.
    monkeypatch.delenv("SEMMERGE_FAULT")
    assert cli.main(["semmerge", "basebr", "brA", "brB", "--inplace",
                     "--device", "cpu"]) == 0
    assert devices == ["cpu", "cpu"] and merges == ["cpu", "cpu"] and texts == []


def test_native_build_failure_never_degrades(tmp_path, monkeypatch):
    from semantic_merge_tpu_torch.frontend import declcache, native
    repo = _checked_out(tmp_path, monkeypatch)
    before = tree_bytes(repo)

    def no_compiler():
        raise errors.NativeBuildFault("native scanner: no C++ compiler (g++) on PATH",
                                      stage="scan", cause="no-compiler")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "build", no_compiler)
    declcache.global_cache().clear()  # every file must reach the scanner
    code = cli.main(["semmerge", "basebr", "brA", "brB", "--inplace", "--device", "cpu"])
    assert code == errors.ParseFault.exit_code
    assert tree_bytes(repo) == before


# --- the fault taxonomy and the injection spec against the JAX package ------------

def test_exit_codes_are_the_jax_packages():
    assert errors.EXIT_CODES == {name: jax_errors.EXIT_CODES[name]
                                 for name in errors.EXIT_CODES}
    assert set(errors.EXIT_CODES) == {"ParseFault", "KernelFault", "ApplyFault",
                                      "FormatFault", "DeadlineFault", "ResolveFault"}
    assert errors.UnsupportedSetting.exit_code == 70


@pytest.mark.parametrize("stage", sorted(errors.STAGE_FAULTS))
def test_stage_classes_are_the_jax_packages(stage):
    port, jax_cls = errors.fault_for_stage(stage), jax_errors.fault_for_stage(stage)
    assert port.__name__ == jax_cls.__name__
    assert port.exit_code == jax_cls.exit_code
    assert port.default_stage == jax_cls.default_stage


def test_fault_boundary_classifies_and_passes_through():
    with pytest.raises(errors.ApplyFault) as info:
        with errors.fault_boundary("apply"):
            raise OSError("disk")
    assert info.value.stage == "apply" and info.value.cause == "OSError"
    assert isinstance(info.value.__cause__, OSError)
    with pytest.raises(errors.ParseFault):
        with errors.fault_boundary("merge"):
            raise errors.ParseFault("scan", stage="scan")
    with pytest.raises(subprocess.CalledProcessError):
        with errors.fault_boundary("merge"):
            raise subprocess.CalledProcessError(128, ["git"])
    assert errors.is_device_fault(errors.KernelFault("x", stage="merge"))
    assert errors.is_device_fault(errors.NativeBuildFault("x", stage="scan"))
    assert not errors.is_device_fault(errors.ParseFault("x", stage="scan"))
    assert not errors.is_device_fault(errors.KernelFault("x", stage="resolve"))


SPECS = ("scan:raise", "apply:fault:2", "emit", "commit:kill", "kernel:hang=0.5",
         "resolver:propose:fault", "resolver:verify", "service:accept:fault",
         "apply:fault:x", "", ":fault", "net:read:raise:3")


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_parses_as_in_the_jax_package(spec):
    assert faults._parse(spec) == jax_faults._parse(spec)


def test_nth_hit_selector(monkeypatch):
    faults.reset()
    monkeypatch.setenv("SEMMERGE_FAULT", "apply:raise:2")
    assert faults.check("apply") is None
    with pytest.raises(RuntimeError):
        faults.check("apply")
    assert faults.check("apply") is None
    monkeypatch.setenv("SEMMERGE_FAULT", "resolver:propose:fault")
    with pytest.raises(errors.ResolveFault) as info:
        faults.check("resolver:propose")
    assert info.value.cause == "injected" and info.value.stage == "resolver:propose"
    assert faults.check("scan") is None
    faults.reset()
