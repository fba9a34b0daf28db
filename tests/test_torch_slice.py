"""The port's semantic diff end to end against the JAX package's.

- Backend level: ``TorchTSBackend(device="cpu").diff`` with the
  changeSignature matcher (its checkpoint converted from the JAX
  ``PRNGKey(0)`` parameters) must give the op log of the JAX
  ``TpuTSBackend(mesh=False).diff`` with its seeded matcher, on the
  snapshots of ``tests/test_signature_matcher.py``.
- CLI level: ``python -m semantic_merge_tpu_torch semdiff --json-out
  --change-signature --device cpu`` must print byte-for-byte what
  ``python -m semantic_merge_tpu semdiff --json-out --change-signature
  --backend tpu`` prints on the CPU, in a scratch git repository.
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

from semantic_merge_tpu.backends.ts_tpu import TpuTSBackend
from semantic_merge_tpu.frontend.snapshot import Snapshot as JaxSnapshot
from semantic_merge_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from semantic_merge_tpu.models.encoder import init_encoder
from semantic_merge_tpu.models.signature import (
    EmbeddingSignatureMatcher as JaxMatcher)
from semantic_merge_tpu_torch.backends.ts_torch import TorchTSBackend
from semantic_merge_tpu_torch.config import load_engine_config
from semantic_merge_tpu_torch.frontend.snapshot import Snapshot
from semantic_merge_tpu_torch.models.matcher import (params_from_jax,
                                                     save_matcher_checkpoint)
from semantic_merge_tpu_torch.models.signature import EmbeddingSignatureMatcher

from test_signature_matcher import BASE, SIDE

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    params = init_encoder(jax.random.PRNGKey(0), JaxEncoderConfig())
    ckpt = tmp_path_factory.mktemp("matcher")
    save_matcher_checkpoint(ckpt, params_from_jax({k: np.asarray(v) for k, v in params.items()}))
    return ckpt


def _both_diffs(base_text, side_text, ckpt, **kw):
    files = lambda text: [{"path": "a.ts", "content": text}]  # noqa: E731
    jax_ops = TpuTSBackend(mesh=False).diff(
        JaxSnapshot(files=files(base_text)), JaxSnapshot(files=files(side_text)), **kw,
        signature_matcher=JaxMatcher(threshold=0.85, allow_untrained=True, seed=0))
    matcher = EmbeddingSignatureMatcher(threshold=0.85, ckpt_dir=str(ckpt), device="cpu")
    port_ops = TorchTSBackend(device="cpu").diff(
        Snapshot(files=files(base_text)), Snapshot(files=files(side_text)), **kw,
        signature_matcher=matcher)
    # The matcher ran (from its checkpoint) exactly when refinement did.
    assert (matcher.encoder is not None) == bool(kw.get("change_signature"))
    return [o.to_dict() for o in jax_ops], [o.to_dict() for o in port_ops]


def test_matcher_pairing_matches_jax_backend(port_ckpt):
    want, got = _both_diffs(BASE, SIDE, port_ckpt, change_signature=True,
                            base_rev="r0", timestamp="2024-01-01T00:00:00Z")
    assert got == want
    assert [o["type"] for o in got].count("changeSignature") == 1


def test_matcher_discriminates_like_jax(port_ckpt):
    # Two renamed+retyped candidates in one file and an unrelated add:
    # the pairing (and its tie-breaking) must be the JAX package's.
    base = BASE + "export function scaleAll(xs: number[], k: number): number[] {\n  return xs;\n}\n"
    side = (SIDE + "export function scaleEvery(xs: string[], k: number): number[] {\n"
            "  return xs;\n}\n")
    want, got = _both_diffs(base, side, port_ckpt, change_signature=True)
    assert got == want


def test_without_change_signature_matches_jax_backend(port_ckpt):
    want, got = _both_diffs(BASE, SIDE, port_ckpt)
    assert got == want
    assert "changeSignature" not in [o["type"] for o in got]


def test_config_reads_engine_keys(tmp_path):
    (tmp_path / ".semmerge.toml").write_text(
        '[engine]\nchange_signature = true\nsignature_matcher = true\n'
        'signature_threshold = 0.5\nmatcher_ckpt_dir = "ck"\nbackend = "tpu"\n')
    (tmp_path / "sub").mkdir()
    cfg = load_engine_config(tmp_path / "sub")
    assert (cfg.change_signature, cfg.signature_matcher, cfg.signature_threshold,
            cfg.matcher_ckpt_dir) == (True, True, 0.5, "ck")


# --- CLI parity in a scratch git repository ---------------------------------

_BASE_FILES = {
    "src/util.ts": "export function foo(n: number): number {\n  return n;\n}\n"
                   "export function keep(s: string): string {\n  return s;\n}\n",
    "src/shapes.ts": "export class A {\n  x = 1;\n}\nexport class B {\n  y = 2;\n}\n"
                     "export interface I {\n  a: number;\n}\n",
    "src/gone.ts": "export function removed(a: boolean): void {}\nconst z = 1, w = 2;\n",
    "src/sig.ts": "export function retyped(a: number, b: boolean): number {\n  return a;\n}\n",
}

_SIDE_FILES = {
    "src/util.ts": "export function bar(n: number): number {\n  return n;\n}\n"
                   "export function keep(s: string): string {\n  return s;\n}\n",
    "lib/shapes.ts": _BASE_FILES["src/shapes.ts"] + "export enum E { P, Q }\n",
    "src/sig.ts": "export function retyped(a: string, b: boolean): number {\n  return 1;\n}\n",
    "src/new.ts": "export function fresh(x: string[]): string {\n  return x[0];\n}\n"
                  "let counter = 0;\n",
}


def _git(args, cwd, env=None):
    subprocess.run(["git", *args], cwd=cwd, check=True, env=env,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def _write_tree(root, files):
    for top in ("src", "lib"):
        shutil.rmtree(root / top, ignore_errors=True)
    for path, text in files.items():
        (root / path).parent.mkdir(parents=True, exist_ok=True)
        (root / path).write_text(text)


@pytest.fixture
def scratch_repo(tmp_path):
    root = tmp_path / "repo"
    root.mkdir()
    env = dict(os.environ, GIT_AUTHOR_DATE="2024-01-01T00:00:00Z",
               GIT_COMMITTER_DATE="2024-01-02T03:04:05Z")
    _git(["init", "-q", "-b", "main"], root)
    _git(["config", "user.email", "t@example.com"], root)
    _git(["config", "user.name", "t"], root)
    _write_tree(root, _BASE_FILES)
    _git(["add", "-A"], root)
    _git(["commit", "-q", "-m", "base"], root, env)
    _git(["branch", "basebr"], root)
    _write_tree(root, _SIDE_FILES)
    _git(["add", "-A"], root)
    _git(["commit", "-q", "-m", "side"], root, env)
    return root


def _cli(module, args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, "semdiff", *args],
                          cwd=cwd, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=300)


@pytest.mark.parametrize("flags", [["--json-out", "--change-signature"], ["--json-out"]])
def test_cli_stdout_matches_jax_cli(scratch_repo, flags):
    want = _cli("semantic_merge_tpu", ["basebr", "main", *flags, "--backend", "tpu"],
                scratch_repo)
    got = _cli("semantic_merge_tpu_torch", ["basebr", "main", *flags, "--device", "cpu"],
               scratch_repo)
    assert want.returncode == 0, want.stderr
    assert got.returncode == 0, got.stderr
    assert got.stdout == want.stdout
    types = {op["type"] for op in json.loads(got.stdout)}
    assert {"renameSymbol", "moveDecl", "addDecl", "deleteDecl"} <= types
    assert ("changeSignature" in types) == ("--change-signature" in flags)


def test_matcher_refuses_untrained_weights_and_oversized_batches():
    dels = [(("FunctionDeclaration", "a.ts"), "function f(a: number) {}")]
    adds = [(("FunctionDeclaration", "a.ts"), "function g(a: string) {}")]
    untrained = EmbeddingSignatureMatcher(device="cpu")
    assert untrained.pair(dels, adds) == []
    assert not untrained.trained
    capped = EmbeddingSignatureMatcher(device="cpu", allow_untrained=True,
                                       max_candidates=1, threshold=-1.0)
    assert capped.pair(dels * 2, adds) == []
    assert capped.encoder is None  # refused before building the encoder
    assert capped.pair(dels, adds) == [(0, 0)]
