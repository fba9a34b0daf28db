"""The port's scorer, training loop and ``train-matcher`` on a mesh.

In one gloo group of 2 CPU ranks (``torch_mesh_worker.py``) and in
``train-matcher`` processes started as 2 ranks with the ``SEMMERGE_*``
contract:

- after 30 sharded steps on ``sp = 2`` (the ring in training and in
  inference), ``make_scorer`` scores the true pairs above the pairs
  shifted by one, as ``tests/test_models_parallel.py`` checks JAX's, and
  every rank holds the same scores;
- ``train_matcher`` resumes across mesh sizes: a ``dp = 2`` run's
  checkpoint at step 3 resumed on one device to step 6, and a
  one-device checkpoint resumed on ``sp = 2``, each against the
  uninterrupted one-device run by the criteria of
  ``tests/test_torch_training.py`` (each element within 2e-3, each
  parameter's mean difference under 1e-4, over all elements a mean under
  2e-5 and at most 2% more than 1e-4 apart) and the last loss within
  2e-2; the checkpoints are the one-device format;
- ``train-matcher --device cpu ... --eval`` as 2 ranks: both exit 0,
  rank 0 prints the JAX CLI's two lines and rank 1 nothing, the
  checkpoint loads in a one-device ``EmbeddingSignatureMatcher``, and a
  one-process run resumes from it;
- ``semdiff --change-signature --signature-matcher --device cpu`` as 2
  ranks (each in its own clone; the matcher on the ``dp = 2`` engine
  mesh): rank 0 prints the one-process op log, byte for byte, with the
  matcher's ``changeSignature`` in it; rank 1 prints nothing.
"""
import json
import os
import re
import shutil
import socket
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

from semantic_merge_tpu_torch.models.encoder import Encoder, EncoderConfig
from semantic_merge_tpu_torch.models.matcher import MatcherConfig, save_matcher_checkpoint
from semantic_merge_tpu_torch.models.signature import EmbeddingSignatureMatcher
from semantic_merge_tpu_torch.models.training import (TrainConfig, batches, saved_steps,
                                                      train_matcher)

from test_signature_matcher import BASE, SIDE
from torch_mesh_worker import REPO, GlooGroup

WIDTH = dict(vocab=512, d_model=64, n_heads=4, d_head=16, n_layers=2, d_ff=128, n_experts=2)
SP2 = {"dp": 1, "pp": 1, "sp": 2, "tp": 1, "ep": 1}
DP2 = {"dp": 2, "pp": 1, "sp": 1, "tp": 1, "ep": 1}


@pytest.fixture(scope="module")
def world2():
    g = GlooGroup(2)
    yield g
    g.close()


def test_sharded_scorer_prefers_true_pairs(world2):
    state = Encoder(EncoderConfig(**WIDTH), generator=torch.Generator().manual_seed(1))
    params = {k: v.numpy() for k, v in state.state_dict().items()}
    batch = next(batches(TrainConfig(matcher=MatcherConfig(encoder=EncoderConfig(**WIDTH)),
                                     batch=8, seq=32, seed=5)))
    (true, cross), (true1, cross1) = world2.run("scores", SP2, WIDTH, params, batch, 30)
    np.testing.assert_allclose(true1, true, atol=1e-6)
    np.testing.assert_allclose(cross1, cross, atol=1e-6)
    assert true.shape == (8,) and np.isfinite(true).all()
    assert true.mean() > cross.mean()


def _close_to(state, want):
    diffs = []
    for name, value in want.items():
        diff = np.abs(np.asarray(state[name]) - np.asarray(value))
        assert diff.max() <= 2e-3, (name, diff.max())
        assert diff.mean() <= 1e-4, (name, diff.mean())
        diffs.append(diff.ravel())
    diffs = np.concatenate(diffs)
    assert diffs.mean() <= 2e-5 and (diffs > 1e-4).mean() <= 0.02


def _train(**kw):
    return dict(dict(batch=8, seq=32, steps=6, seed=0, ckpt_every=3), **kw)


def test_train_matcher_resumes_across_mesh_sizes(world2, tmp_path):
    cfg = MatcherConfig(encoder=EncoderConfig(**WIDTH))
    whole, _, loss, ran = train_matcher(TrainConfig(matcher=cfg, **_train()), "cpu")
    assert ran == 6
    want = {k: v.numpy() for k, v in whole.state_dict().items()}

    # dp = 2 to step 3, then one device to step 6.
    ck = str(tmp_path / "a")
    got = world2.run("train_matcher", DP2, WIDTH, _train(steps=3, ckpt_dir=ck))
    assert [r[1] for r in got] == [3, 3] and got[0][0] == got[1][0]
    assert [s for s, _ in saved_steps(ck)] == [3]
    enc, _, loss_a, ran = train_matcher(TrainConfig(matcher=cfg, **_train(ckpt_dir=ck)), "cpu")
    assert ran == 3 and abs(loss_a - loss) <= 2e-2
    _close_to({k: v.numpy() for k, v in enc.state_dict().items()}, want)
    assert [s for s, _ in saved_steps(ck)] == [3, 6]

    # One device to step 3, then sp = 2 to step 6.
    ck = str(tmp_path / "b")
    train_matcher(TrainConfig(matcher=cfg, **_train(steps=3, ckpt_dir=ck)), "cpu")
    got = world2.run("train_matcher", SP2, WIDTH, _train(ckpt_dir=ck))
    (loss_b, ran, state), (loss_b1, _, state1) = got
    assert ran == 3 and loss_b == loss_b1 and abs(loss_b - loss) <= 2e-2
    _close_to(state, want)
    assert all(np.array_equal(state[k], state1[k]) for k in state)
    assert [s for s, _ in saved_steps(ck)] == [3, 6]
    assert (tmp_path / "b" / "matcher.pt").is_file()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "XLA_FLAGS" and not k.startswith(("SEMMERGE_", "JAX_"))}
    env.update(PYTHONPATH=str(REPO), SEMMERGE_DAEMON="off", OMP_NUM_THREADS="2", **extra)
    return env


TRAIN = ["-m", "semantic_merge_tpu_torch", "train-matcher", "--device", "cpu", "--batch", "8",
         "--seq", "32"]


def test_cli_train_matcher_over_two_ranks(tmp_path):
    ck = tmp_path / "ck"
    contract = dict(SEMMERGE_COORDINATOR=f"127.0.0.1:{_free_port()}", SEMMERGE_NUM_PROCESSES="2")
    procs = [subprocess.Popen(
        [sys.executable, *TRAIN, "--steps", "4", "--ckpt-every", "2", "--ckpt-dir", str(ck),
         "--eval"], cwd=REPO, env=_env(**contract, SEMMERGE_PROCESS_ID=str(rank)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for rank in range(2)]
    outs = [proc.communicate(timeout=300) for proc in procs]
    for proc, (_out, err) in zip(procs, outs):
        assert proc.returncode == 0, err[-3000:]
    lines = outs[0][0].splitlines()
    assert outs[1][0] == ""
    assert len(lines) == 2
    assert re.fullmatch(rf"trained 4 steps, final loss \d+\.\d{{4}}, checkpoints in "
                        rf"{re.escape(str(ck))}", lines[0]), lines[0]
    ev = json.loads(lines[1])["matcher_eval"]
    assert ev["trained"] is True and ev["n"] == 48
    assert [s for s, _ in saved_steps(ck)] == [2, 4]

    matcher = EmbeddingSignatureMatcher(ckpt_dir=str(ck), device="cpu")
    z = matcher.embed_texts(["export function f(x: number): number { return x; }"])
    assert matcher.trained and z.shape == (1, 256) and np.isfinite(z).all()

    one = subprocess.run([sys.executable, *TRAIN, "--steps", "6", "--ckpt-dir", str(ck)],
                         cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    assert re.fullmatch(r"trained 2 steps, final loss \d+\.\d{4}, checkpoints in .*\n",
                        one.stdout), one.stdout


def test_two_rank_semdiff_pairs_as_one_process(tmp_path):
    origin = tmp_path / "origin"
    origin.mkdir()
    git = partial(subprocess.run, check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    git(["git", "init", "-q", "-b", "main"], cwd=origin)
    git(["git", "config", "user.email", "t@example.com"], cwd=origin)
    git(["git", "config", "user.name", "t"], cwd=origin)
    (origin / "a.ts").write_text(BASE)
    git(["git", "add", "-A"], cwd=origin)
    git(["git", "commit", "-qm", "base"], cwd=origin)
    (origin / "a.ts").write_text(SIDE)
    git(["git", "commit", "-qam", "side"], cwd=origin)
    ck = tmp_path / "ck"
    cfg = EncoderConfig(**WIDTH)
    save_matcher_checkpoint(ck, Encoder(cfg, generator=torch.Generator().manual_seed(0))
                            .state_dict(), cfg)
    argv = [sys.executable, "-m", "semantic_merge_tpu_torch", "semdiff", "HEAD~1", "HEAD",
            "--json-out", "--change-signature", "--signature-matcher", "--device", "cpu"]
    clones = {}
    for name in ("one", "rank0", "rank1"):
        clones[name] = tmp_path / name
        shutil.copytree(origin, clones[name])
        (clones[name] / ".semmerge.toml").write_text(
            f'[engine]\nmatcher_ckpt_dir = "{ck}"\nsignature_threshold = 0.5\n')
    contract = dict(SEMMERGE_COORDINATOR=f"127.0.0.1:{_free_port()}", SEMMERGE_NUM_PROCESSES="2")
    procs = {name: subprocess.Popen(argv, cwd=clones[name], env=_env(**env),
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, env in (("one", {}),
                               ("rank0", dict(contract, SEMMERGE_PROCESS_ID="0")),
                               ("rank1", dict(contract, SEMMERGE_PROCESS_ID="1")))}
    out = {name: proc.communicate(timeout=300) + (proc.returncode,)
           for name, proc in procs.items()}
    for name, (_stdout, stderr, code) in out.items():
        assert code == 0, (name, stderr[-3000:])
    ops = json.loads(out["one"][0])
    assert any(op["type"] == "changeSignature" for op in ops)
    assert out["rank0"][0] == out["one"][0]
    assert out["rank1"][0] == ""
    assert "process 0/2" in out["rank0"][1]
