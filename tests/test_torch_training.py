"""The port's matcher training against the JAX package's.

- ``synth_pair`` and ``batches`` give the JAX package's strings and
  token arrays exactly, for several seeds (equality).
- ``info_nce`` on seeded f32 embeddings: atol 1e-6 (one f32 matmul and
  two log-softmaxes, summed in another order).
- Three ``train_step``s at the JAX tests' tiny width, from the JAX
  ``init_matcher`` weights on the same batches: the losses within atol
  2e-2 (bf16 matmuls rounding at other points, as in the encoder test);
  every parameter within atol 2e-3 of the JAX ``train_step``'s on
  ``build_mesh()`` (the einsum path), since AdamW moves an element by
  about lr = 3e-4 a step whatever its gradient's size and a near-zero
  gradient may take either sign in bf16 (three steps: at most 1.8e-3);
  each one's mean absolute difference under lr / 3 = 1e-4 (a wrong
  learning rate or bias correction moves every element by about lr),
  over all elements a mean under 2e-5 and at most 2% more than 1e-4
  apart.
- Resume from a checkpoint equals the uninterrupted run (the CPU is
  deterministic: atol 1e-6), and ``resume=False`` restarts.
- A briefly trained tiny matcher beats the untrained one on
  ``evaluate_matcher``; the port's ``evaluate_matcher`` gives the JAX
  one's dict for the same pairing.
- ``train-matcher --device cpu`` prints the JAX CLI's lines; its
  ``--ckpt-dir`` serves ``[engine] matcher_ckpt_dir`` for a ``semdiff
  --change-signature --signature-matcher`` without the refusal warning.
"""
import json
import logging
import os
import pathlib
import re
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semantic_merge_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from semantic_merge_tpu.models.evaluate import evaluate_matcher as jax_evaluate
from semantic_merge_tpu.models.matcher import MatcherConfig as JaxMatcherConfig
from semantic_merge_tpu.models.matcher import info_nce as jax_info_nce
from semantic_merge_tpu.models.matcher import init_matcher
from semantic_merge_tpu.models.matcher import train_step as jax_train_step
from semantic_merge_tpu.models.training import TrainConfig as JaxTrainConfig
from semantic_merge_tpu.models.training import batches as jax_batches
from semantic_merge_tpu.models.training import synth_pair as jax_synth_pair
from semantic_merge_tpu.parallel.mesh import build_mesh
from semantic_merge_tpu_torch import cli
from semantic_merge_tpu_torch.models.encoder import Encoder, EncoderConfig
from semantic_merge_tpu_torch.models.evaluate import evaluate_matcher
from semantic_merge_tpu_torch.models.matcher import (MatcherConfig, info_nce, optimizer,
                                                     params_from_jax, train_step)
from semantic_merge_tpu_torch.models.signature import EmbeddingSignatureMatcher
from semantic_merge_tpu_torch.models.training import (TrainConfig, batches, saved_steps,
                                                      synth_pair, train_matcher)

from test_signature_matcher import BASE, SIDE

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(vocab=256, d_model=32, n_heads=2, d_head=16, n_layers=1, d_ff=64, n_experts=2)


def _tiny(**kw):
    return MatcherConfig(encoder=EncoderConfig(**TINY, **kw))


def _train_cfg(**kw):
    base = dict(matcher=_tiny(), batch=8, seq=32, steps=6, seed=0, ckpt_every=3)
    base.update(kw)
    return TrainConfig(**base)


def _on_cpu(batch):
    return {k: torch.from_numpy(v).long() if k.startswith("tokens") else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("seed", [0, 1, 7, 991])
def test_synth_pair_matches_jax(seed):
    ours, theirs = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(20):
        assert synth_pair(ours) == jax_synth_pair(theirs)
    assert ours.randint(1 << 30) == theirs.randint(1 << 30)  # same draws consumed


@pytest.mark.parametrize("seed,batch,seq", [(0, 8, 32), (3, 32, 64), (11, 5, 17)])
def test_batches_match_jax(seed, batch, seq):
    ours = batches(TrainConfig(batch=batch, seq=seq, seed=seed))
    theirs = jax_batches(JaxTrainConfig(batch=batch, seq=seq, seed=seed))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
            assert np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("seed,n,temperature", [(0, 8, 0.07), (1, 32, 0.07), (2, 5, 0.5)])
def test_info_nce_matches_jax(seed, n, temperature):
    rs = np.random.RandomState(seed)
    za, zb = (rs.randn(n, 16).astype(np.float32) for _ in range(2))
    za /= np.linalg.norm(za, axis=1, keepdims=True)
    zb /= np.linalg.norm(zb, axis=1, keepdims=True)
    want = float(jax_info_nce(jnp.asarray(za), jnp.asarray(zb), temperature))
    got = info_nce(torch.from_numpy(za), torch.from_numpy(zb), temperature)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-6


def test_three_train_steps_match_jax():
    jcfg = JaxMatcherConfig(encoder=JaxEncoderConfig(**TINY))
    cfg = _tiny()
    params, opt_state = init_matcher(jax.random.PRNGKey(0), jcfg)
    encoder = Encoder(cfg.encoder)
    encoder.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in params.items()}))
    opt = optimizer(encoder, cfg)
    step = jax.jit(partial(jax_train_step, cfg=jcfg, mesh=build_mesh()))
    data = jax_batches(JaxTrainConfig(matcher=jcfg, batch=8, seq=32, seed=5))
    for i in range(3):
        batch = next(data)
        params, opt_state, want = step(params, opt_state,
                                       {k: jnp.asarray(v) for k, v in batch.items()})
        got = train_step(encoder, opt, _on_cpu(batch), cfg)
        assert np.isfinite(float(got))
        assert abs(float(got) - float(want)) <= 2e-2, (i, float(got), float(want))
    state = encoder.state_dict()
    diffs = []
    for name, value in params.items():
        diff = np.abs(state[name].numpy() - np.asarray(value))
        assert diff.max() <= 2e-3, (name, diff.max())
        assert diff.mean() <= 1e-4, (name, diff.mean())
        diffs.append(diff.ravel())
    diffs = np.concatenate(diffs)
    assert diffs.mean() <= 2e-5 and (diffs > 1e-4).mean() <= 0.02


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    enc_full, _, loss_full, ran = train_matcher(_train_cfg(), "cpu")
    assert ran == 6 and np.isfinite(loss_full)

    ck = str(tmp_path / "ck")
    train_matcher(_train_cfg(steps=3, ckpt_dir=ck), "cpu")
    assert [s for s, _ in saved_steps(ck)] == [3]
    enc_res, opt_res, loss_res, ran = train_matcher(_train_cfg(steps=6, ckpt_dir=ck), "cpu")
    assert ran == 3  # resumed at 3, ran to 6
    assert [s for s, _ in saved_steps(ck)] == [3, 6]
    for (name, a), b in zip(enc_full.state_dict().items(), enc_res.state_dict().values()):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0, msg=name)
    assert abs(loss_full - loss_res) <= 1e-6
    assert all(s["step"] == 6 for s in opt_res.state_dict()["state"].values())

    # Resumed at the last step: nothing to do.
    _, _, loss, ran = train_matcher(_train_cfg(steps=6, ckpt_dir=ck), "cpu")
    assert ran == 0 and loss is None


def test_resume_disabled_restarts_and_keeps_the_newest(tmp_path):
    ck = str(tmp_path / "ck")
    train_matcher(_train_cfg(steps=3, ckpt_dir=ck), "cpu")
    _, _, _, ran = train_matcher(_train_cfg(steps=8, ckpt_every=2, keep=2, ckpt_dir=ck),
                                 "cpu", resume=False)
    assert ran == 8  # started from scratch
    assert [s for s, _ in saved_steps(ck)] == [6, 8]
    assert (tmp_path / "ck" / "matcher.pt").is_file()


def test_topk_training_runs():
    cfg = _train_cfg(matcher=_tiny(moe_mode="topk", moe_top_k=1), steps=4)
    _, _, loss, ran = train_matcher(cfg, "cpu")
    assert ran == 4 and np.isfinite(loss)


class _StubMatcher:
    """A pairing fixed in advance, for the metric arithmetic alone."""

    threshold = 0.85
    trained = True

    def __init__(self, pairs):
        self.pairs = pairs

    def pair(self, deletes, adds):
        assert len(deletes) == len(adds) == 24
        return self.pairs


@pytest.mark.parametrize("pairs", [[], [(0, 0), (1, 5), (2, 9)], [(i, i) for i in range(24)]])
def test_evaluate_matcher_matches_jax(pairs):
    assert evaluate_matcher(_StubMatcher(pairs), n=24, seed=77) == \
        jax_evaluate(_StubMatcher(pairs), n=24, seed=77)


def test_trained_matcher_beats_untrained_on_held_out(tmp_path):
    tiny = _tiny()
    ck = str(tmp_path / "ck")
    train_matcher(TrainConfig(matcher=tiny, batch=16, seq=48, steps=60, seed=3,
                              ckpt_dir=ck, ckpt_every=60), "cpu")
    untrained = EmbeddingSignatureMatcher(threshold=0.85, seq_len=48, allow_untrained=True,
                                          cfg=tiny, device="cpu")
    trained = EmbeddingSignatureMatcher(threshold=0.85, seq_len=48, ckpt_dir=ck, cfg=tiny,
                                        device="cpu")
    ev_u = evaluate_matcher(untrained, n=24, seed=77)
    ev_t = evaluate_matcher(trained, n=24, seed=77)
    assert ev_t["trained"] and not ev_u["trained"]
    assert ev_t["correct"] >= ev_u["correct"]
    assert ev_t["recall"] > 0.0


# --- the CLI ----------------------------------------------------------------

@pytest.fixture(scope="module")
def trained_dir(tmp_path_factory):
    """``train-matcher --device cpu --steps 6 --ckpt-dir D --eval`` at the
    default width: (D, stdout lines)."""
    ckpt = tmp_path_factory.mktemp("trained") / "ck"
    proc = subprocess.run(
        [sys.executable, "-m", "semantic_merge_tpu_torch", "train-matcher", "--device", "cpu",
         "--steps", "6", "--ckpt-every", "3", "--ckpt-dir", str(ckpt), "--eval"],
        cwd=REPO_ROOT, env=dict(os.environ, PYTHONPATH=str(REPO_ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return ckpt, proc.stdout.splitlines()


def test_cli_train_matcher_prints_the_jax_lines(trained_dir):
    ckpt, lines = trained_dir
    assert len(lines) == 2
    assert re.fullmatch(rf"trained 6 steps, final loss \d+\.\d{{4}}, checkpoints in "
                        rf"{re.escape(str(ckpt))}", lines[0]), lines[0]
    ev = json.loads(lines[1])["matcher_eval"]
    assert ev.keys() == jax_evaluate(_StubMatcher([]), n=24, seed=77).keys()
    assert ev["trained"] is True and ev["n"] == 48
    assert [s for s, _ in saved_steps(ckpt)] == [3, 6]


def test_cli_nothing_to_do_line_equals_the_jax_cli(trained_dir, tmp_path):
    ckpt, _ = trained_dir
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), JAX_PLATFORMS="cpu")
    jax_dir = tmp_path / "jax"
    want = subprocess.run(
        [sys.executable, "-m", "semantic_merge_tpu", "train-matcher", "--steps", "0",
         "--ckpt-dir", str(jax_dir)], cwd=REPO_ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=300)
    assert want.returncode == 0, want.stderr
    got = subprocess.run(
        [sys.executable, "-m", "semantic_merge_tpu_torch", "train-matcher", "--device", "cpu",
         "--steps", "0", "--ckpt-dir", str(jax_dir)], cwd=REPO_ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=300)
    assert got.returncode == 0, got.stderr
    assert got.stdout == want.stdout == f"nothing to do: checkpoint already at step 0, " \
                                        f"checkpoints in {jax_dir}\n"


def test_signature_matcher_scores_with_the_trained_checkpoint(trained_dir, tmp_path, caplog):
    ckpt, _ = trained_dir
    repo = tmp_path / "repo"
    repo.mkdir()
    git = partial(subprocess.run, cwd=repo, check=True, stdout=subprocess.DEVNULL,
                  stderr=subprocess.DEVNULL)
    git(["git", "init", "-q", "-b", "main"])
    git(["git", "config", "user.email", "t@example.com"])
    git(["git", "config", "user.name", "t"])
    (repo / "a.ts").write_text(BASE)
    git(["git", "add", "-A"])
    git(["git", "commit", "-qm", "base"])
    (repo / "a.ts").write_text(SIDE)
    git(["git", "commit", "-qam", "side"])
    (repo / ".semmerge.toml").write_text(f'[engine]\nmatcher_ckpt_dir = "{ckpt}"\n')
    args = cli.build_parser().parse_args(
        ["semdiff", "HEAD~1", "HEAD", "--json-out", "--change-signature",
         "--signature-matcher", "--device", "cpu"])
    cwd = os.getcwd()
    os.chdir(repo)
    try:
        with caplog.at_level(logging.WARNING):
            result = cli.semdiff(args)
    finally:
        os.chdir(cwd)
    assert result.matcher is not None and result.matcher.trained
    assert result.matcher.encoder is not None  # it scored
    assert not any("refusing" in r.getMessage() for r in caplog.records)
