"""The port's sharded training step against the JAX package's.

``make_sharded_train_step`` on the three meshes of
``tests/test_models_parallel.py`` (``dp2 sp2 tp2``, ``dp2 pp2 ep2``,
``dp8``) at its width, in one gloo group of 8 CPU ranks
(``torch_mesh_worker.py``), from JAX ``init_matcher`` weights
(``params_from_jax``, ``shard_state``) over the same three batches of
the JAX data stream:

- the three losses within 2e-2 of the JAX ``make_sharded_train_step``'s
  on the same mesh (the 8-device CPU mesh of ``conftest.py``), and every
  rank's loss the same (the global batch's);
- the gathered parameters (``gather_state``) against JAX's by the
  criteria of ``tests/test_torch_training.py`` (each element within
  2e-3, each parameter's mean difference under 1e-4, over all elements
  a mean under 2e-5 and at most 2% more than 1e-4 apart), and against
  the port's one-device ``train_step`` by the same criteria.

The scorer, training on a mesh with its checkpoints and ``train-matcher``
over two ranks are ``tests/test_torch_model_parallel_cli.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semantic_merge_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from semantic_merge_tpu.models.matcher import MatcherConfig as JaxMatcherConfig
from semantic_merge_tpu.models.matcher import init_matcher, make_sharded_train_step
from semantic_merge_tpu.models.training import TrainConfig as JaxTrainConfig
from semantic_merge_tpu.models.training import batches as jax_batches
from semantic_merge_tpu.parallel.mesh import build_mesh as jax_build_mesh
from semantic_merge_tpu_torch.models.encoder import Encoder, EncoderConfig
from semantic_merge_tpu_torch.models.matcher import (MatcherConfig, optimizer, params_from_jax,
                                                     train_step)

from torch_mesh_worker import GlooGroup

WIDTH = dict(vocab=512, d_model=64, n_heads=4, d_head=16, n_layers=2, d_ff=128, n_experts=2)
MESHES = [{"dp": 2, "pp": 1, "sp": 2, "tp": 2, "ep": 1},
          {"dp": 2, "pp": 2, "sp": 1, "tp": 1, "ep": 2},
          {"dp": 8, "pp": 1, "sp": 1, "tp": 1, "ep": 1}]


@pytest.fixture(scope="module")
def world8():
    g = GlooGroup(8)
    yield g
    g.close()


@pytest.fixture(scope="module")
def start():
    """JAX's initial weights and three batches of its data stream."""
    jcfg = JaxMatcherConfig(encoder=JaxEncoderConfig(**WIDTH))
    params, _ = init_matcher(jax.random.PRNGKey(0), jcfg)
    data = jax_batches(JaxTrainConfig(matcher=jcfg, batch=8, seq=32, seed=5))
    return {k: np.asarray(v) for k, v in params.items()}, [next(data) for _ in range(3)]


def _close_to(state, want, what):
    diffs = []
    for name, value in want.items():
        diff = np.abs(np.asarray(state[name]) - np.asarray(value))
        assert diff.max() <= 2e-3, (what, name, diff.max())
        assert diff.mean() <= 1e-4, (what, name, diff.mean())
        diffs.append(diff.ravel())
    diffs = np.concatenate(diffs)
    assert diffs.mean() <= 2e-5 and (diffs > 1e-4).mean() <= 0.02, what


@pytest.fixture(scope="module")
def one_device(start):
    """The port's one-device train_step over the same batches."""
    params, batches = start
    cfg = MatcherConfig(encoder=EncoderConfig(**WIDTH))
    encoder = Encoder(cfg.encoder)
    encoder.load_state_dict(params_from_jax(params))
    opt = optimizer(encoder, cfg)
    losses = []
    for batch in batches:
        on_cpu = {k: torch.from_numpy(v).long() if k.startswith("tokens") else
                  torch.from_numpy(v) for k, v in batch.items()}
        losses.append(float(train_step(encoder, opt, on_cpu, cfg)))
    return losses, {k: v.numpy() for k, v in encoder.state_dict().items()}


@pytest.mark.parametrize("sizes", MESHES, ids=["dp2sp2tp2", "dp2pp2ep2", "dp8"])
def test_sharded_train_step_matches_jax(world8, start, one_device, sizes):
    params, batches = start
    jcfg = JaxMatcherConfig(encoder=JaxEncoderConfig(**WIDTH))
    jparams, opt_state = init_matcher(jax.random.PRNGKey(0), jcfg)
    step = make_sharded_train_step(jcfg, jax_build_mesh(**sizes))
    want = []
    for batch in batches:
        jparams, opt_state, loss = step(jparams, opt_state,
                                        {k: jnp.asarray(v) for k, v in batch.items()})
        want.append(float(loss))
    results = world8.run("train", sizes, WIDTH, params, batches)
    losses, state = results[0]
    for other_losses, _ in results[1:]:
        assert other_losses == losses  # every rank holds the global loss
    assert np.isfinite(losses).all()
    for i, (got, ref, one) in enumerate(zip(losses, want, one_device[0])):
        assert abs(got - ref) <= 2e-2, (i, got, ref)
        assert abs(got - one) <= 2e-2, (i, got, one)
    _close_to(state, {k: np.asarray(v) for k, v in jparams.items()}, "jax")
    _close_to(state, one_device[1], "one device")

