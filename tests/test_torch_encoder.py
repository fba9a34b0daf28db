"""The port's encoder and embeddings against the JAX package's.

JAX ``init_encoder(PRNGKey(0), cfg)`` weights come over through
``params_from_jax``; the same seeded tokens and masks go through JAX
``embed`` (on the CPU mesh, einsum attention) and the port's ``embed``
(on the CPU, the plain attention). Tolerance: atol 2e-2 on the unit
embeddings, since both run bf16 matmuls that round at other points.
"""
import numpy as np
import pytest
import torch

import jax

from semantic_merge_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from semantic_merge_tpu.models.encoder import init_encoder
from semantic_merge_tpu.models.matcher import embed as jax_embed
from semantic_merge_tpu.parallel.mesh import build_mesh
from semantic_merge_tpu_torch.models.encoder import Encoder, EncoderConfig
from semantic_merge_tpu_torch.models.matcher import (embed, load_matcher_checkpoint,
                                                     params_from_jax,
                                                     save_matcher_checkpoint)

TINY = dict(vocab=256, d_model=32, n_heads=4, d_head=8, n_layers=2, d_ff=64,
            n_experts=2)


def _jax_params(cfg):
    return {k: np.asarray(v) for k, v in init_encoder(jax.random.PRNGKey(0), cfg).items()}


def _batch(b, l, vocab, seed):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, vocab, (b, l)).astype(np.int32)
    mask = rs.rand(b, l) > 0.3
    mask[:, 0] = True
    mask[-1] = False  # a padding row of the kind encode_batch's bucket adds
    return tokens, mask


def _compare(width, b, l, seed):
    jcfg = JaxEncoderConfig(**width)
    params = _jax_params(jcfg)
    tokens, mask = _batch(b, l, jcfg.vocab, seed)
    mesh = build_mesh()
    want = np.asarray(jax.jit(lambda p, t, m: jax_embed(p, t, m, jcfg, mesh))(
        params, tokens, mask))
    enc = Encoder(EncoderConfig(**width))
    enc.load_state_dict(params_from_jax(params))
    with torch.inference_mode():
        got = embed(enc, torch.from_numpy(tokens).long(), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-2)


@pytest.mark.parametrize("seed", [0, 1])
def test_tiny_encoder_matches_jax_embed(seed):
    _compare(TINY, 4, 16, seed)


def test_default_width_matches_jax_embed():
    _compare({}, 8, 64, 2)


def test_checkpoint_round_trip(tmp_path):
    state = params_from_jax(_jax_params(JaxEncoderConfig(**TINY)))
    save_matcher_checkpoint(tmp_path, state)
    cfg, loaded = load_matcher_checkpoint(tmp_path)
    assert cfg == EncoderConfig(**TINY)
    assert loaded.keys() == state.keys()
    assert all(torch.equal(loaded[k], state[k]) for k in state)
    assert load_matcher_checkpoint(tmp_path / "absent") is None


def test_seeded_init_is_deterministic():
    a = Encoder(EncoderConfig(**TINY), generator=torch.Generator().manual_seed(3))
    b = Encoder(EncoderConfig(**TINY), generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                  b.state_dict().values()))
    with pytest.raises(ValueError):
        EncoderConfig(moe_mode="topk")
