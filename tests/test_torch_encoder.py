"""The port's encoder and embeddings against the JAX package's.

JAX ``init_encoder(PRNGKey(0), cfg)`` weights come over through
``params_from_jax``; the same seeded tokens and masks go through JAX
``embed`` (on the CPU mesh, einsum attention) and the port's ``embed``
(on the CPU, the plain attention). Tolerance: atol 2e-2 on the unit
embeddings, since both run bf16 matmuls that round at other points.

The routed top-k mixture (``moe_mode="topk"``) is held the same way, on
the whole encoder and on ``_routed_moe`` alone (atol 2e-2 on its bf16
output). Routing is an argmax, so the encoder cases route in a way that
rounding cannot flip: every expert picked (top_k = n_experts), or a zero
gate, whose uniform softmax makes every pick a tie that the first-max
rule settles, with a capacity small enough that tokens drop.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semantic_merge_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from semantic_merge_tpu.models.encoder import _routed_moe as jax_routed_moe
from semantic_merge_tpu.models.encoder import init_encoder
from semantic_merge_tpu.models.matcher import embed as jax_embed
from semantic_merge_tpu.parallel.mesh import build_mesh
from semantic_merge_tpu_torch.models.encoder import Encoder, EncoderConfig, _routed_moe
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


def _compare(width, b, l, seed, zero_gate=False):
    jcfg = JaxEncoderConfig(**width)
    params = _jax_params(jcfg)
    if zero_gate:
        params["gate"] = np.zeros_like(params["gate"])
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


@pytest.mark.parametrize("extra,zero_gate", [
    (dict(moe_mode="topk"), False),  # top_k = n_experts = 2: every expert picked
    (dict(moe_mode="topk", moe_top_k=1, moe_capacity_factor=0.5), True),  # C = N / 4
    (dict(moe_mode="topk", n_experts=4, moe_capacity_factor=1.0), True),  # C = N / 2
])
def test_topk_encoder_matches_jax_embed(extra, zero_gate):
    _compare({**TINY, **extra}, 4, 16, 3, zero_gate=zero_gate)


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("top_k,cf,e,seed", [(2, 1.25, 4, 0), (1, 0.5, 4, 1), (2, 0.3, 3, 2),
                                             (3, 2.0, 4, 3)])
def test_routed_moe_matches_jax(top_k, cf, e, seed):
    b, l, d, f = 3, 10, 16, 24
    rs = np.random.RandomState(seed)
    h = _bf16(rs.randn(b, l, d).astype(np.float32))
    logits = (rs.randn(b, l, e) * 2).astype(np.float32)
    logits[0, :4] = 0.5  # exact ties: the first maximal expert wins
    w1 = _bf16((rs.randn(e, d, f) / 4).astype(np.float32))
    w2 = _bf16((rs.randn(e, f, d) / 5).astype(np.float32))
    mask = rs.rand(b, l) > 0.2
    mask[-1, -3:] = False
    jcfg = JaxEncoderConfig(n_experts=e, moe_mode="topk", moe_top_k=top_k,
                            moe_capacity_factor=cf)
    want = np.asarray(jax_routed_moe(
        jnp.asarray(h, jnp.bfloat16), jnp.asarray(logits), jnp.asarray(w1, jnp.bfloat16),
        jnp.asarray(w2, jnp.bfloat16), jcfg, jnp.asarray(mask)).astype(jnp.float32))
    cfg = EncoderConfig(n_experts=e, moe_mode="topk", moe_top_k=top_k, moe_capacity_factor=cf)
    got = _routed_moe(torch.from_numpy(h).bfloat16(), torch.from_numpy(logits),
                      torch.from_numpy(w1).bfloat16(), torch.from_numpy(w2).bfloat16(), cfg,
                      torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16 and got.shape == (b, l, d)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2)
    assert not got[~mask].any()  # padding tokens take no slot and get nothing
    if cf < 1:  # over capacity: some real tokens dropped every pick
        assert (~got[mask].any(axis=-1)).sum() > 0


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


def test_checkpoint_keeps_the_routing_fields(tmp_path):
    cfg = EncoderConfig(**TINY, moe_mode="topk", moe_top_k=1, moe_capacity_factor=2.0)
    enc = Encoder(cfg, generator=torch.Generator().manual_seed(1))
    save_matcher_checkpoint(tmp_path, enc.state_dict(), cfg)
    assert load_matcher_checkpoint(tmp_path)[0] == cfg


def test_checkpoint_of_the_earlier_format_loads_with_default_routing(tmp_path):
    # Files written before the routing fields existed hold only the shapes.
    state = params_from_jax(_jax_params(JaxEncoderConfig(**TINY)))
    shape_fields = {k: v for k, v in TINY.items()}
    shape_fields.update(moe_mode="soft")
    torch.save({"encoder_config": shape_fields, "params": state}, tmp_path / "matcher.pt")
    cfg, loaded = load_matcher_checkpoint(tmp_path)
    assert cfg == EncoderConfig(**TINY)
    assert all(torch.equal(loaded[k], state[k]) for k in state)
    # A field that disagrees with the shapes is refused.
    torch.save({"encoder_config": dict(shape_fields, d_model=64), "params": state},
               tmp_path / "matcher.pt")
    with pytest.raises(ValueError):
        load_matcher_checkpoint(tmp_path)


@pytest.mark.parametrize("bad", [dict(moe_mode="hard"), dict(moe_top_k=0),
                                 dict(moe_top_k=3, n_experts=2)])
def test_config_refuses_bad_routing(bad):
    with pytest.raises(ValueError):
        EncoderConfig(**bad)
