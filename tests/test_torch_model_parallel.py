"""The port's attention and encoder over several devices against the JAX package's.

The JAX side runs ``parallel/ring.py``, ``parallel/ulysses.py`` and the
encoder's embedding on the virtual 8-device CPU mesh of ``conftest.py``
(and on its first two devices for the ``sp = 2`` cases). The port's side
runs in one gloo group per world size (8 and 2 CPU ranks,
``torch_mesh_worker.py``), started once for the module; each rank takes
its block of the same numpy-seeded inputs (rows over ``dp``, positions
over ``sp``, heads over ``tp``), and the test lays the blocks back out.

- ``ring_attention`` on ``dp2 sp2 tp2`` (world 8) and ``sp2`` (world 2)
  against JAX's ``ring_attention`` with ``pallas=None`` (the einsum path)
  and ``"interpret"`` (the Pallas kernel): rtol/atol 2e-4, as
  ``tests/test_models_parallel.py``; one row whose second half is
  padding (on ``sp = 2`` a whole chunk of padding) and one row with
  every key masked.
- The ring's dq, dk, dv against ``jax.grad`` of the einsum ring (the
  reference: ``jax.grad`` through the Pallas kernel fails): rtol/atol
  2e-4.
- Ulysses' output and gradients the same way, and its ``ValueError``
  (the JAX text) for heads that do not divide.
- The routed top-k MoE alone on ``dp2 sp2 tp2`` and ``dp2 pp2 ep2``:
  random gate logits given in f32 (so no rounding comes before the
  picks) and a capacity the picks overflow, so each token's slot
  depends on the routing probabilities gathered over ``dp`` and ``sp``
  in the global token order. Its output and its gradients in h, the
  gate logits, w1 and w2 against JAX ``_routed_moe`` (``jax.vjp``) and
  the port's one-device function: atol 2e-2 (of each gradient's
  largest magnitude), as ``tests/test_torch_encoder.py``.
- The encoder's embeddings in ring and Ulysses mode, soft and top-k, on
  ``dp2 sp2 tp2`` and ``dp2 pp2 ep2``, from JAX ``init_encoder`` weights
  (``params_from_jax``, ``shard_state``): atol 2e-2 against JAX
  ``embed`` on the same mesh (bf16 matmuls round at other points, as in
  ``tests/test_torch_encoder.py``) and against the port's one-device
  embedding. The top-k cases route as there, so that rounding cannot
  flip a pick: a zero gate (every pick a tie the first-max rule
  settles) and a capacity that drops tokens, whose slots then follow the
  global token order across ``dp`` and ``sp``.
- The signature matcher on a ``dp = 2`` engine mesh pairs as on one
  device.
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
from semantic_merge_tpu.parallel.mesh import build_mesh as jax_build_mesh
from semantic_merge_tpu.parallel.ring import ring_attention as jax_ring
from semantic_merge_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from semantic_merge_tpu_torch.models.encoder import Encoder, EncoderConfig, _routed_moe
from semantic_merge_tpu_torch.models.matcher import MatcherConfig, embed, params_from_jax
from semantic_merge_tpu_torch.models.signature import EmbeddingSignatureMatcher

from torch_mesh_worker import GlooGroup

MESH_A = {"dp": 2, "pp": 1, "sp": 2, "tp": 2, "ep": 1}
MESH_B = {"dp": 2, "pp": 2, "sp": 1, "tp": 1, "ep": 2}
SP2 = {"dp": 1, "pp": 1, "sp": 2, "tp": 1, "ep": 1}
WIDTH = dict(vocab=128, d_model=32, n_heads=4, d_head=8, n_layers=2, d_ff=64, n_experts=4)
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def world8():
    g = GlooGroup(8)
    yield g
    g.close()


@pytest.fixture(scope="module")
def world2():
    g = GlooGroup(2)
    yield g
    g.close()


def _group(request, sizes):
    return request.getfixturevalue("world8" if np.prod(list(sizes.values())) == 8 else "world2")


def _jax_mesh(sizes):
    n = int(np.prod(list(sizes.values())))
    return jax_build_mesh(jax.devices()[:n], **sizes)


def _assemble(results, sizes, shape):
    """The global array from every rank's (coords, block), blocks over
    dp rows, sp positions and tp heads; ranks that hold the same block
    (replicas over pp and ep) must agree."""
    out = np.full(shape, np.nan, np.float32)
    seen = {}
    for coords, block in results:
        b, l, h = block.shape[:3]
        at = (slice(coords["dp"] * b, (coords["dp"] + 1) * b),
              slice(coords["sp"] * l, (coords["sp"] + 1) * l),
              slice(coords["tp"] * h, (coords["tp"] + 1) * h))
        key = (coords["dp"], coords["sp"], coords["tp"])
        if key in seen:
            np.testing.assert_allclose(block, seen[key], atol=1e-6)
        seen[key] = block
        out[at] = block
    assert not np.isnan(out).any()
    return out


def _attention_inputs(b=4, l=16, h=4, dh=8, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(b, l, h, dh).astype(np.float32) for _ in range(4))
    mask = rs.rand(b, l) > 0.2
    mask[:, 0] = True
    mask[1, l // 2:] = False  # second half padding: on sp = 2, a whole chunk
    mask[2] = False           # every key masked
    return q, k, v, mask, do


def _jax_attention_and_grads(fn, sizes, q, k, v, mask, do, **kw):
    """JAX's output and its gradients of ``sum(out * do)`` in q, k, v
    (one jitted vjp)."""
    mesh = _jax_mesh(sizes).mesh

    @jax.jit
    def run(q_, k_, v_, m_, do_):
        out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, m_, mesh, **kw), q_, k_, v_)
        return out, vjp(do_)

    out, grads = run(q, k, v, mask, do)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_attention(group, sizes, mode, q, k, v, mask, do):
    results = group.run("attention", sizes, mode, q, k, v, mask, do)
    return [_assemble([(c, arrays[i]) for c, arrays in results], sizes, q.shape)
            for i in range(4)]


@pytest.mark.parametrize("sizes", [MESH_A, SP2], ids=["dp2sp2tp2", "sp2"])
def test_ring_attention_matches_jax(request, sizes):
    group = _group(request, sizes)
    q, k, v, mask, do = _attention_inputs()
    out, dq, dk, dv = _port_attention(group, sizes, "ring", q, k, v, mask, do)
    want, grads = _jax_attention_and_grads(jax_ring, sizes, q, k, v, mask, do, pallas=None)
    np.testing.assert_allclose(out, want, **TOL)
    for got, ref in zip((dq, dk, dv), grads):
        np.testing.assert_allclose(got, ref, **TOL)
    # The Pallas kernel's ring (interpret mode) gives the same output.
    kernel = np.asarray(jax_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(mask), _jax_mesh(sizes).mesh, pallas="interpret"))
    np.testing.assert_allclose(out, kernel, **TOL)
    # The all-masked row averages every value, as the one-device step does.
    np.testing.assert_allclose(out[2], np.broadcast_to(v[2].mean(axis=0), out[2].shape),
                               **TOL)


@pytest.mark.parametrize("sizes", [MESH_A, SP2], ids=["dp2sp2tp2", "sp2"])
def test_ulysses_attention_matches_jax(request, sizes):
    group = _group(request, sizes)
    q, k, v, mask, do = _attention_inputs(seed=1)
    out, dq, dk, dv = _port_attention(group, sizes, "ulysses", q, k, v, mask, do)
    want, grads = _jax_attention_and_grads(jax_ulysses, sizes, q, k, v, mask, do)
    np.testing.assert_allclose(out, want, **TOL)
    for got, ref in zip((dq, dk, dv), grads):
        np.testing.assert_allclose(got, ref, **TOL)


def test_ulysses_refuses_heads_that_do_not_divide(world2):
    messages = world2.run("ulysses_refusal", SP2, 3)
    want = ("Ulysses needs heads-per-shard (3) divisible by the 'sp' axis size (2); "
            "use ring attention instead")
    assert messages == [want, want]
    with pytest.raises(ValueError, match=r"heads-per-shard \(3\)"):
        x = jnp.zeros((2, 4, 3, 8))
        jax_ulysses(x, x, x, jnp.ones((2, 4), bool), _jax_mesh(SP2).mesh)


MOE_CASES = [(MESH_A, 2, 0.5, 0), (MESH_A, 1, 0.75, 1), (MESH_B, 2, 0.5, 2)]


@pytest.mark.parametrize("sizes,top_k,cf,seed", MOE_CASES,
                         ids=[f"{'dp2sp2tp2' if s is MESH_A else 'dp2pp2ep2'}-top{k}-cf{c}"
                              for s, k, c, _ in MOE_CASES])
def test_sharded_routed_moe_matches_jax(world8, sizes, top_k, cf, seed):
    b, l, d, f, e = 4, 8, 16, 24, 4
    rs = np.random.RandomState(seed)
    h = torch.from_numpy(rs.randn(b, l, d).astype(np.float32)).bfloat16().float().numpy()
    logits = (rs.randn(b, l, e) * 2).astype(np.float32)
    logits[0, :2] = 0.5  # exact ties: the first maximal expert wins
    w1 = torch.from_numpy(rs.randn(e, d, f).astype(np.float32) / 4).bfloat16().float().numpy()
    w2 = torch.from_numpy(rs.randn(e, f, d).astype(np.float32) / 5).bfloat16().float().numpy()
    mask = rs.rand(b, l) > 0.2
    mask[-1, l // 2:] = False
    dout = rs.randn(b, l, d).astype(np.float32)
    routing = dict(n_experts=e, moe_mode="topk", moe_top_k=top_k, moe_capacity_factor=cf)
    results = world8.run("routed_moe", sizes, routing, h, logits, w1, w2, mask, dout)
    out, dh, dlogits = (_assemble([(dict(c, tp=0), arrays[i]) for c, arrays, _ in results],
                                  sizes, shape)
                        for i, shape in enumerate((h.shape, h.shape, logits.shape)))
    for _c, _a, full in results[1:]:
        for name in ("w1", "w2"):
            np.testing.assert_allclose(full[name], results[0][2][name], atol=1e-6)
    dw1, dw2 = results[0][2]["w1"], results[0][2]["w2"]

    jcfg = JaxEncoderConfig(**routing)

    @jax.jit
    def run(h_, g_, a_, b_, m_, do_):
        fn = lambda x, g, p, q: jax_routed_moe(x.astype(jnp.bfloat16), g, p.astype(jnp.bfloat16),
                                               q.astype(jnp.bfloat16), jcfg, m_
                                               ).astype(jnp.float32)
        o, vjp = jax.vjp(fn, h_, g_, a_, b_)
        return o, vjp(do_)

    want, jgrads = run(h, logits, w1, w2, mask, dout)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (h, logits, w1, w2)]
    ref = _routed_moe(leaves[0].bfloat16(), leaves[1], leaves[2].bfloat16(),
                      leaves[3].bfloat16(), EncoderConfig(**routing),
                      torch.from_numpy(mask)).float()
    (ref * torch.from_numpy(dout)).sum().backward()
    np.testing.assert_allclose(out, np.asarray(want), atol=2e-2)
    np.testing.assert_allclose(out, ref.detach().numpy(), atol=2e-2)
    assert not out[~mask].any()  # padding tokens take no slot and get nothing
    # The picks overflow an expert's C slots: which tokens keep theirs
    # follows the global token order across dp and sp.
    capacity = int(np.ceil(cf * top_k * b * l / e))
    picks = np.argsort(-logits, axis=-1, kind="stable")[..., :top_k][mask]
    assert np.bincount(picks.reshape(-1), minlength=e).max() > capacity
    for got, jax_ref, port_ref in zip((dh, dlogits, dw1, dw2), jgrads, leaves):
        scale = np.abs(np.asarray(jax_ref)).max()
        np.testing.assert_allclose(got, np.asarray(jax_ref), atol=2e-2 * scale)
        np.testing.assert_allclose(got, port_ref.grad.numpy(), atol=2e-2 * scale)


def _embed_inputs(b=4, l=16, vocab=128, seed=0):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, vocab, (b, l)).astype(np.int32)
    mask = rs.rand(b, l) > 0.25
    mask[:, 0] = True
    mask[1, l // 2:] = False
    return tokens, mask


ENCODER_CASES = [
    (MESH_A, "ring", {}), (MESH_A, "ulysses", {}),
    (MESH_A, "ring", dict(moe_mode="topk", moe_top_k=2, moe_capacity_factor=0.5)),
    (MESH_A, "ulysses", dict(moe_mode="topk", moe_top_k=2, moe_capacity_factor=0.5)),
    (MESH_B, "ring", {}), (MESH_B, "ulysses", {}),
    (MESH_B, "ring", dict(moe_mode="topk", moe_top_k=2, moe_capacity_factor=0.5)),
    (MESH_B, "ulysses", dict(moe_mode="topk", moe_top_k=1, moe_capacity_factor=0.5)),
]


@pytest.mark.parametrize("sizes,attn_mode,routing", ENCODER_CASES,
                         ids=[f"{'dp2sp2tp2' if s is MESH_A else 'dp2pp2ep2'}-{a}-"
                              f"{r.get('moe_mode', 'soft')}{r.get('moe_top_k', '')}"
                              for s, a, r in ENCODER_CASES])
def test_sharded_encoder_embeddings_match_jax(world8, sizes, attn_mode, routing):
    width = dict(WIDTH, attn_mode=attn_mode, **routing)
    jcfg = JaxEncoderConfig(**width)
    params = {k: np.asarray(v) for k, v in init_encoder(jax.random.PRNGKey(0), jcfg).items()}
    if routing:
        params["gate"] = np.zeros_like(params["gate"])
    tokens, mask = _embed_inputs()
    mesh = _jax_mesh(sizes)
    want = np.asarray(jax.jit(lambda p, t, m: jax_embed(p, t, m, jcfg, mesh))(
        params, tokens, mask))
    got = world8.run("embed", sizes, width, params, tokens, mask)
    for z in got[1:]:
        np.testing.assert_allclose(z, got[0], atol=1e-6)  # every rank holds the rows
    np.testing.assert_allclose(got[0], want, atol=2e-2)
    one = Encoder(EncoderConfig(**width))
    one.load_state_dict(params_from_jax(params))
    with torch.inference_mode():
        ref = embed(one, torch.from_numpy(tokens).long(), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got[0], ref, atol=2e-2)


BASE_DECLS = [f"export function load{n}(p0: number, p1: string): boolean {{ return p1.length > p0; }}"
              for n in ("User", "Node", "Decl", "File", "Tree")]
EDITED_DECLS = [d.replace("load", "fetch").replace("p0: number", "p0: bigint") for d in BASE_DECLS]


def test_signature_matcher_pairs_on_the_engine_mesh_as_on_one_device(world2):
    cfg = dict(WIDTH)
    deletes = [(("function", "a.ts"), t) for t in BASE_DECLS]
    adds = [(("function", "a.ts"), t) for t in reversed(EDITED_DECLS)]
    one = EmbeddingSignatureMatcher(threshold=0.5, seq_len=32, allow_untrained=True,
                                    cfg=MatcherConfig(encoder=EncoderConfig(**cfg)),
                                    device="cpu")
    want_pairs = one.pair(deletes, adds)
    want_z = one.embed_texts([t for _, t in deletes])
    got = world2.run("pairs", {"dp": 2, "pp": 1, "sp": 1, "tp": 1, "ep": 1}, None, cfg,
                     deletes, adds, 0.5)
    assert want_pairs
    for pairs, z in got:
        assert pairs == want_pairs
        np.testing.assert_allclose(z, want_z, atol=1e-5)
