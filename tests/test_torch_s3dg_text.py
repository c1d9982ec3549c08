"""The port's text-video ``S3DGText`` (``models/s3dg_text.py``) against the
JAX package on the CPU.

* Both stems (space-to-depth and the standard (3, 7, 7) / 2 one) and both
  towers in eval mode at fp32 within 1e-5, on one MIL-NCE-named state dict
  built from the shape manifest with seeded values: it goes through JAX's
  ``convert_torch_s3dg_text`` into JAX's model and through the port's strict
  load (torch BN's counters dropped by ``milnce_names``) into the port's;
  the port's manifest equals JAX's, and ``jax_weights.s3dg_text_state_dict``
  carries JAX's converted tree back to the same names and values.
* JAX ``tests/test_extra_models.py``'s cases: ``space_to_depth_3d`` (equal to
  JAX's, a pure reshuffle), ``SelfGating``'s bound, the tokenizer (equal to
  JAX's, ids exactly), and the text tower's padding invariance (equal to
  JAX's embedding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_resnet_util import reference_state_dict, rel_l2
from video_graph_ssl_tpu.models import s3dg_text as jax_text
from video_graph_ssl_tpu.utils.torch_interop import (convert_torch_s3dg_text,
                                                     reference_s3dg_text_shape_manifest)
from video_graph_ssl_tpu_torch.models import s3dg_text as port_text
from video_graph_ssl_tpu_torch.utils.jax_weights import s3dg_text_state_dict

torch.set_num_threads(1)
EMBD, WORDS = 32, 64


@pytest.mark.parametrize("s2d", [True, False])
def test_both_towers_match_jax(s2d):
    manifest = port_text.reference_s3dg_text_shape_manifest(EMBD, s2d, WORDS)
    assert manifest == reference_s3dg_text_shape_manifest(EMBD, s2d, WORDS)
    sd = reference_state_dict(manifest, seed=9)
    g = np.random.default_rng(0)
    video = g.standard_normal((2, 16, 32, 32, 3)).astype(np.float32)
    ids = np.array([[3, 7, 1, 0, 0, 0], [5, 0, 0, 0, 0, 0]], np.int32)

    params, stats = convert_torch_s3dg_text(sd)
    jm = jax_text.S3DGText(embd_dim=EMBD, num_text_embeddings=WORDS, space_to_depth=s2d,
                           dtype=jnp.float32)
    ref = jax.jit(lambda v, x, i: jm.apply(v, x, i, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(video), jnp.asarray(ids))
    back = s3dg_text_state_dict(params, stats)
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)

    model = port_text.S3DGText(EMBD, space_to_depth=s2d, num_text_embeddings=WORDS,
                               dtype=torch.float32)
    torch_sd = {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}
    torch_sd.update({k[:-len("running_mean")] + "num_batches_tracked": torch.tensor(3)
                     for k in torch_sd if k.endswith("running_mean")})
    model.load_state_dict(port_text.milnce_names(torch_sd), strict=True)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(video), torch.from_numpy(ids))
    for key in ("video_embedding", "text_embedding"):
        assert out[key].shape == (2, EMBD)
        assert rel_l2(out[key].numpy(), np.asarray(ref[key])) < 1e-5, key


def test_space_to_depth_matches_jax():
    x = np.arange(2 * 4 * 6 * 4 * 3, dtype=np.float32).reshape(2, 4, 6, 4, 3)
    y = port_text.space_to_depth_3d(torch.from_numpy(x))
    assert y.shape == (2, 2, 3, 2, 24)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jax_text.space_to_depth_3d(
        jnp.asarray(x))))
    assert float(y.sum()) == float(x.sum())     # a pure reshuffle


def test_self_gating_bound():
    gate = port_text.SelfGating(8)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 8, 4, 4, 4))).float()
    with torch.no_grad():
        out = gate(x)
    # the gate is a sigmoid in (0, 1): the output is bounded by the input
    assert bool((out.abs() <= x.abs() + 1e-6).all())


def test_tokenizer_matches_jax():
    vocab = ["the", "dog", "runs", "don't"]
    w2t = port_text.build_word_to_token(vocab)
    assert w2t == jax_text.build_word_to_token(vocab)
    sentences = ["The DOG runs far", "", "unknown words only", "don't, the dog!"]
    ids = port_text.tokenize(sentences, w2t, max_words=4)
    np.testing.assert_array_equal(ids[0], [1, 2, 3, 0])
    np.testing.assert_array_equal(ids[1], [0, 0, 0, 0])
    np.testing.assert_array_equal(ids[2], [0, 0, 0, 0])
    np.testing.assert_array_equal(ids[3], [4, 1, 2, 0])
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, jax_text.tokenize(sentences, w2t, max_words=4))


def test_text_tower_padding_invariance_matches_jax():
    jm = jax_text.SentenceEmbedding(embd_dim=8, num_embeddings=50)
    ids1 = np.asarray([[3, 7, 0, 0]], np.int32)
    ids2 = np.asarray([[3, 7, 0, 0, 0, 0, 0, 0]], np.int32)
    v = jax.jit(lambda i: jm.init(jax.random.key(0), i))(jnp.asarray(ids1))
    ref = np.asarray(jax.jit(lambda vv, i: jm.apply(vv, i))(v, jnp.asarray(ids1)))
    p = v["params"]
    tower = port_text.SentenceEmbedding(8, 50)
    tower.load_state_dict({
        "word_embd.weight": torch.from_numpy(np.array(p["word_embd"]["embedding"])),
        **{f"{fc}.{n}": torch.from_numpy(np.array(p[fc][k]).T.copy() if k == "kernel"
                                         else np.array(p[fc][k]))
           for fc in ("fc1", "fc2") for n, k in (("weight", "kernel"), ("bias", "bias"))}},
        strict=True)
    with torch.no_grad():
        e1, e2 = (tower(torch.from_numpy(i)).numpy() for i in (ids1, ids2))
    np.testing.assert_allclose(e1, e2, rtol=1e-5)
    assert rel_l2(e1, ref) < 1e-5
