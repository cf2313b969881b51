"""Port inference (multimodal_pl_tpu_torch.infer): the copied pure functions
equal the JAX package's, the batched predictor equals the per-tile loop,
argmax output equals the argmax of the logits output, bucketing is exact,
and the metrics equal the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_pl_tpu.infer import gaussian as jgaussian
from multimodal_pl_tpu.infer import metrics as jmetrics
from multimodal_pl_tpu.infer import sliding as jsliding
from multimodal_pl_tpu_torch.infer import metrics
from multimodal_pl_tpu_torch.infer.gaussian import gaussian_importance_map
from multimodal_pl_tpu_torch.infer.sliding import (
    SlidingWindowPredictor,
    make_window_grid,
    pad_to_bucket,
    predict_sliding_naive,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("size,tile", [((128, 256, 256), (64, 192, 192)),
                                       ((100, 200, 180), (64, 96, 96)),
                                       ((64, 192, 192), (64, 192, 192)),
                                       ((10, 9, 9), (4, 4, 4))])
def test_window_grid_equals_jax(size, tile):
    np.testing.assert_array_equal(make_window_grid(size, tile),
                                  jsliding.make_window_grid(size, tile))


@pytest.mark.parametrize("shape", [(24, 48, 40), (128, 256, 256), (17, 200, 190)])
def test_pad_to_bucket_equals_jax(shape):
    assert pad_to_bucket(shape) == jsliding.pad_to_bucket(shape)
    assert (pad_to_bucket(shape, (8, 8, 8), (16, 32, 32))
            == jsliding.pad_to_bucket(shape, (8, 8, 8), (16, 32, 32)))


@pytest.mark.parametrize("tile", [(16, 24, 24), (64, 192, 192)])
def test_gaussian_equals_jax(tile):
    np.testing.assert_array_equal(gaussian_importance_map(tile),
                                  jgaussian.gaussian_importance_map(tile))


def _toy_apply(tiles):
    """Deterministic, position-sensitive toy network: channel c = input + c."""
    return torch.cat([tiles + float(c) for c in range(3)], dim=-1)


def test_batched_matches_naive_loop(rng):
    vol = rng.standard_normal((24, 40, 40)).astype(np.float32)
    tile = (16, 24, 24)
    got = SlidingWindowPredictor(_toy_apply, tile, 3, window_batch=3, bucket=(8, 8, 8))(vol)
    want = predict_sliding_naive(_toy_apply, vol, tile, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_bucket_padding_is_exact(rng):
    vol = rng.standard_normal((20, 30, 30)).astype(np.float32)
    tile = (16, 24, 24)
    a = SlidingWindowPredictor(_toy_apply, tile, 3, window_batch=2, bucket=(4, 4, 4))(vol)
    b = SlidingWindowPredictor(_toy_apply, tile, 3, window_batch=5, bucket=(16, 16, 16))(vol)
    assert a.shape == b.shape == (20, 30, 30, 3)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_argmax_output_matches_logits_argmax(rng):
    vol = rng.standard_normal((10, 9, 9)).astype(np.float32)
    tile = (4, 4, 4)
    a = SlidingWindowPredictor(_toy_apply, tile, 3, window_batch=2, bucket=(4, 4, 4))(vol)
    b = SlidingWindowPredictor(_toy_apply, tile, 3, window_batch=2, bucket=(4, 4, 4),
                               output="argmax")(vol)
    assert b.dtype == torch.uint8 and b.shape == (10, 9, 9)
    assert torch.equal(a.argmax(-1).to(torch.uint8), b)


def test_predict_iter_matches_call(rng):
    tile = (16, 24, 24)
    pred = SlidingWindowPredictor(_toy_apply, tile, 3, window_batch=2, bucket=(8, 8, 8))
    vols = [rng.standard_normal(s).astype(np.float32)
            for s in [(24, 40, 40), (20, 30, 30), (24, 40, 40)]]
    got = list(pred.predict_iter(vols))
    assert len(got) == len(vols)
    for g, v in zip(got, vols):
        assert torch.equal(g, pred(v))


def test_tta_symmetric_toy_equals_plain(rng):
    vol = rng.standard_normal((16, 24, 24)).astype(np.float32)
    tile = (16, 24, 24)
    plain = SlidingWindowPredictor(_toy_apply, tile, 3)(vol)
    tta = SlidingWindowPredictor(_toy_apply, tile, 3, tta=True)(vol)
    np.testing.assert_allclose(plain.numpy(), tta.numpy(), rtol=1e-5, atol=1e-5)


def test_bf16_compute_casts_tiles(rng):
    vol = rng.standard_normal((16, 24, 24)).astype(np.float32)
    seen = []

    def net(tiles):
        seen.append(tiles.dtype)
        return _toy_apply(tiles)

    SlidingWindowPredictor(net, (16, 24, 24), 3, compute_dtype=torch.bfloat16)(vol)
    assert seen and set(seen) == {torch.bfloat16}


def test_organ_scores_equal_jax(rng):
    logits = rng.standard_normal((2, 6, 7, 8, 14)).astype(np.float32) * 3
    labels = rng.integers(0, 14, (2, 6, 7, 8)).astype(np.int32)
    atlas = rng.random((2, 6, 7, 8, 13)).astype(np.float32)
    got = metrics.organ_scores(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jmetrics.organ_scores(jnp.asarray(logits), jnp.asarray(labels))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    got_a = metrics.organ_scores_atlas(torch.from_numpy(logits), torch.from_numpy(labels),
                                       torch.from_numpy(atlas))
    want_a = jmetrics.organ_scores_atlas(jnp.asarray(logits), jnp.asarray(labels),
                                         jnp.asarray(atlas))
    for g, w in zip(got_a, want_a):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fn", ["dice_score", "senc_score", "spec_score"])
def test_binary_scores_equal_jax(rng, fn):
    p = rng.random((2, 6, 6, 6)) > 0.5
    t = rng.random((2, 6, 6, 6)) > 0.5
    got = getattr(metrics, fn)(torch.from_numpy(p), torch.from_numpy(t)).item()
    want = float(getattr(jmetrics, fn)(jnp.asarray(p), jnp.asarray(t)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_label_scores_perfect_prediction():
    labels = np.zeros((1, 8, 8, 8), np.int64)
    labels[0, :4] = 1
    labels[0, 4:, :4] = 2
    lab = torch.from_numpy(labels)
    dice, senc, spec = metrics.label_scores(lab.to(torch.uint8), lab)
    assert dice.shape == (13,)
    assert dice[0] > 0.99 and dice[1] > 0.98 and float(dice[2:].sum()) == 0.0
    logits = jax.nn.one_hot(labels, 14) * 100.0
    want = jmetrics.organ_scores(logits, jnp.asarray(labels))[0]
    np.testing.assert_allclose(dice.numpy(), np.asarray(want), rtol=1e-6)
