"""The whole ported slice against the JAX one: the port's
SlidingWindowPredictor driving the port's UNet3DFEAM vs the JAX
SlidingWindowPredictor driving the JAX voxel UNet3DFEAM, on the same volume
and the same (converted) weights, with and without flip TTA.

f32 on the CPU, tile (16, 32, 32), volume (24, 48, 40), window batch 2, one
block per encoder stage.
Blended logits at rtol 2e-3 / atol 2e-4 (tests/test_torch_parity.py's
tolerance); the argmax label maps agree on at least 99.9% of voxels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_pl_tpu.infer.sliding import SlidingWindowPredictor as JPredictor
from multimodal_pl_tpu.models import UNet3DFEAM as JUNet3DFEAM
from multimodal_pl_tpu.models import init_class_tokens as jinit_class_tokens
from multimodal_pl_tpu_torch.convert import load_feam_state_dict, state_dict_from_jax
from multimodal_pl_tpu_torch.infer.sliding import SlidingWindowPredictor
from multimodal_pl_tpu_torch.models import UNet3DFEAM

torch.set_num_threads(2)

NC = 14
TILE = (16, 32, 32)
VOL = (24, 48, 40)
BUCKET = (8, 8, 8)
LAYERS = (1, 1, 1, 1, 1)  # one block per stage keeps the CPU run short


@pytest.fixture(scope="module")
def models():
    tokens = jinit_class_tokens(jax.random.PRNGKey(1), NC)
    jmodel = JUNet3DFEAM(layers=LAYERS, num_classes=NC, weight_std=True, deep_up=True,
                         s2d=False, bd=False)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, *TILE, 1)), tokens)
    model = UNet3DFEAM(layers=LAYERS, num_classes=NC, deep_up=True).eval()
    load_feam_state_dict(model, state_dict_from_jax(params, tokens))
    jfwd = lambda tiles: jmodel.apply(params, tiles, tokens)[0]  # noqa: E731
    fwd = lambda tiles: model(tiles, aux=False)  # noqa: E731
    return jfwd, fwd


@pytest.mark.parametrize("tta", [False, True])
def test_slice_matches_jax(models, tta):
    jfwd, fwd = models
    vol = np.random.default_rng(11).standard_normal(VOL).astype(np.float32)
    want = np.asarray(JPredictor(jfwd, TILE, NC, window_batch=2, tta=tta, bucket=BUCKET)(vol))
    pred = SlidingWindowPredictor(fwd, TILE, NC, window_batch=2, tta=tta, bucket=BUCKET)
    got = pred(vol).numpy()
    assert got.shape == want.shape == (*VOL, NC)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    labels = SlidingWindowPredictor(fwd, TILE, NC, window_batch=2, tta=tta, bucket=BUCKET,
                                    output="argmax")(vol).numpy()
    assert labels.dtype == np.uint8
    assert np.mean(labels == want.argmax(-1)) >= 0.999
