"""The whole ported slice against the JAX one: the port's
SlidingWindowPredictor driving the port's UNet3DFEAM vs the JAX
SlidingWindowPredictor driving the JAX voxel UNet3DFEAM, on the same volume
and the same (converted) weights, with and without flip TTA, and a
two-member ensemble with flip TTA through each CLI's ensemble forward.

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
from multimodal_pl_tpu_torch.cli.evaluate import ensemble_forward
from multimodal_pl_tpu_torch.convert import load_feam_state_dict, state_dict_from_jax
from multimodal_pl_tpu_torch.infer.sliding import SlidingWindowPredictor
from multimodal_pl_tpu_torch.models import UNet3DFEAM

torch.set_num_threads(2)

NC = 14
TILE = (16, 32, 32)
VOL = (24, 48, 40)
BUCKET = (8, 8, 8)
LAYERS = (1, 1, 1, 1, 1)  # one block per stage keeps the CPU run short


def _jax_ensemble(jmodel):
    """The JAX CLI's ensemble forward (multimodal_pl_tpu/cli/evaluate.py
    ``fwd``): the members' logits summed, over their count."""
    def fwd(tiles, *member_trees):
        out = None
        for p, t in zip(member_trees[0::2], member_trees[1::2]):
            o = jmodel.apply(p, tiles, t)[0]
            out = o if out is None else out + o
        return out / (len(member_trees) // 2)

    return fwd


@pytest.fixture(scope="module")
def models():
    """Two members: (JAX params, tokens) and the port's model loaded from
    them."""
    jmodel = JUNet3DFEAM(layers=LAYERS, num_classes=NC, weight_std=True, deep_up=True,
                         s2d=False, bd=False)
    trees, members = [], []
    for seed in (0, 2):
        tokens = jinit_class_tokens(jax.random.PRNGKey(seed + 1), NC)
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.zeros((1, *TILE, 1)), tokens)
        model = UNet3DFEAM(layers=LAYERS, num_classes=NC, deep_up=True).eval()
        load_feam_state_dict(model, state_dict_from_jax(params, tokens))
        trees += [params, tokens]
        members.append(model)
    return _jax_ensemble(jmodel), trees, members


@pytest.mark.parametrize("tta,n_members", [
    pytest.param(False, 1, id="False"), pytest.param(True, 1, id="True"),
    pytest.param(True, 2, id="True-ensemble2")])
def test_slice_matches_jax(models, tta, n_members):
    """One member, and a two-member ensemble with flip TTA (the port's
    ``cli.evaluate.ensemble_forward`` against the JAX CLI's ``fwd``)."""
    jfwd, trees, members = models
    trees, fwd = trees[:2 * n_members], ensemble_forward(members[:n_members])
    vol = np.random.default_rng(11).standard_normal(VOL).astype(np.float32)
    want = np.asarray(JPredictor(jfwd, TILE, NC, window_batch=2, tta=tta, bucket=BUCKET)(
        vol, *trees))
    pred = SlidingWindowPredictor(fwd, TILE, NC, window_batch=2, tta=tta, bucket=BUCKET,
                                  device="cpu")
    got = pred(vol).numpy()
    assert got.shape == want.shape == (*VOL, NC)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    labels = SlidingWindowPredictor(fwd, TILE, NC, window_batch=2, tta=tta, bucket=BUCKET,
                                    output="argmax", device="cpu")(vol).numpy()
    assert labels.dtype == np.uint8
    assert np.mean(labels == want.argmax(-1)) >= 0.999
