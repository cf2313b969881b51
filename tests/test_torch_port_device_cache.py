"""The port's device-resident batch assembly (data/device_cache.py) against
the JAX package's DeviceDataPipeline and its intensity recipe, on the CPU.

Fixture: the JAX test's (synthetic AMOS cases of shape (48, 48, 40), crop
(24, 32, 32), uniform ids). Draws (case indices, crop corners, flips,
augmentation parameters, batch numbers) must be equal, and with the
augmentation off the batches equal JAX's exactly in f32. With fixed
parameters and the noise off, the batched recipe is within 1e-5 of JAX's
single-sample recipe (f32 summation order of the blur).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_pl_tpu.data.dataset import AMOSDataset as JAMOSDataset
from multimodal_pl_tpu.data import device_cache as jdc
from multimodal_pl_tpu.data.synthetic import make_synthetic_amos
from multimodal_pl_tpu_torch.data import device_cache as dc
from multimodal_pl_tpu_torch.data.dataset import AMOSDataset

torch.set_num_threads(2)

CROP = (24, 32, 32)
KEYS = ("image", "label", "catlas", "sup_mask", "label_t")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("amos_dev"))
    make_synthetic_amos(r, n_ct=4, n_mri=2, shape=(48, 48, 40), seed=0, spread_ids=False)
    return r


def _ds(root, cls):
    atlas = np.load(os.path.join(root, "atlas_mm.npy"))
    return cls(os.path.join(root, "imagesTr"), crop_size=CROP, usage="train", atlas=atlas,
               cache=True)


@pytest.fixture(scope="module")
def ds(root):
    return _ds(root, AMOSDataset)


@pytest.fixture(scope="module")
def jds(root):
    return _ds(root, JAMOSDataset)


def _jax_draws(jds, batch_size, epochs, **kw):
    """The JAX pipeline's draws, recorded at its batch program's call."""
    pipe = jdc.DeviceDataPipeline(jds, **kw)
    seen = []

    def record(images, labels, catlas, sup, lt, idxs, starts, flips, p, key):
        seen.append((np.asarray(idxs), np.asarray(starts), np.asarray(flips),
                     {k: np.asarray(v) for k, v in p.items()}))
        return {}

    pipe._make_batch = record
    for _ in pipe.batches(batch_size, epochs=epochs):
        pass
    return seen


@pytest.mark.parametrize("augment,mirror", [(True, True), (False, False)])
def test_draws_match_jax(ds, jds, augment, mirror):
    """One seed, 2 epochs of batches of 2: the same case indices, corners,
    flips and augmentation parameters as the JAX pipeline, batch for batch."""
    kw = dict(augment=augment, mirror=mirror, seed=3)
    want = _jax_draws(jds, 2, 2, compute_dtype=jnp.float32, **kw)
    pipe = dc.DeviceDataPipeline(ds, compute_dtype=torch.float32, device="cpu", **kw)
    got = list(pipe.draws(2, epochs=2))
    assert len(got) == len(want) == 2 * (len(ds) // 2)
    for n, ((idxs, starts, flips, p, nbatch), (ji, js, jf, jp)) in enumerate(zip(got, want)):
        assert nbatch == n + 1
        np.testing.assert_array_equal(idxs, ji)
        np.testing.assert_array_equal(starts, js)
        np.testing.assert_array_equal(flips, jf)
        assert sorted(p) == sorted(jp) == sorted(dc._AUG_KEYS)
        for k in p:
            np.testing.assert_array_equal(p[k], jp[k], err_msg=k)


@pytest.mark.parametrize("mirror", [False, True])
def test_batches_equal_jax_without_augment(ds, jds, mirror):
    """Augmentation off, f32: every batch of 2 epochs equals the JAX
    pipeline's exactly, in the layout and dtypes of ``to_device``."""
    kw = dict(augment=False, mirror=mirror, seed=1)
    jpipe = jdc.DeviceDataPipeline(jds, compute_dtype=jnp.float32, **kw)
    pipe = dc.DeviceDataPipeline(ds, compute_dtype=torch.float32, device="cpu", **kw)
    n = 0
    for got, want in zip(pipe.batches(3, epochs=2), jpipe.batches(3, epochs=2)):
        assert got["image"].shape == (3, *CROP, 1) and got["image"].dtype == torch.float32
        assert got["label"].dtype == torch.uint8 and got["catlas"].shape == (13, *CROP)
        assert got["sup_mask"].dtype == got["label_t"].dtype == torch.float32
        for k in KEYS:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        n += 1
    assert n == 2 * (len(ds) // 3)


def test_crop_matches_host_sample(ds):
    """A device batch at the host sample's crop corner holds the host
    sample's image, label, catlas, sup_mask and label_t (bf16 image and
    catlas: the host values rounded once)."""
    pipe = dc.DeviceDataPipeline(ds, compute_dtype=torch.bfloat16, augment=False, device="cpu")
    ds.rng = np.random.default_rng(123)
    s = ds[0]
    hh, ww, dd = ds._prepared(0)[1].shape
    r = np.random.default_rng(123)
    b = int(r.integers(0, hh - ds.crop_h))
    c = int(r.integers(0, ww - ds.crop_w))
    a = int(r.integers(0, dd - ds.crop_d))
    zeros = {k: np.zeros(1, np.float32) for k in dc._AUG_KEYS}
    got = pipe.assemble(np.array([0]), np.array([[a, b, c]]), np.zeros((1, 3)), zeros, 1)
    bf = lambda v: torch.from_numpy(v).to(torch.bfloat16)  # noqa: E731
    assert torch.equal(got["image"][0], bf(s.image))
    assert torch.equal(got["catlas"], bf(s.catlas))
    np.testing.assert_array_equal(got["label"][0].numpy(), s.label)
    np.testing.assert_array_equal(got["sup_mask"].numpy(), s.sup_mask)
    np.testing.assert_array_equal(got["label_t"].numpy(), s.label_t)


def _params(batch, **cfg):
    p = {k: np.zeros(batch, np.float32) for k in dc._AUG_KEYS}
    p["blur_sig"][:], p["bm_f"][:], p["ct_f"][:] = 0.75, 1.0, 1.0
    for k, v in cfg.items():
        p[k][:] = v
    return p


def _jax_one(x, p, i):
    return np.asarray(jdc.intensity_augment_device(
        jnp.asarray(x), {k: jnp.asarray(v[i]) for k, v in p.items()}, jax.random.PRNGKey(0)))


def _port(x, p):
    return dc.intensity_augment_device(torch.from_numpy(x), {
        k: torch.from_numpy(v) for k, v in p.items()}, torch.Generator().manual_seed(0)).numpy()


@pytest.mark.parametrize("cfg", [
    dict(blur_on=[1, 1, 0], blur_sig=[0.8, 0.5, 0.75]),
    dict(bm_on=[1, 0, 1], bm_f=[1.2, 1.0, 0.8]),
    dict(ba_on=[1, 1, 0], ba_sh=[-0.07, 0.1, 0.0]),
    dict(ct_on=[1, 0, 1], ct_f=[0.8, 1.0, 1.2]),
    dict(blur_on=[1, 1, 1], blur_sig=[0.55, 1.0, 0.7], bm_on=[1, 0, 1], bm_f=[0.9, 1, 1.1],
         ct_on=[1, 1, 0], ct_f=[1.2, 0.8, 1.0]),
])
def test_intensity_recipe_matches_jax(cfg):
    """A batch of 3, each sample with its own fixed parameters, noise off:
    within 1e-5 of the JAX recipe applied to each sample alone."""
    x = np.random.default_rng(0).normal(size=(3, 12, 16, 16)).astype(np.float32)
    p = _params(3, **cfg)
    got = _port(x, p)
    for i in range(3):
        np.testing.assert_allclose(got[i], _jax_one(x[i], p, i), rtol=0, atol=1e-5)


def test_blur_pads_symmetric_at_the_edge():
    """A volume whose edge planes stand out: the blur near the edge follows
    numpy's 'symmetric' padding (JAX's), within 1e-5; torch's 'reflect'
    mode is 0.1 or more off there."""
    x = np.zeros((1, 10, 12, 14), np.float32)
    x[:, 0], x[:, :, -1], x[:, :, :, 0] = 3.0, -2.0, 1.5
    x += np.random.default_rng(1).normal(size=x.shape).astype(np.float32) * 0.1
    p = _params(1, blur_on=1, blur_sig=1.0)
    got = _port(x, p)
    want = _jax_one(x[0], p, 0)
    np.testing.assert_allclose(got[0], want, rtol=0, atol=1e-5)
    kern = dc.gauss_kernels(torch.tensor([1.0]))
    xr = torch.from_numpy(x)
    for ax in (1, 2, 3):  # the same blur with torch's 'reflect' padding
        pad = [0, 0] * 3
        pad[2 * (3 - ax)], pad[2 * (3 - ax) + 1] = dc._BLUR_R, dc._BLUR_R
        xp = torch.nn.functional.pad(xr[None], pad, mode="reflect")[0]
        xr = sum(kern[0, t] * xp.narrow(ax, t, x.shape[ax]) for t in range(2 * dc._BLUR_R + 1))
    assert np.abs(xr.numpy()[0] - want).max() > 0.1


def test_symmetric_index_is_numpy_symmetric():
    for n, r in ((5, 4), (3, 4), (9, 4), (1, 2)):
        want = np.pad(np.arange(n), r, mode="symmetric")
        np.testing.assert_array_equal(dc.symmetric_index(n, r, "cpu").numpy(), want)


def test_noise_statistics():
    """Noise on (std 0.2) for two of three samples of zeros: those have
    std 0.2 and mean 0 within 0.02, the third stays 0; a generator seeded
    alike gives the same noise."""
    x = np.zeros((3, 16, 16, 16), np.float32)
    p = _params(3, noise_on=[1, 0, 1], noise_std=[0.2, 0.2, 0.2])
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    got = dc.intensity_augment_device(torch.from_numpy(x), pt, torch.Generator().manual_seed(7))
    for i in (0, 2):
        assert abs(got[i].std().item() - 0.2) < 0.02 and abs(got[i].mean().item()) < 0.02
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    again = dc.intensity_augment_device(torch.from_numpy(x), pt, torch.Generator().manual_seed(7))
    assert torch.equal(got, again)


def test_aug_params_equal_jax():
    """The port's copy of draw_aug_params consumes the generator exactly as
    the original."""
    got = dc.draw_aug_params(np.random.default_rng(4), 500)
    want = jdc.draw_aug_params(np.random.default_rng(4), 500)
    assert dc._AUG_KEYS == jdc._AUG_KEYS and dc._BLUR_R == jdc._BLUR_R
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_augmented_batches_are_seeded(ds):
    """With augmentation, the same seed gives the same bits; a batch's noise
    depends on its batch number, not on what came before."""
    def run(seed):
        pipe = dc.DeviceDataPipeline(ds, compute_dtype=torch.float32, seed=seed, device="cpu")
        draws = list(pipe.draws(1, epochs=3))
        for d in draws:
            d[3]["noise_on"][:], d[3]["noise_std"][:] = 1.0, 0.1
        return pipe, draws

    pipe, draws = run(2)
    first = [pipe.assemble(*d)["image"] for d in draws]
    pipe2, _ = run(2)
    assert all(torch.equal(a, pipe2.assemble(*d)["image"]) for a, d in zip(first, draws))
    last = pipe2.assemble(*draws[-1])["image"]  # out of order: the same bits
    assert torch.equal(last, first[-1])
    assert not torch.equal(pipe.assemble(*draws[0])["image"], run(5)[0].assemble(*draws[0])["image"])


class _Mixed:
    crop_d, crop_h, crop_w = CROP
    scale = False

    def __len__(self):
        return 2

    def _prepared(self, i):
        shp = (48, 48, 40) if i == 0 else (56, 48, 40)
        return (i, np.zeros(shp, np.float32), np.zeros(shp, np.int32),
                np.zeros((13, *shp), np.float32))

    def _sup_mask(self, cid):
        return np.ones(14, np.float32)


def test_pipeline_rejects_what_it_cannot_hold(ds, monkeypatch):
    with pytest.raises(ValueError, match="uniform"):
        dc.DeviceDataPipeline(_Mixed(), device="cpu")
    scaled = _Mixed()
    scaled.scale = True
    with pytest.raises(ValueError, match="host-path only"):
        dc.DeviceDataPipeline(scaled, device="cpu")
    with pytest.raises(ValueError, match="rank 2 is not in a world of 2"):
        dc.DeviceDataPipeline(ds, device="cpu", rank=2, world=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dc.DeviceDataPipeline(ds)  # the default device is the GPU
