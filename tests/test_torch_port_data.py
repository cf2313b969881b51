"""The port's copy of the data pipeline (``multimodal_pl_tpu_torch/data``)
against the JAX package's ``multimodal_pl_tpu.data`` on seeded synthetic
AMOS-layout cases: the same samples, the same augmented batches, the same
NIfTI bytes."""

import gzip

import numpy as np
import pytest

from multimodal_pl_tpu.data import nifti as jnifti
from multimodal_pl_tpu.data.augment import intensity_augment as jintensity_augment
from multimodal_pl_tpu.data.dataset import AMOSDataset as JAMOSDataset
from multimodal_pl_tpu_torch.data import nifti
from multimodal_pl_tpu_torch.data.augment import apply_intensity, draw_intensity
from multimodal_pl_tpu_torch.data.dataset import AMOSDataset
from multimodal_pl_tpu_torch.utils.synthetic import make_synthetic_amos

CROP = (16, 24, 24)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("amos"))
    return make_synthetic_amos(root, n_ct=6, n_mri=2, shape=(32, 32, 24), seed=4)


def _pair(data, **kw):
    img_dir, atlas_path, csv_path = data
    atlas = np.load(atlas_path)
    return (JAMOSDataset(img_dir, crop_size=CROP, atlas=atlas, supervision_csv=csv_path, **kw),
            AMOSDataset(img_dir, crop_size=CROP, atlas=atlas, supervision_csv=csv_path, **kw))


@pytest.mark.parametrize("usage", ["train", "valid"])
def test_samples_match_jax_dataset(data, usage):
    """Every field of every sample is equal, the random crops included
    (both datasets draw from the same seed)."""
    ref, port = _pair(data, usage=usage, seed=7)
    assert ref.files == port.files and len(port) > 0
    for i in range(len(port)):
        a, b = ref[i], port[i]
        for field in ("image", "label", "catlas", "sup_mask", "label_t"):
            got, want = getattr(b, field), getattr(a, field)
            assert got.dtype == want.dtype and np.array_equal(got, want), (usage, i, field)
        assert (b.name, b.case_id) == (a.name, a.case_id)


def test_augmented_batches_match_jax_dataset(data):
    """The batch iterator (shuffle, intensity augmentation) draws the same
    numbers in the same order."""
    ref, port = _pair(data, usage="train", seed=3)
    rows = list(zip(ref.batches(2, epochs=2), port.batches(2, epochs=2)))
    assert len(rows) == 4
    for a, b in rows:
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    sup = list(zip(ref.supervision_rows(), port.supervision_rows(), strict=True))
    for (ma, ta), (mb, tb) in sup:
        assert np.array_equal(ma, mb) and np.array_equal(ta, tb)


@pytest.mark.parametrize("channels", [1, 2])
def test_intensity_draws_and_application_match_jax(channels):
    """draw_intensity then apply_intensity is JAX's intensity_augment, bit
    for bit, and leaves the generator where it does: 200 samples, so every
    transform and every per-channel branch fires."""
    x = np.random.default_rng(0).standard_normal((200, 3, 4, 5, channels)).astype(np.float32)
    rng, jrng = np.random.default_rng(9), np.random.default_rng(9)
    draws = draw_intensity(rng, len(x), x.shape[1:])
    for key in ("noise", "blur", "scale", "shift", "contrast"):
        assert any(key in d for d in draws), key
    got, want = apply_intensity(x, draws), jintensity_augment(x, jrng)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert rng.random() == jrng.random()


@pytest.mark.parametrize("dtype,suffix", [(np.uint8, ".nii.gz"), (np.float32, ".nii"),
                                          (np.float16, ".nii")])
def test_write_nifti_bytes_match(tmp_path, dtype, suffix):
    """write_nifti writes the same bytes (after gunzip: gzip stamps the
    time), and read_nifti reads them back."""
    arr = (np.random.default_rng(0).random((5, 6, 7)) * 100).astype(dtype)
    paths = [str(tmp_path / f"{name}{suffix}") for name in ("ref", "port")]
    jnifti.write_nifti(paths[0], arr, (1.0, 1.5, 2.0))
    nifti.write_nifti(paths[1], arr, (1.0, 1.5, 2.0))
    opener = gzip.open if suffix.endswith(".gz") else open
    blobs = []
    for p in paths:
        with opener(p, "rb") as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1]
    img = nifti.read_nifti(paths[1])
    want = arr if dtype != np.float16 else arr.astype(np.float32)
    assert np.array_equal(img.data, want) and img.spacing == (1.0, 1.5, 2.0)
