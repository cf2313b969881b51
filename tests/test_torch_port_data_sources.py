"""The port's copies of the JAX package's JAX-free data and profiling
modules, against the originals: ``data/augment.py::mask_aug``,
``data/atlas.py::atlas_cores(_weighted)``, ``data/transforms.py``,
``data/config.py``, ``data/multisource.py`` and ``utils/profiling.py``.
Data comes out bit for bit equal under the same ``np.random.Generator``
seed, and the generator is left in the same state."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from multimodal_pl_tpu.data import atlas as jatlas
from multimodal_pl_tpu.data import augment as jaugment
from multimodal_pl_tpu.data import config as jconfig
from multimodal_pl_tpu.data import multisource as jmultisource
from multimodal_pl_tpu.data import transforms as jtransforms
from multimodal_pl_tpu.utils import profiling as jprofiling
from multimodal_pl_tpu_torch.data import atlas, augment, config, multisource, transforms
from multimodal_pl_tpu_torch.utils import profiling
from multimodal_pl_tpu_torch.utils.synthetic import make_synthetic_amos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("times", [1, 2, 3])
def test_mask_aug(times):
    m = np.random.default_rng(0).integers(0, 2, (3, 4, 5, 6, 2)).astype(np.uint8)
    assert _same(augment.mask_aug(m, times), jaugment.mask_aug(m, times))


def test_atlas_cores():
    """Both core definitions on a smoothed random atlas with an empty organ
    channel."""
    a = np.random.default_rng(1).random((5, 9, 11, 7)).astype(np.float32)
    a[a < 0.6] = 0
    a[2] = 0
    for name in ("atlas_cores", "atlas_cores_weighted"):
        got, want = getattr(atlas, name)(a), getattr(jatlas, name)(a)
        assert _same(got, want) and not got[2].any(), name


CFGS = [jtransforms.AugmentConfig(),
        jtransforms.AugmentConfig(patch_size=(6, 8, 10), p_rotate=1.0, p_zoom=1.0,
                                  p_translate=1.0, p_shear=1.0, p_flip=1.0,
                                  p_gaussian_noise=1.0, p_gaussian_smooth=1.0,
                                  p_intensity_scale=1.0, p_intensity_shift=1.0,
                                  p_adjust_contrast=1.0)]


def _port_cfg(cfg):
    return transforms.AugmentConfig(**vars(cfg))


@pytest.mark.parametrize("cfg", CFGS, ids=["defaults", "every_transform"])
def test_transforms(cfg):
    """Every function of transforms.py, with the defaults and with every
    transform firing, over several draws."""
    assert vars(transforms.AugmentConfig()) == vars(jtransforms.AugmentConfig())
    pcfg = _port_cfg(cfg)
    vol = np.random.default_rng(2).random((12, 14, 16)).astype(np.float32) * 300 - 50
    lab = np.random.default_rng(3).integers(0, 5, vol.shape).astype(np.uint8)
    assert _same(transforms.scale_intensity_range(vol, -20, 200, 0, 2, clip=False),
                 jtransforms.scale_intensity_range(vol, -20, 200, 0, 2, clip=False))
    assert _same(transforms.percentile_window(vol, 1, 99), jtransforms.percentile_window(vol, 1, 99))
    r, jr = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(6):
        m, jm = transforms._compose_affine(r, pcfg), jtransforms._compose_affine(jr, cfg)
        assert (m is None) == (jm is None) and (m is None or _same(m, jm))
        for got, want in zip(transforms.spatial_augment(vol, lab, r, pcfg),
                             jtransforms.spatial_augment(vol, lab, jr, cfg), strict=True):
            assert _same(got, want)
        for got, want in zip(transforms.rand_spatial_crop(vol, lab, (5, 7, 9), r),
                             jtransforms.rand_spatial_crop(vol, lab, (5, 7, 9), jr), strict=True):
            assert _same(got, want)
        assert _same(transforms.intensity_recipe(vol, r, pcfg),
                     jtransforms.intensity_recipe(vol, jr, cfg))
    assert r.random() == jr.random()


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_get_transforms_per_split(split):
    vol = np.random.default_rng(5).random((12, 14, 16)).astype(np.float32)
    lab = np.random.default_rng(6).integers(0, 5, vol.shape).astype(np.uint8)
    got_fn = transforms.get_transforms(split, _port_cfg(CFGS[1]), seed=7)
    want_fn = jtransforms.get_transforms(split, CFGS[1], seed=7)
    for _ in range(3):
        for got, want in zip(got_fn(vol, lab), want_fn(vol, lab), strict=True):
            assert _same(got, want)
    with pytest.raises(ValueError):
        transforms.get_transforms("bogus", _port_cfg(CFGS[0]))


def test_config_from_yaml(tmp_path):
    """get_config on a reference-style YAML file (the yaml typo and the
    renamed key included), the built-in defaults, a missing config, and
    augment_config_from_yaml."""
    p = tmp_path / "aug.yaml"
    p.write_text("dataset: amos\nmargin: [3, 4, 5]\naugmentation:\n  p_rotate: 0.5\n"
                 "  rotation: [-5, 5]\n  translate_precentage: 7.5\n  flip_axis: [0, 2]\n"
                 "  patch_size: [32, 64, 64]\n  unknown_key: 1\n")
    got, want = config.get_config(str(p)), jconfig.get_config(str(p))
    assert got == want and got["margin"] == [3, 4, 5]
    assert vars(config.augment_config_from_yaml(got)) == vars(jconfig.augment_config_from_yaml(want))
    assert config.get_config("amos", config_dir=str(tmp_path / "none")) == jconfig.get_config(
        "amos", config_dir=str(tmp_path / "none"))
    assert config.get_config("aug", config_dir=str(tmp_path)) == want
    with pytest.raises(FileNotFoundError):
        config.get_config("nothing", config_dir=str(tmp_path))
    assert config.AMOS_LABELS == jconfig.AMOS_LABELS
    assert config.DEFAULT_PREPROCESSING == jconfig.DEFAULT_PREPROCESSING


def test_get_config_without_yaml_raises(tmp_path, monkeypatch):
    """Where PyYAML is not installed, reading a file raises an ImportError
    that names it; the built-in defaults still load."""
    p = tmp_path / "c.yaml"
    p.write_text("a: 1\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="yaml"):
        config.get_config(str(p))
    assert config.get_config("preprocessing_amos", config_dir=str(tmp_path)) == \
        config.DEFAULT_PREPROCESSING


def test_importing_the_port_loads_no_yaml():
    """Every module of the port imports without loading yaml."""
    code = ("import importlib, json, pkgutil, sys\n"
            "import multimodal_pl_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
            "[importlib.import_module(n) for n in names]\n"
            "print(json.dumps({'names': names, 'yaml': 'yaml' in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    assert "multimodal_pl_tpu_torch.data.config" in got["names"] and not got["yaml"]


@pytest.fixture(scope="module")
def amos(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("amos"))
    return make_synthetic_amos(root, n_ct=8, n_mri=3, shape=(32, 32, 24), seed=5)


def test_source_of_and_converters():
    for name in ("amos_0040_0000.nii.gz", "amos_0507_0000.nii.gz", "CHAOS_3.nii.gz",
                 "liver_img_7.nii.gz", "other.nii.gz", "amos_0409_0000.nii.gz",
                 "amos_0410_0000.nii.gz"):
        path = os.path.join("/data", name)
        assert multisource.source_of(path) == jmultisource.source_of(path), name
    lab = np.random.default_rng(8).integers(0, 4, (5, 6, 7)).astype(np.uint8)
    for name in ("convert_seg_chaos", "convert_seg_msd"):
        assert _same(getattr(multisource, name)(lab), getattr(jmultisource, name)(lab))
    assert set(multisource.DEFAULT_CONVERTERS) == set(jmultisource.DEFAULT_CONVERTERS)


@pytest.mark.parametrize("usedataset,only_data,convert", [
    (("amos_ct",), -1, False), (("amos_ct", "amos_mri"), -1, True), (("amos_mri",), -1, False),
    (("amos_ct", "amos_mri"), 6, False), (("amos_ct",), 9, True)])
def test_multisource_dataset(amos, usedataset, only_data, convert):
    """The source and organ filters, the weighted atlas cores and every
    sample (a converter on the CT cases where ``convert``), the random crops
    drawn from the same seed."""
    img_dir, atlas_path, csv_path = amos
    conv = {"amos_ct": lambda lab: np.where(lab == 3, 4, lab)} if convert else None
    kw = dict(crop_size=(16, 24, 24), atlas=np.load(atlas_path), supervision_csv=csv_path,
              usage="train", seed=3, usedataset=usedataset, only_data=only_data,
              converters=conv)
    ref, port = jmultisource.MultiSourceDataset(img_dir, **kw), multisource.MultiSourceDataset(
        img_dir, **kw)
    assert ref.files == port.files and len(port) > 0
    assert _same(port.cores, ref.cores)
    for i in range(len(port)):
        a, b = ref[i], port[i]
        for field in ("image", "label", "catlas", "sup_mask", "label_t"):
            assert _same(getattr(b, field), getattr(a, field)), (i, field)


def test_step_timer_semantics(monkeypatch):
    """A fake clock drives both timers through the same steps: the rolling
    window, mean and rate agree, and stop() synchronizes a tensor's
    device."""
    ticks = iter(np.cumsum([0.0, 0.5, 1.0, 0.25, 2.0, 0.125, 0.75, 3.0, 0.5, 1.5, 0.0625,
                            4.0, 0.25]).tolist())
    clock = {"t": 0.0}
    monkeypatch.setattr(jprofiling, "time", types.SimpleNamespace(time=lambda: clock["t"]))
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter=lambda: clock["t"]))
    jt, pt = jprofiling.StepTimer(window=3), profiling.StepTimer(window=3)
    assert pt.rate(4) == jt.rate(4) == 0.0 and pt.mean == jt.mean == 0.0
    clock["t"] = next(ticks)
    for t0, t1 in zip(ticks, ticks):
        clock["t"] = t0
        jt.start(), pt.start()
        clock["t"] = t1
        assert pt.stop(torch.ones(2)) == jt.stop(None)
        assert pt.times == jt.times and len(pt.times) <= 3
        assert pt.mean == jt.mean and pt.rate(4) == jt.rate(4)


def test_trace_writes_a_chrome_trace(tmp_path):
    """trace() on the CPU writes a Chrome trace holding the body's ops; a
    trace that asks for 'cuda' without a GPU raises."""
    with profiling.trace(str(tmp_path / "t"), device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = list((tmp_path / "t").iterdir())
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            with profiling.trace(str(tmp_path / "u")):
                pass
