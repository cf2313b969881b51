"""The port's asset entry points against the JAX package's: orientation,
spacing resample, body masks and whole-case preprocessing
(``data/preprocess.py``), atlas generation (``data/atlas.generate_atlas``),
the data lists and project setup (``data/lists.py``), and the
``mpl-preprocess-torch`` / ``mpl-atlas-torch`` CLIs, on seeded inputs and
on raw synthetic AMOS cases: the same arrays bit for bit, the same files
byte for byte, the same parsers and printed lines."""

import argparse
import gzip
import itertools
import os

import numpy as np
import pytest

from multimodal_pl_tpu.cli import atlas as jcli_atlas
from multimodal_pl_tpu.cli import preprocess as jcli_preprocess
from multimodal_pl_tpu.data import atlas as jatlas
from multimodal_pl_tpu.data import lists as jlists
from multimodal_pl_tpu.data import preprocess as jpre
from multimodal_pl_tpu_torch.cli import atlas as cli_atlas
from multimodal_pl_tpu_torch.cli import preprocess as cli_preprocess
from multimodal_pl_tpu_torch.data import atlas, lists, preprocess
from multimodal_pl_tpu_torch.data.nifti import read_nifti
from multimodal_pl_tpu_torch.utils.synthetic import (make_synthetic_amos, scanner_layout,
                                                    write_nifti_affine)

SPACING = (1.25, 1.5, 4.0)  # world (x, y, z) voxel size of a raw case


def raw_case(image, label, case_id):
    """A raw scan around a synthetic RAS case: 5 voxels of air on every side
    (-1000 for CT, 0 for MRI), the CT tissue lifted by 100 so that the
    411-500 body threshold of 25 finds a body, a label 14 and a 15 to drop,
    and for case 501 no body in the lower half of X over the first 35 Z
    slices (the hand-removal crop then cuts them)."""
    ct = case_id < 500
    image = np.pad(image + (100 if ct else 0), 5, constant_values=-1000 if ct else 0)
    label = np.pad(label, 5)
    label[7, 20, 20], label[8, 21, 21] = 14, 15
    label[25, 25, 6], label[25, 25, -7] = 1, 2  # the label extent spans X
    if case_id == 501:
        image[:35, :, : image.shape[2] * 6 // 10] = 0
    return image.astype(np.float32), label


@pytest.fixture(scope="module")
def raw_root(tmp_path_factory):
    """Raw cases 40 (CT, <= 410), 430 (CT, 411-500), 500 and 501 (MRI),
    each written with a non-RAS affine at another spacing (``raw_case``
    around a synthetic case, which is the RAS volume)."""
    root = str(tmp_path_factory.mktemp("raw_amos"))
    make_synthetic_amos(root, n_ct=8, n_mri=2, shape=(40, 40, 48), seed=1)
    img_dir, lab_dir = os.path.join(root, "imagesTr"), os.path.join(root, "labelsTr")
    for name in sorted(os.listdir(lab_dir)):
        cid = int(name.split("_")[1].split(".")[0])
        img_path = os.path.join(img_dir, name.replace(".nii", "_0000.nii"))
        lab_path = os.path.join(lab_dir, name)
        if cid not in (40, 430, 500, 501):
            os.remove(img_path)
            os.remove(lab_path)
            continue
        image, label = raw_case(read_nifti(img_path).data, read_nifti(lab_path).data, cid)
        write_nifti_affine(img_path, *scanner_layout(image, (1, 2, 0), (-1, 1, -1), SPACING))
        write_nifti_affine(lab_path, *scanner_layout(label, (1, 2, 0), (-1, 1, -1), SPACING))
    return root


@pytest.mark.parametrize("perm", list(itertools.permutations(range(3))))
def test_reorient_to_ras_matches_jax(perm):
    """All 8 sign patterns of each axis permutation: the port's array and
    spacing equal JAX's and give back the RAS volume."""
    rng = np.random.default_rng(sum(perm))
    ras = rng.standard_normal((5, 6, 7)).astype(np.float32)
    for signs in itertools.product((1, -1), repeat=3):
        data, affine = scanner_layout(ras, perm, signs, SPACING)
        got, sp = preprocess.reorient_to_ras(data, affine.astype(np.float32))
        ref, sp_ref = jpre.reorient_to_ras(data, affine.astype(np.float32))
        assert got.dtype == ref.dtype and np.array_equal(got, ref), (perm, signs)
        assert sp == sp_ref == SPACING and np.array_equal(got, ras), (perm, signs)


def test_resample_spacing_bit_equal():
    rng = np.random.default_rng(3)
    image = rng.normal(0, 300, (9, 14, 13)).astype(np.float32)
    label = rng.integers(0, 16, (9, 14, 13)).astype(np.uint8)
    got = preprocess.resample_spacing(image, label, SPACING)
    ref = jpre.resample_spacing(image, label, SPACING)
    assert got[0].shape == (18, 21, 16) and got[1].dtype == np.uint8
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)


@pytest.mark.parametrize("min_voxels", [50, 1e6])
def test_get_body_both_branches(min_voxels):
    """A small ``min_voxels`` keeps the largest component; the default
    finds none in a small volume and takes the 10^3 erosion/dilation
    fallback."""
    rng = np.random.default_rng(5)
    vol = np.full((24, 30, 30), -1000.0, np.float32)
    vol[4:20, 5:25, 5:26] = rng.normal(40, 20, (16, 20, 21))
    vol[2:5, 1:4, 26:29] = 100  # a small second component
    got = preprocess.get_body(vol, -200, min_voxels)
    ref = jpre.get_body(vol, -200, min_voxels)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    comp = preprocess.largest_component(vol >= -200, min_voxels)
    assert (comp is None) == (min_voxels > vol.size)
    if comp is not None:
        assert np.array_equal(comp, jpre.largest_component(vol >= -200, min_voxels))
        assert comp[10, 15, 15] == 1 and comp[3, 2, 27] == 0


def _tree(root):
    """{relative path: bytes} of every file under ``root`` (None for a
    directory); a .gz file's bytes decompressed, since its gzip header
    holds the time it was written."""
    out = {}
    for d, _, files in os.walk(root):
        out[os.path.relpath(d, root)] = None
        for name in files:
            path = os.path.join(d, name)
            with (gzip.open if name.endswith(".gz") else open)(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("case_id", [40, 430, 501])
def test_preprocess_case_files_byte_equal(raw_root, tmp_path, case_id):
    """A CT id <= 410 (threshold -200), a CT id in 411-500 (threshold 25,
    no hand removal) and an MRI id > 500 (hand removal): the written image
    and label files are byte-equal, at spacing (1, 1, 2)."""
    img = os.path.join(raw_root, "imagesTr", f"amos_{case_id:04d}_0000.nii.gz")
    lab = os.path.join(raw_root, "labelsTr", f"amos_{case_id:04d}.nii.gz")
    shapes = {}
    for tag, fn in (("port", preprocess.preprocess_case), ("jax", jpre.preprocess_case)):
        shapes[tag] = fn(img, lab, str(tmp_path / tag / "img.nii.gz"),
                         str(tmp_path / tag / "lab.nii.gz"), case_id)
    assert shapes["port"] == shapes["jax"]
    pre, post = shapes["port"]
    assert pre == (100, 75, 72)  # (Z, Y, X) 50x50x58 at z 4, y 1.5, x 1.25
    assert (post[0] < 40) == (case_id == 501)  # the hand-removal crop cut Z
    assert _tree(str(tmp_path / "port")) == _tree(str(tmp_path / "jax"))
    out = read_nifti(str(tmp_path / "port" / "img.nii.gz"))
    assert out.spacing == (1.0, 1.0, 2.0) and out.data.shape == shapes["port"][1]


def test_generate_atlas_bit_equal(raw_root, tmp_path):
    labels = os.path.join(raw_root, "labelsTr")
    got = atlas.generate_atlas(labels, str(tmp_path / "a.npy"), sigma=2.0)
    ref = jatlas.generate_atlas(labels, str(tmp_path / "b.npy"), sigma=2.0)
    assert got.dtype == np.float32 and got.shape[0] == 13
    assert np.array_equal(got, ref)
    assert (tmp_path / "a.npy").read_bytes() == (tmp_path / "b.npy").read_bytes()
    files = sorted(os.path.join(labels, f) for f in os.listdir(labels))
    assert np.array_equal(atlas.generate_atlas("", files=files, split_seed=3, train_frac=0.5),
                          jatlas.generate_atlas("", files=files, split_seed=3, train_frac=0.5))


def test_data_lists_and_setup_project_trees_equal(raw_root, tmp_path):
    ts = os.path.join(raw_root, "imagesTs")
    os.makedirs(ts, exist_ok=True)
    with open(os.path.join(ts, "amos_0600_0000.nii.gz"), "wb") as f:
        f.write(b"not read")
    got = lists.create_data_lists(raw_root, str(tmp_path / "lp"))
    ref = jlists.create_data_lists(raw_root, str(tmp_path / "lj"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref]
    assert _tree(str(tmp_path / "lp")) == _tree(str(tmp_path / "lj"))
    lists.setup_project(raw_root, str(tmp_path / "sp"))
    jlists.setup_project(raw_root, str(tmp_path / "sj"))
    tree = _tree(str(tmp_path / "sp"))
    assert tree == _tree(str(tmp_path / "sj"))
    assert {"list/MOTS/MOTS_train.txt", "list/MOTS/MOTS_test.txt", "supervise_mask.csv",
            "atlas_mm.npy", "snapshots/amos_ours_tpu"} <= set(tree)
    assert tree["list/MOTS/MOTS_test.txt"].decode().splitlines() == [
        os.path.join(ts, "amos_0600_0000.nii.gz")]


def _options(parser):
    return sorted((o, a.default, a.required) for a in parser._actions for o in a.option_strings)


def _jax_parser(main, argv):
    """The parser a JAX CLI's ``main`` builds (it has no ``get_arguments``)."""
    seen = []

    class Parsed(Exception):
        pass

    def grab(self, args=None, namespace=None):
        seen.append(self)
        raise Parsed

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Parsed):
            main(argv)
    return seen[0]


@pytest.mark.parametrize("name", ["preprocess", "atlas"])
def test_cli_parsers_match_jax(name):
    port, ref = {"preprocess": (cli_preprocess, jcli_preprocess),
                 "atlas": (cli_atlas, jcli_atlas)}[name]
    assert _options(port.get_arguments()) == _options(_jax_parser(ref.main, []))
    assert port.get_arguments().description == _jax_parser(ref.main, []).description


def test_cli_outputs_match_jax(raw_root, tmp_path, capsys):
    """Both CLIs write the JAX CLIs' files and print their lines."""
    printed = {}
    for tag, pre, atl in (("port", cli_preprocess.main, cli_atlas.main),
                          ("jax", jcli_preprocess.main, jcli_atlas.main)):
        out = tmp_path / tag
        pre(["--images_dir", os.path.join(raw_root, "imagesTr"),
             "--out_images", str(out / "imagesTr"), "--out_labels", str(out / "labelsTr")])
        atl(["--labels_dir", str(out / "labelsTr"), "--out_atlas", str(out / "atlas_mm.npy"),
             "--out_csv", str(out / "supervise_mask.csv"), "--sigma", "2"])
        printed[tag] = capsys.readouterr().out.replace(str(out), "OUT")
    assert printed["port"] == printed["jax"]
    assert "Totally 4 files." in printed["port"] and "shape=(13, " in printed["port"]
    port, ref = _tree(str(tmp_path / "port")), _tree(str(tmp_path / "jax"))
    assert port == ref and len([k for k in port if k.endswith(".nii.gz")]) == 8
