"""Checkpoint conversion: the port's state_dict from JAX params equals the
JAX package's own export (train/torch_import.py), loads strictly, and the
loader handles DataParallel prefixes, tokens and every checkpoint format a
user holds: .npz, .pth, mpl-train-torch's ckpt_<step>.pt, and the orbax
ckpt_<step>/ directories of the JAX package's train/checkpoint.py (written
here by that module, read back by the port through tensorstore alone)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_pl_tpu.models import UNet3DFEAM as JUNet3DFEAM
from multimodal_pl_tpu.models import init_class_tokens as jinit_class_tokens
from multimodal_pl_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from multimodal_pl_tpu.train.state import TrainState as JTrainState
from multimodal_pl_tpu.train.torch_import import params_to_feam_state_dict
from multimodal_pl_tpu_torch.convert import (
    load_feam_state_dict,
    read_checkpoint,
    read_orbax_train_state,
    save_npz,
    state_dict_from_jax,
)
from multimodal_pl_tpu_torch.models import UNet3DFEAM
from multimodal_pl_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from multimodal_pl_tpu_torch.train.state import TrainState

torch.set_num_threads(2)
NC = 14


@pytest.fixture(scope="module")
def jax_params():
    tokens = jinit_class_tokens(jax.random.PRNGKey(1), NC)
    model = JUNet3DFEAM(num_classes=NC, weight_std=True, s2d=False, bd=False)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 32, 32, 1)), tokens)
    return params, tokens


def test_state_dict_equals_jax_export(jax_params):
    params, tokens = jax_params
    sd = state_dict_from_jax(params, tokens)
    ref = params_to_feam_state_dict(params, tokens)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert sd[k].dtype == torch.float32
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)


def test_loads_strict_into_port_model(jax_params):
    params, tokens = jax_params
    model = UNet3DFEAM(num_classes=NC)
    got_tokens = load_feam_state_dict(model, state_dict_from_jax(params, tokens))
    assert sorted(model.state_dict()) == sorted(params_to_feam_state_dict(params))
    for k in tokens:
        np.testing.assert_array_equal(got_tokens[k].numpy(), np.asarray(tokens[k]))
    np.testing.assert_array_equal(
        model.conv1.weight.detach().numpy(),
        np.asarray(params["params"]["encoder"]["conv1"]["kernel"]).transpose(4, 3, 0, 1, 2))


def test_loader_strips_dataparallel_prefix_and_rejects_missing(jax_params):
    params, _ = jax_params
    sd = {f"module.{k}": v for k, v in params_to_feam_state_dict(params).items()}
    model = UNet3DFEAM(num_classes=NC)
    assert load_feam_state_dict(model, sd) is None  # no class_token keys
    sd.pop("module.precls_conv.2.bias")
    with pytest.raises(RuntimeError):
        load_feam_state_dict(UNet3DFEAM(num_classes=NC), sd)


def _jax_state(params, tokens, step=7):
    """A JAX TrainState around ``params``, with small refiner and
    discriminator trees (as tests/test_checkpoint.py builds them)."""
    ks = jax.random.split(jax.random.PRNGKey(step), 2)
    rparams = {"params": {"w": jax.random.normal(ks[0], (3, 3))}}
    dparams = {"params": {"w": jax.random.normal(ks[1], (2, 2))}}
    momentum = jax.tree_util.tree_map(lambda a: a * 0.5, (params, rparams))
    return JTrainState(params=params, rparams=rparams, dparams=dparams, momentum=momentum,
                       tokens=tokens, step=jnp.asarray(step, jnp.int32),
                       epoch=jnp.asarray(3, jnp.int32))


@pytest.mark.parametrize("fmt", ["npz", "pth", "ckpt_pt", "orbax"])
def test_checkpoint_files_roundtrip(jax_params, tmp_path, fmt):
    """read_checkpoint gives the same state_dict (tokens as class_token
    keys) from each format: an .npz, a .pth, mpl-train-torch's whole-state
    ckpt_<step>.pt and mpl-train's orbax ckpt_<step>/."""
    params, tokens = jax_params
    sd = state_dict_from_jax(params, tokens)
    path = str(tmp_path / f"ckpt.{fmt}")
    if fmt == "npz":
        save_npz(path, sd)
    elif fmt == "pth":
        torch.save(sd, path)
    elif fmt == "ckpt_pt":
        seg = {k: v for k, v in sd.items() if not k.startswith("class_token")}
        toks = {k: torch.from_numpy(np.array(v)) for k, v in tokens.items()}
        state = TrainState(params=seg, rparams={}, dparams={}, momentum=({}, {}),
                           tokens=toks, step=torch.tensor(7), epoch=torch.tensor(1))
        path = save_checkpoint(str(tmp_path), state, 7)
    else:
        path = jsave_checkpoint(str(tmp_path), _jax_state(params, tokens), 7)
    back = read_checkpoint(path)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_orbax_train_state_reads_back(tmp_path):
    """A small TrainState (tests/test_checkpoint.py's tree) written by the
    JAX package's orbax checkpointer: read_orbax_train_state returns every
    leaf, the momentum pair, tokens, step and epoch, through
    train_state_from_jax's key layout; restore_checkpoint and
    latest_checkpoint take the directory too, beside a ckpt_<step>.pt."""
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    params = {"params": {"w": jax.random.normal(ks[0], (4, 4)), "b": jnp.ones(4)}}
    tokens = {"t1": jax.random.normal(ks[1], (13, 8)), "t2": jax.random.normal(ks[2], (13, 4))}
    js = _jax_state(params, tokens, step=5)
    path = jsave_checkpoint(str(tmp_path), js, 5)
    got = read_orbax_train_state(path)
    np.testing.assert_array_equal(got.params["w"].numpy(), np.asarray(params["params"]["w"]))
    np.testing.assert_array_equal(got.params["b"].numpy(), np.ones(4, np.float32))
    np.testing.assert_array_equal(got.rparams["w"].numpy(), np.asarray(js.rparams["params"]["w"]))
    np.testing.assert_array_equal(got.dparams["w"].numpy(), np.asarray(js.dparams["params"]["w"]))
    np.testing.assert_array_equal(got.momentum[0]["w"].numpy(),
                                  0.5 * np.asarray(params["params"]["w"]))
    np.testing.assert_array_equal(got.momentum[1]["w"].numpy(),
                                  0.5 * np.asarray(js.rparams["params"]["w"]))
    assert sorted(got.tokens) == ["t1", "t2"]
    np.testing.assert_array_equal(got.tokens["t2"].numpy(), np.asarray(tokens["t2"]))
    assert int(got.step) == 5 and int(got.epoch) == 3
    assert torch.equal(restore_checkpoint(path).params["w"], got.params["w"])
    assert latest_checkpoint(str(tmp_path)) == path
    save_checkpoint(str(tmp_path), got, 4)
    assert latest_checkpoint(str(tmp_path)) == path
    later = save_checkpoint(str(tmp_path), got, 6)
    assert latest_checkpoint(str(tmp_path)) == later


def test_orbax_full_width_params_load_strict(jax_params, tmp_path):
    """The flagship's full-width params and tokens in an orbax checkpoint
    load strictly into the port's UNet3DFEAM, weights and tokens exact."""
    params, tokens = jax_params
    path = jsave_checkpoint(str(tmp_path), _jax_state(params, tokens), 3)
    model = UNet3DFEAM(num_classes=NC)
    got_tokens = load_feam_state_dict(model, read_checkpoint(path))
    for k in tokens:
        np.testing.assert_array_equal(got_tokens[k].numpy(), np.asarray(tokens[k]))
    want = state_dict_from_jax(params)
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())


def test_orbax_reader_without_tensorstore_names_it(tmp_path, monkeypatch):
    """Where tensorstore is missing (an import of it fails), the reader
    raises an ImportError that names the package."""
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        read_orbax_train_state(str(tmp_path))
