"""Checkpoint conversion: the port's state_dict from JAX params equals the
JAX package's own export (train/torch_import.py), loads strictly, and the
loader handles DataParallel prefixes, tokens and the .npz/.pth formats."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_pl_tpu.models import UNet3DFEAM as JUNet3DFEAM
from multimodal_pl_tpu.models import init_class_tokens as jinit_class_tokens
from multimodal_pl_tpu.train.torch_import import params_to_feam_state_dict
from multimodal_pl_tpu_torch.convert import (
    load_feam_state_dict,
    read_checkpoint,
    save_npz,
    state_dict_from_jax,
)
from multimodal_pl_tpu_torch.models import UNet3DFEAM

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


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_checkpoint_files_roundtrip(jax_params, tmp_path, fmt):
    params, tokens = jax_params
    sd = state_dict_from_jax(params, tokens)
    path = str(tmp_path / f"ckpt.{fmt}")
    if fmt == "npz":
        save_npz(path, sd)
    else:
        torch.save(sd, path)
    back = read_checkpoint(path)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
