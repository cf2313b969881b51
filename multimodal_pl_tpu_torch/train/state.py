"""Train state and optimizers, port of ``multimodal_pl_tpu/train/state.py``.

Every mutable quantity of a run lives in one :class:`TrainState`: the
segmenter, refiner and discriminator parameters as name -> tensor dicts
(the models' ``named_parameters`` names), the SGD momentum of (params,
rparams), the EMA class tokens, and the step and epoch counters. The models
themselves are stateless skeletons that the step runs with
``torch.func.functional_call``.

Optimizer semantics (as in the JAX package):
- segmenter and refiner: torch-SGD(momentum 0.9, wd 1e-4), poly LR per epoch;
  the refiner is trained unless ``train_refiner=False`` (the literal
  reference snapshot);
- discriminator: the reference builds a fresh Adam every iteration, which
  with zeroed moments is ``p - lr * g / (|g| + eps)`` (sign-SGD).
The updates are functional tensor ops; the non-finite guard selects old or
new values with a device-side flag, so nothing waits for the device.

Kernel choice is explicit: ``conv_impl`` and ``gn_impl`` ('kernel' or
'plain') go to every model. The JAX config's ``pallas_gn``/``pallas_k2``/
``pallas_infer`` map to them; its ``bd`` has no port. ``remat``
checkpoints the segmenter's stages (the refiner and the discriminator
have none, as in JAX).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from multimodal_pl_tpu_torch.models import UNet3DFEAM, init_class_tokens
from multimodal_pl_tpu_torch.models.discriminator import (
    DeepStyleDiscriminator,
    NormStyleDiscriminator,
)
from multimodal_pl_tpu_torch.models.refiner import RefinerUNet3D

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Per-run configuration of the train step (the JAX StepConfig's fields)."""

    num_classes: int = 14
    num_epochs: int = 500
    deep_up: bool = True
    augmask: int = 2
    weight_gan: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 1e-4
    disc_lr: float = 1e-4
    token_alpha: float = 0.01
    # static batch of the refiner's gradient pass: the supervised
    # labeled-modality organs are gathered up front, at most one per case
    refine_grad_organs: int = 2
    train_refiner: bool = True
    pretrain_epoch: int = 20
    ramp_until: int = 50
    weight_feature_max: float = 0.1
    compute_dtype: torch.dtype = torch.float32
    conv_impl: str = "kernel"
    gn_impl: str = "kernel"
    base: int = 32
    layers: tuple = (1, 2, 2, 2, 2)
    refiner_filter: int = 24
    disc_ndf: int = 32
    disc_depth: int = 6
    weight_std: bool = True
    remat: bool = False


def tiny_step_config(**overrides) -> StepConfig:
    """The smallest geometry the stride pyramids allow (32^3 patches), as in
    the JAX package: base 16, single-block stages, refiner 8, disc 16 x 5."""
    cfg = dict(base=16, layers=(1, 1, 1, 1, 1), refiner_filter=8, disc_ndf=16, disc_depth=5)
    cfg.update(overrides)
    return StepConfig(**cfg)


def token_dims_for(cfg: StepConfig) -> Dict[str, int]:
    """EAM token dims track the decoder widths at the three EAM scales."""
    return {"t1": 4 * cfg.base, "t2": 2 * cfg.base, "t3": cfg.base}


def build_models(cfg: StepConfig, generator: torch.Generator | None = None, space=None):
    """The (segmenter, refiner, discriminator) triple for a StepConfig, drawn
    in that order from ``generator`` (default: seed 0); the segmenter built
    with ``space`` (a SpatialGroup, for the spatial train step)."""
    g = generator or torch.Generator().manual_seed(0)
    impls = dict(conv_impl=cfg.conv_impl, gn_impl=cfg.gn_impl)
    model = UNet3DFEAM(layers=cfg.layers, num_classes=cfg.num_classes,
                       weight_std=cfg.weight_std, deep_up=cfg.deep_up, base=cfg.base,
                       remat=cfg.remat, generator=g, space=space, **impls)
    refiner = RefinerUNet3D(num_classes=2, weight_std=cfg.weight_std,
                            init_filter=cfg.refiner_filter, in_channel=2, generator=g, **impls)
    disc = (NormStyleDiscriminator(ndf=cfg.disc_ndf, depth=cfg.disc_depth, generator=g)
            if cfg.deep_up else DeepStyleDiscriminator(ndf=cfg.disc_ndf, generator=g))
    return model, refiner, disc


@dataclasses.dataclass
class TrainState:
    params: Params                   # segmenter
    rparams: Params                  # refiner
    dparams: Params                  # discriminator
    momentum: Tuple[Params, Params]  # SGD momentum of (params, rparams)
    tokens: Params
    step: torch.Tensor               # int64 scalar
    epoch: torch.Tensor              # int64 scalar

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "TrainState":
        return map_state(lambda t: t.to(device), self)


def map_state(fn, state: TrainState) -> TrainState:
    """Apply fn to every tensor of the state."""
    def tree(d):
        return {k: fn(v) for k, v in d.items()}
    return TrainState(params=tree(state.params), rparams=tree(state.rparams),
                      dparams=tree(state.dparams),
                      momentum=(tree(state.momentum[0]), tree(state.momentum[1])),
                      tokens=tree(state.tokens), step=fn(state.step), epoch=fn(state.epoch))


def params_of(module: torch.nn.Module) -> Params:
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def create_train_state(generator: torch.Generator, cfg: StepConfig) -> TrainState:
    """Fresh state on the CPU: models drawn from ``generator``, then the
    tokens; zero momentum."""
    model, refiner, disc = build_models(cfg, generator)
    params, rparams = params_of(model), params_of(refiner)
    tokens = init_class_tokens(generator, cfg.num_classes, dims=token_dims_for(cfg))
    zeros = lambda p: {k: torch.zeros_like(v) for k, v in p.items()}  # noqa: E731
    return TrainState(params=params, rparams=rparams, dparams=params_of(disc),
                      momentum=(zeros(params), zeros(rparams)), tokens=tokens,
                      step=torch.zeros((), dtype=torch.long),
                      epoch=torch.zeros((), dtype=torch.long))


def torch_sgd_update(params: Params, grads: Params, buf: Params, lr, momentum: float = 0.9,
                     weight_decay: float = 1e-4):
    """torch.optim.SGD (dampening 0, no Nesterov): g += wd * p;
    buf = mu * buf + g; p -= lr * buf. Returns (new params, new buf)."""
    new_buf = {k: momentum * buf[k] + (grads[k] + weight_decay * p) for k, p in params.items()}
    return {k: p - lr * new_buf[k] for k, p in params.items()}, new_buf


def fresh_adam_update(params: Params, grads: Params, lr, eps: float = 1e-8) -> Params:
    """One step of a freshly built Adam == p - lr * g / (|g| + eps)."""
    return {k: p - lr * grads[k] / (grads[k].abs() + eps) for k, p in params.items()}


def all_finite(tree: Params) -> torch.Tensor:
    """Scalar bool tensor: every value of the dict is finite."""
    return torch.stack([torch.isfinite(v).all() for v in tree.values()]).all()


def select_tree(flag: torch.Tensor, new: Params, old: Params) -> Params:
    """new where flag else old, per tensor (the skip-bad-update guard)."""
    return {k: torch.where(flag, new[k], old[k]) for k in old}
