"""The port's data parallelism (multimodal_pl_tpu_torch.parallel, engine.py,
the rank-aware step, pipeline, loop and CLIs) against the JAX package's
shard_map versions, on the CPU.

Spawned cases run world size 2 over gloo (``tools/spawn.py``: one process
per rank, a FileStore group; the ranks run package functions and import no
test module, so no JAX), at ``tiny_step_config`` on a 32^3 patch in f32.
The cases that can share a spawn share one (the ``port_ranks`` fixture).
The JAX side runs on a 2-device CPU mesh (tests/conftest.py forces 8 host
devices).

Tolerances: against JAX, those of tests/test_torch_port_train_step.py
(losses and metrics rtol 1e-3; the updates by relative Frobenius norm <=
1e-3 per tree and <= 1.5e-3 per leaf; tokens rtol 1e-4); the predictor
against JAX's at tests/test_torch_port_slice.py's rtol 2e-3 / atol 2e-4.
Within the port: the ranks' states bit-equal to each other and to the
in-process reference ``(g0 + g1) / 2`` (two addends sum in any order to the
same bits); identical shards bit-equal to the single-process step (g + g
and 2 * counts are exact); the sharded predictor within 1e-5 of the single
one (its sum order differs); a rank's host batches bit-equal to its share
of the one-rank stream.
"""

import csv
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from multimodal_pl_tpu.data import device_cache as jdc
from multimodal_pl_tpu.data.dataset import AMOSDataset as JAMOSDataset
from multimodal_pl_tpu.models import NormStyleDiscriminator as JNormStyle
from multimodal_pl_tpu.models import RefinerUNet3D as JRefiner
from multimodal_pl_tpu.models import UNet3DFEAM as JUNet3DFEAM
from multimodal_pl_tpu.models.tokens import renew_tokens as jrenew_tokens
from multimodal_pl_tpu.parallel import mesh as jmesh
from multimodal_pl_tpu.parallel.sharded_infer import (
    ShardedSlidingWindowPredictor as JShardedPredictor,
)
from multimodal_pl_tpu.parallel.sharded_step import make_sharded_train_step as jsharded_step
from multimodal_pl_tpu.train.state import create_train_state as jcreate_train_state
from multimodal_pl_tpu.train.state import tiny_step_config as jtiny_step_config
from multimodal_pl_tpu_torch.cli import evaluate
from multimodal_pl_tpu_torch.convert import load_feam_state_dict, state_dict_from_jax
from multimodal_pl_tpu_torch.convert import train_state_from_jax
from multimodal_pl_tpu_torch.data import device_cache as dc
from multimodal_pl_tpu_torch.data.dataset import AMOSDataset
from multimodal_pl_tpu_torch.data.nifti import read_nifti
from multimodal_pl_tpu_torch.engine import Engine
from multimodal_pl_tpu_torch.infer.sliding import SlidingWindowPredictor
from multimodal_pl_tpu_torch.models import UNet3DFEAM
from multimodal_pl_tpu_torch.parallel import mesh
from multimodal_pl_tpu_torch.tools import spawn
from multimodal_pl_tpu_torch.train.checkpoint import latest_checkpoint
from multimodal_pl_tpu_torch.train.state import build_models, tiny_step_config
from multimodal_pl_tpu_torch.train.step import make_train_step
from multimodal_pl_tpu_torch.utils.synthetic import make_synthetic_amos

from tests.conftest import cpu_devices

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = (32, 32, 32)
NC = 14
WF = 0.05
UPDATE_LR = 1.0  # as in test_torch_port_train_step: new - old measures the step, not rounding
LABEL_T = [0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1]


def _shard(seed, sup_organ):
    rng = np.random.default_rng(seed)
    sup = np.zeros(NC, np.float32)
    sup[sup_organ] = 1
    return {"image": rng.standard_normal((1, *P, 1)).astype(np.float32),
            "label": rng.integers(0, NC, (1, *P)).astype(np.int32),
            "catlas": rng.random((NC - 1, *P)).astype(np.float32),
            "sup_mask": sup, "label_t": np.asarray(LABEL_T, np.float32)}


# two shards of different data and different supervised organs (5: in the
# labeled modality, so that rank's refiner trains; 3: not)
SHARDS = [_shard(0, 5), _shard(1, 3)]


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX step on its voxel models (tests/test_parallel.py's tiny
    configuration), shard_map'd over a data:2 mesh, and its initial state."""
    cfg = jtiny_step_config()
    state = jcreate_train_state(jax.random.PRNGKey(0), cfg)
    model = JUNet3DFEAM(layers=cfg.layers, num_classes=NC, weight_std=True, deep_up=True,
                        base=cfg.base, s2d=False, bd=False)
    refiner = JRefiner(num_classes=2, weight_std=True, init_filter=cfg.refiner_filter,
                       in_channel=2, s2d=False)
    disc = JNormStyle(ndf=cfg.disc_ndf, depth=cfg.disc_depth)
    step = jsharded_step(model, refiner, disc, cfg, jmesh.make_mesh("data:2", cpu_devices(2)))
    return state, step, model


def _token_case():
    """Class tokens, features (4 samples) and feature masks for the EMA."""
    rng = np.random.default_rng(0)
    tokens = {"t1": rng.standard_normal((13, 8)).astype(np.float32)}
    feats = rng.standard_normal((4, 2, 2, 2, 8)).astype(np.float32)
    fmask = rng.integers(0, 4, (4, 4, 4, 4)).astype(np.int32)
    return tokens, feats, fmask


ENGINE_VALUES = [torch.tensor([1.0, 2.0]), torch.tensor([3.0, 6.0])]
TILE = (16, 32, 32)
VOL = (16, 48, 40)  # 4 windows of TILE
PREDICT_RUNS = (("logits", 3), ("argmax", 3), ("logits", 4))
MODEL_KW = dict(layers=(1, 1, 1, 1, 1), num_classes=NC, deep_up=True, base=16)


def _volume():
    return np.random.default_rng(11).standard_normal(VOL).astype(np.float32)


def _segmenter(jax_side):
    """The port's segmenter (the step's, base 16) holding the JAX state's
    weights."""
    jstate = jax_side[0]
    model = UNet3DFEAM(**MODEL_KW).eval()
    load_feam_state_dict(model, state_dict_from_jax(jstate.params, jstate.tokens))
    return model


@pytest.fixture(scope="module")
def port_ranks(jax_side):
    """One spawn of two gloo ranks for the cases that share it; per rank
    {case: result}: ``step``, one data-parallel step on its own shard from
    the JAX initial state; ``same``, that step on the same shard on both
    ranks; ``tokens``, renew_tokens over the group; ``engine``, the
    Engine's reduction; ``predict``, the sharded predictor's PREDICT_RUNS."""
    cfg = tiny_step_config()
    state0 = train_state_from_jax(jax_side[0])
    shards = [_tb(s) for s in SHARDS]
    tokens, feats, fmask = _token_case()
    calls = {
        "step": (spawn.dp_step, (cfg, state0, shards, UPDATE_LR, WF)),
        "same": (spawn.dp_step, (cfg, state0, [shards[0]] * 2, UPDATE_LR, WF)),
        "tokens": (spawn.dp_renew_tokens, (
            {"t1": torch.from_numpy(tokens["t1"])},
            [[torch.from_numpy(feats[2 * r:2 * r + 2])] for r in range(2)],
            [torch.from_numpy(fmask[2 * r:2 * r + 2]) for r in range(2)], 0.5)),
        "engine": (spawn.dp_engine, (ENGINE_VALUES,)),
        "predict": (spawn.dp_predict, (MODEL_KW, _segmenter(jax_side).state_dict(), [_volume()],
                                       TILE, PREDICT_RUNS, "cpu", torch.float32, (8, 8, 8))),
    }
    ranks = spawn.run(spawn.dp_calls, 2, list(calls.values()))
    return [dict(zip(calls, r)) for r in ranks]


def test_sharded_step_matches_jax(jax_side, port_ranks):
    jstate0, jstep, _ = jax_side
    gb = {k: jnp.asarray(v) for k, v in jmesh.shard_batch(SHARDS).items()}
    jstate0_copy = jax.tree_util.tree_map(jnp.array, jstate0)  # the JAX step donates its state
    jstate1, jm = jstep(jstate0_copy, gb, jnp.float32(UPDATE_LR), jnp.float32(WF))
    state1, m, _ = port_ranks[0]["step"]
    assert sorted(m) == sorted(jm)
    for k in m:  # loss and disc_loss: the ranks' means; the rest rank 0's
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-3, atol=1e-6, err_msg=k)
    assert m["refine_loss"] > 0  # rank 0's shard trains the refiner
    state0, want1 = train_state_from_jax(jstate0), train_state_from_jax(jstate1)
    for group in ("params", "rparams"):
        old, new, ref = (getattr(s, group) for s in (state0, state1, want1))
        got = {k: (new[k] - old[k]).numpy() for k in ref}
        want = {k: (ref[k] - old[k]).numpy() for k in ref}
        for k in ref:
            rel = _rel(got[k], want[k])
            assert rel <= 1.5e-3, f"{group}.{k}: update rel Frobenius {rel:.2e}"
        rel = _rel(*(np.concatenate([t[k].ravel() for k in ref]) for t in (got, want)))
        assert rel <= 1e-3, f"{group}: update rel Frobenius {rel:.2e}"
    for k in want1.tokens:
        np.testing.assert_allclose(state1.tokens[k].numpy(), want1.tokens[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert int(state1.step) == int(jstate1.step) == 1


def test_sharded_step_ranks_equal_the_averaged_reference(jax_side, port_ranks):
    """Both ranks hold the same bits, equal to the in-process reference:
    per-shard gradients (g0 + g1) / 2, the step's updates, the token EMA of
    the summed class statistics; the loss is the mean of the shards'."""
    (s0, m0, _), (s1, m1, _) = (r["step"] for r in port_ranks)
    assert spawn.states_unequal(s0, s1) == []
    cfg = tiny_step_config()
    step = make_train_step(*build_models(cfg), cfg)
    ref, rm = spawn.reference_step(step, train_state_from_jax(jax_side[0]),
                                   [_tb(s) for s in SHARDS], torch.tensor(UPDATE_LR),
                                   torch.tensor(WF))
    assert spawn.states_unequal(s0, ref) == []
    assert m0["loss"] == m1["loss"] == float(rm["loss"])
    assert m0["disc_loss"] == m1["disc_loss"] == float(rm["disc_loss"])
    losses = [float(step.grads(train_state_from_jax(jax_side[0]), _tb(s), torch.tensor(WF))[0])
              for s in SHARDS]
    np.testing.assert_allclose(m0["loss"], np.mean(losses), rtol=1e-6)


def test_identical_shards_equal_the_single_step(jax_side, port_ranks):
    """The same shard on both ranks: the data-parallel step is the
    single-process step, bit for bit (tests/test_parallel.py's counterpart)."""
    cfg = tiny_step_config()
    state0 = train_state_from_jax(jax_side[0])
    single, m = make_train_step(*build_models(cfg), cfg)(state0, _tb(SHARDS[0]),
                                                         torch.tensor(UPDATE_LR), torch.tensor(WF))
    for got, gm, _ in (r["same"] for r in port_ranks):
        assert spawn.states_unequal(got, single) == []
        assert gm == {k: float(v) for k, v in m.items()}


def test_renew_tokens_over_a_group_matches_jax_psum(port_ranks):
    """renew_tokens with a 2-rank group == JAX's renew_tokens with a psum
    over a data:2 mesh (tests/test_parallel.py:53), and == the one-process
    EMA over the concatenated batch."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as JP

    from multimodal_pl_tpu_torch.models.tokens import renew_tokens

    tokens, feats, fmask = _token_case()
    m = jmesh.make_mesh("data:2", cpu_devices(2))
    sharded = shard_map(lambda t, f, k: jrenew_tokens(t, [f], k, alpha=0.5, axis_name="data"),
                        mesh=m, in_specs=(JP(), JP("data"), JP("data")), out_specs=JP(),
                        check_vma=False)
    want = np.asarray(jax.jit(sharded)({"t1": jnp.asarray(tokens["t1"])}, jnp.asarray(feats),
                                       jnp.asarray(fmask))["t1"])
    got = [r["tokens"] for r in port_ranks]
    for r in range(2):
        np.testing.assert_allclose(got[r]["t1"].numpy(), want, rtol=1e-5, atol=1e-6)
    whole = renew_tokens({"t1": torch.from_numpy(tokens["t1"])}, [torch.from_numpy(feats)],
                         torch.from_numpy(fmask), 0.5)
    np.testing.assert_allclose(got[0]["t1"].numpy(), whole["t1"].numpy(), rtol=1e-5, atol=1e-6)


def test_a_failed_rank_raises_in_the_caller():
    """Rank 1 raises (a mask of the wrong rank) while rank 0 waits in the
    all_reduce: the run ends both and raises."""
    tok = {"t1": torch.zeros(13, 8)}
    feats = [[torch.zeros(1, 2, 2, 2, 8)], [torch.zeros(1, 2, 2, 2, 8)]]
    masks = [torch.zeros(1, 4, 4, 4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32)]
    with pytest.raises(Exception, match="terminated with the following error"):
        spawn.run(spawn.dp_renew_tokens, 2, tok, feats, masks, 0.5, timeout=120)


def test_sharded_predictor_matches_single_and_jax(jax_side, port_ranks):
    """Two ranks, the step's segmenter (base 16), 4 windows. Window batch 3
    (2 batches with 2 copies of the last window, one batch a rank): the
    port's single predictor's blended logits within 1e-5, and JAX's sharded
    predictor's on a data:2 mesh at the slice tolerance (it pads to the same
    6 windows and adds the copies too); the argmax output is the logits'
    argmax. Both ranks get the same bits."""
    jmodel = jax_side[2]
    params, tokens = jax_side[0].params, jax_side[0].tokens
    model = _segmenter(jax_side)
    vol = _volume()
    jpred = JShardedPredictor(lambda t: jmodel.apply(params, t, tokens)[0], TILE, NC,
                              jmesh.make_mesh("data:2", cpu_devices(2)), window_batch=3,
                              bucket=(8, 8, 8))
    want = np.asarray(jpred(vol))
    single = SlidingWindowPredictor(lambda t: model(t, aux=False), TILE, NC, window_batch=3,
                                    bucket=(8, 8, 8), device="cpu")
    assert single._plan(VOL)[1].shape == (2, 3, 3)  # 6 windows: 2 copies of the last
    ref = single(vol).numpy()
    (outs, same0, _), (none, same1, _) = (r["predict"] for r in port_ranks)
    assert same0 and same1 and none is None
    (logits,), (labels,) = outs["logits", 3], outs["argmax", 3]
    assert logits.shape == (*VOL, NC)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), want, rtol=2e-3, atol=2e-4)
    assert labels.dtype == torch.uint8
    assert np.mean(labels.numpy() == logits.numpy().argmax(-1)) == 1.0


def test_sharded_predictor_adds_the_single_predictors_copies_only(jax_side, port_ranks):
    """Window batch 4: the 4 windows are one batch, so the port's sharded
    predictor runs them on rank 0 alone and adds no copy: the port's single
    predictor's blend within 1e-5 (the single predictors of both packages
    agree, tests/test_torch_port_infer.py). JAX's sharded predictor pads to
    world * window_batch = 8 windows and adds 4 copies of the last window:
    its blend is the port's outside the last window and where only the last
    window covers a voxel, and weighs the last window 5 times where it
    overlaps another."""
    from multimodal_pl_tpu_torch.infer.sliding import make_window_grid

    jmodel = jax_side[2]
    params, tokens = jax_side[0].params, jax_side[0].tokens
    model = _segmenter(jax_side)
    vol = _volume()
    jsharded = np.asarray(JShardedPredictor(lambda t: jmodel.apply(params, t, tokens)[0], TILE,
                                            NC, jmesh.make_mesh("data:2", cpu_devices(2)),
                                            window_batch=4, bucket=(8, 8, 8))(vol))
    single = SlidingWindowPredictor(lambda t: model(t, aux=False), TILE, NC, window_batch=4,
                                    bucket=(8, 8, 8), device="cpu")(vol).numpy()
    (outs, _, _), _ = (r["predict"] for r in port_ranks)
    (logits,) = outs["logits", 4]
    np.testing.assert_allclose(logits.numpy(), single, rtol=0, atol=1e-5)

    starts = make_window_grid(VOL, TILE)
    assert len(starts) == 4
    covered = np.zeros(VOL, np.int32)
    for d, h, w in starts:
        covered[d:d + TILE[0], h:h + TILE[1], w:w + TILE[2]] += 1
    d, h, w = starts[-1]
    last = np.zeros(VOL, bool)
    last[d:d + TILE[0], h:h + TILE[1], w:w + TILE[2]] = True
    same = ~last | (covered == 1)
    np.testing.assert_allclose(logits.numpy()[same], jsharded[same], rtol=2e-3, atol=2e-4)
    diff = np.abs(logits.numpy() - jsharded)[~same]
    assert diff.max() > 100 * 2e-4, diff.max()


def test_rank_window_batches_split_the_windows_as_jax():
    """Rank r's window batches are batches r, r + world, ... of the single
    predictor's list (padded with its last window to a multiple of
    window_batch). Where the batch count is a multiple of the world size,
    that is JAX's reshape (n_steps, n_dev, window_batch, 3) and swap of its
    first axes."""
    from multimodal_pl_tpu_torch.infer.sliding import make_window_grid
    from multimodal_pl_tpu_torch.parallel.sharded_infer import ShardedSlidingWindowPredictor

    shape = (24, 48, 40)
    starts = make_window_grid(shape, TILE)
    assert len(starts) == 8
    jax_layout = np.swapaxes(starts.reshape(2, 2, 2, 3), 0, 1)  # 4 batches of 2
    padded = np.concatenate([starts, starts[-1:]])  # 3 batches of 3
    with mesh.init_data_parallel("data:1", "cpu") as dp:
        pred = {wb: ShardedSlidingWindowPredictor(None, TILE, NC, dp.group, window_batch=wb,
                                                  bucket=(8, 8, 8), device="cpu")
                for wb in (2, 3)}
    for rank in range(2):  # the plans of rank r of 2
        for p in pred.values():
            p.rank, p.world = rank, 2
        np.testing.assert_array_equal(pred[2]._plan(shape)[1], jax_layout[rank])
        np.testing.assert_array_equal(pred[3]._plan(shape)[1].reshape(-1, 3),
                                      np.concatenate([padded[3 * j:3 * j + 3]
                                                      for j in range(rank, 3, 2)]))
    pred[2].rank, pred[2].world = 0, 3  # 4 batches over 3 ranks: rank 0 takes 0 and 3
    np.testing.assert_array_equal(pred[2]._plan(shape)[1].reshape(-1, 3),
                                  np.concatenate([starts[:2], starts[6:]]))


@pytest.fixture(scope="module")
def amos_root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("amos_dp"))
    make_synthetic_amos(r, n_ct=4, n_mri=2, shape=(48, 48, 40), seed=0, spread_ids=False)
    return r


@pytest.mark.parametrize("mirror", [False, True])
def test_rank_pipeline_batches_equal_the_jax_shards(amos_root, mirror):
    """Augmentation off (the noise off), f32: rank r's batch is shard r of
    the JAX pipeline's global batch on a data:2 mesh, batch for batch over
    2 epochs; a batch is 2 samples per rank."""
    crop = (24, 32, 32)
    atlas = np.load(os.path.join(amos_root, "atlas_mm.npy"))

    def ds(cls):
        return cls(os.path.join(amos_root, "imagesTr"), crop_size=crop, usage="train",
                   atlas=atlas, cache=True)

    kw = dict(augment=False, mirror=mirror, seed=1)
    jpipe = jdc.DeviceDataPipeline(ds(JAMOSDataset), compute_dtype=jnp.float32,
                                   mesh=jmesh.make_mesh("data:2", cpu_devices(2)), **kw)
    want = list(jpipe.batches(2, epochs=2))
    port_ds = ds(AMOSDataset)
    for rank in range(2):
        pipe = dc.DeviceDataPipeline(port_ds, compute_dtype=torch.float32, device="cpu",
                                     rank=rank, world=2, **kw)
        got = list(pipe.batches(2, epochs=2))
        assert len(got) == len(want) == 2 * (len(port_ds) // 4) > 0
        for g, w in zip(got, want):
            for k in ("image", "label"):
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k])[2 * rank:2 * rank + 2])
            for k in ("catlas", "sup_mask", "label_t"):
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k])[rank], err_msg=k)


def test_rank_pipeline_folds_the_rank_into_the_noise(amos_root):
    """With the augmentation on, the two ranks' noise streams differ (as
    JAX's fold_in(key, axis_index)); rank 0's is the one-device stream."""
    ds = AMOSDataset(os.path.join(amos_root, "imagesTr"), crop_size=(24, 32, 32), usage="train",
                     atlas=np.load(os.path.join(amos_root, "atlas_mm.npy")), cache=True)
    p = {k: np.zeros(1, np.float32) for k in dc._AUG_KEYS}
    p["noise_on"][:] = 1.0
    p["noise_std"][:] = 1.0
    draw = (np.zeros(1, np.int64), np.zeros((1, 3), np.int64), np.zeros((1, 3), np.float32), p, 1)
    r0, r1, one = (dc.DeviceDataPipeline(ds, compute_dtype=torch.float32, device="cpu", **kw)
                   .assemble(*draw)["image"]
                   for kw in (dict(rank=0, world=2), dict(rank=1, world=2), {}))
    assert not torch.equal(r0, r1) and torch.equal(r0, one)


def test_parse_mesh_and_shard_batch_match_jax():
    for spec in ("data:2", "data:4,space:2", "data:1"):
        jm = jmesh.make_mesh(spec, cpu_devices())
        assert list(mesh.parse_mesh(spec).items()) == list(zip(jm.axis_names, jm.devices.shape))
    rng = np.random.default_rng(0)
    per_dev = [{"image": rng.standard_normal((2, 4, 4, 4, 1)).astype(np.float32),
                "label": rng.integers(0, 3, (2, 4, 4, 4)),
                "catlas": rng.random((13, 4, 4, 4)).astype(np.float32),
                "sup_mask": rng.random(14).astype(np.float32),
                "label_t": rng.random(13).astype(np.float32)} for _ in range(3)]
    got, want = mesh.shard_batch(per_dev), jmesh.shard_batch(per_dev)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_init_data_parallel_checks_the_mesh(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="world size is 1"):
        with mesh.init_data_parallel("data:2", "cpu"):
            pass
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        with mesh.init_data_parallel("data:1,space:2", "cpu"):
            pass
    with mesh.init_data_parallel("data:1", "cpu") as dp:  # a group of one, no rendezvous
        assert (dp.rank, dp.world, dist.get_backend()) == (0, 1, "gloo")
        mesh.barrier(dp.device)
    assert not dist.is_initialized()
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.rank_device("cuda") == torch.device("cuda", 3)
    assert mesh.rank_device("cuda:1") == torch.device("cuda", 1)
    assert mesh.rank_device("cpu") == torch.device("cpu")


def test_world_size_one_group_leaves_the_step_unchanged(jax_side):
    """A group of one (the --mesh data:1 case): the step with the group is
    the step without it, bit for bit."""
    cfg = tiny_step_config()
    state0 = train_state_from_jax(jax_side[0])
    batch = _tb(SHARDS[0])
    lr, wf = torch.tensor(UPDATE_LR), torch.tensor(WF)
    single, m = make_train_step(*build_models(cfg), cfg)(state0, batch, lr, wf)
    from multimodal_pl_tpu_torch.parallel import make_sharded_train_step

    with mesh.init_data_parallel("data:1", "cpu") as dp:
        step = make_sharded_train_step(*build_models(cfg), cfg, dp.group)
        got, gm = step(state0, batch, lr, wf)
        assert Engine().world_size == 1
    assert spawn.states_unequal(got, single) == []
    assert all(torch.equal(gm[k], m[k]) for k in m)


def test_engine_surface():
    eng = Engine()
    assert (eng.world_size, eng.local_rank, eng.distributed) == (1, 0, False)
    t = torch.arange(6.0)
    assert float(eng.all_reduce_tensor(t)) == 2.5  # the single-process fallback: the mean
    assert eng.data_parallel(len) is len
    args = eng.parser.parse_args(["-d", "0,1"])
    assert args.devices == "0,1"


def test_engine_over_a_group(port_ranks):
    """Two ranks: the Engine reports the world and all_reduce_tensor is the
    ranks' mean (the sum with norm=False), the reference's engine.py:57-58."""
    for r, (world, local, mean, total) in enumerate(x["engine"] for x in port_ranks):
        assert (world, local) == (2, r)
        assert torch.equal(mean, torch.tensor([2.0, 4.0]))
        assert torch.equal(total, torch.tensor([4.0, 8.0]))


@pytest.mark.parametrize("batch_size,world", [(1, 2), (2, 2), (1, 3), (2, 1)])
def test_host_batches_split_the_stream_by_rank(amos_root, batch_size, world):
    """AMOSDataset.batches(rank=r, world=n), with crop, mirror, zoom and the
    intensity augmentation on, yields batch i of the one-rank stream where
    i % n == r, bit for bit, without an incomplete last group (the JAX
    loop's grouping, loop.py:171-180), over 2 epochs."""
    def stream(**kw):
        ds = AMOSDataset(os.path.join(amos_root, "imagesTr"), crop_size=(24, 32, 32),
                         usage="train", atlas=np.load(os.path.join(amos_root, "atlas_mm.npy")),
                         seed=5, mirror=True, scale=True)
        return ds, list(ds.batches(batch_size, epochs=2, **kw))

    ds, whole = stream()
    per_epoch = len(ds) // batch_size
    keep = per_epoch // world * world
    assert keep > 0
    for r in range(world):
        _, got = stream(rank=r, world=world)
        want = [b for e in range(2) for i, b in enumerate(whole[e * per_epoch:(e + 1) * per_epoch])
                if i < keep and i % world == r]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), k


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of mpl-train-torch --mesh data:2 (gloo, --device cpu) at the
    evaluator's widths on 32^3 patches: both ranks' final states and the
    snapshot directory."""
    root = str(tmp_path_factory.mktemp("amos_mesh"))
    img_dir, atlas_path, csv_path = make_synthetic_amos(root, n_ct=3, n_mri=1,
                                                        shape=(40, 40, 36), seed=2,
                                                        spread_ids=False)
    data = ["--data_dir", img_dir, "--atlas_path", atlas_path]
    snap = os.path.join(root, "snap")
    argv = data + ["--supervision_csv", csv_path, "--input_size", "32,32,32", "--bf16", "false",
                   "--num_epochs", "1", "--random_scale", "false", "--disc_depth", "5",
                   "--log_every", "1", "--snapshot_dir", snap, "--device", "cpu",
                   "--mesh", "data:2"]
    states = spawn.run(spawn.dp_train, 2, argv)
    return states, snap, data


def test_train_cli_mesh_runs_and_rank_0_writes(trained):
    """Both ranks end in the same state; the snapshot holds what one writer
    writes: one JSONL record per step and the checkpoint; the checkpoint
    holds the ranks' state."""
    import json

    states, snap, _ = trained
    assert spawn.states_unequal(*states) == []
    steps = int(states[0].step)
    assert steps == 1  # 2 train cases, batch 1 per rank, 2 ranks
    with open(os.path.join(snap, "train.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if "loss" in r] == [1]
    assert [r["epoch/patches_per_sec"] > 0 for r in recs if "epoch/epoch_loss" in r] == [True]
    assert sorted(f for f in os.listdir(snap) if not f.startswith("events.out")) == [
        "ckpt_1.pt", "train.jsonl"]
    assert len([f for f in os.listdir(snap) if f.startswith("events.out")]) <= 1
    from multimodal_pl_tpu_torch.train.checkpoint import restore_checkpoint

    assert spawn.states_unequal(restore_checkpoint(latest_checkpoint(snap)), states[0]) == []


@pytest.fixture(scope="module")
def mesh_eval(trained, tmp_path_factory):
    """mpl-evaluate-torch on the data-parallel run's checkpoint, without
    --mesh in this process and with --mesh data:2 under torchrun
    --standalone --nproc_per_node 2 (gloo through torchrun's own
    rendezvous): both output directories and torchrun's stdout."""
    _, snap, data = trained
    out = tmp_path_factory.mktemp("mesh_eval")
    common = data + ["--reload_path", latest_checkpoint(snap), "--input_size", "32,32,32",
                     "--bf16", "false", "--device", "cpu", "--usage", "train", "--print", "true"]
    one, two = str(out / "one"), str(out / "two")
    evaluate.main(common + ["--save_path", one])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "multimodal_pl_tpu_torch.cli.evaluate", *common, "--save_path", two,
           "--mesh", "data:2"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=str(out), env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return one, two, proc.stdout


def test_evaluate_cli_mesh_on_the_mesh_checkpoint(mesh_eval):
    """mpl-evaluate-torch loads the checkpoint of the data-parallel run;
    with --mesh data:2 it writes the label maps of the run without --mesh,
    agreeing on >= 0.9999 of the voxels (the ranks' partial sums add in
    another order)."""
    one, two, _ = mesh_eval
    maps = sorted(f for f in os.listdir(one) if f.endswith("_pred.nii.gz"))
    assert len(maps) == 2 and maps == sorted(f for f in os.listdir(two)
                                             if f.endswith("_pred.nii.gz"))
    for f in maps:
        a, b = read_nifti(os.path.join(one, f)).data, read_nifti(os.path.join(two, f)).data
        assert np.mean(a == b) >= 0.9999


def test_evaluate_cli_mesh_under_torchrun(mesh_eval):
    """Under torchrun with --mesh data:2, rank 0 alone prints and writes
    the one CSV (a header and a row per case)."""
    _, two, stdout = mesh_eval
    assert stdout.count("per-case CSV:") == 1
    with open(os.path.join(two, "per_case_dice.csv")) as f:
        rows = list(csv.reader(f))
    assert len(rows) == 3 and rows[0][0] == "case"
