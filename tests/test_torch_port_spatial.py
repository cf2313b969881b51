"""The port's spatial parallelism for serving (multimodal_pl_tpu_torch.parallel.spatial,
``--mesh space:N``) against the JAX package's GSPMD version, on the CPU.

Spawned ranks run over gloo (``tools/spawn.py``; the rank functions live in
the package), f32 with the plain versions of the kernels. The JAX side runs
on a space:2 CPU mesh (tests/conftest.py forces 8 host devices) with the
same weights, carried by ``convert.state_dict_from_jax``.

Tolerances: the sharded forward and predictor against JAX at the JAX
package's own (rtol 2e-4, atol 1e-5; tests/test_parallel.py); halo rows
exact; merged GroupNorm statistics within 1e-6 (relative) of the whole
tensor's; a group of one rank bit-equal to the single predictor; the CLI's
dice within 1e-4. A zeroed halo (tools/spatial_fault.py) must miss the
forward tolerance by more than 10x.
"""

import csv
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_pl_tpu.infer.sliding import SlidingWindowPredictor as JPredictor
from multimodal_pl_tpu.models import UNet3DFEAM as JUNet3DFEAM
from multimodal_pl_tpu.models import init_class_tokens as jinit_class_tokens
from multimodal_pl_tpu.parallel.mesh import make_mesh as jmake_mesh
from multimodal_pl_tpu.parallel.spatial import make_spatial_apply as jmake_spatial_apply
from multimodal_pl_tpu.parallel.spatial import put_spatial as jput_spatial
from multimodal_pl_tpu.parallel.spatial import spatial_sharding
from multimodal_pl_tpu_torch.cli import evaluate, train
from multimodal_pl_tpu_torch.convert import save_npz, state_dict_from_jax
from multimodal_pl_tpu_torch.infer.sliding import SlidingWindowPredictor
from multimodal_pl_tpu_torch.models import (
    UNet3DBaseline,
    UNet3DDeepSup,
    UNet3DDynHead,
    UNet3DEAM,
    UNet3DFEAM,
)
from multimodal_pl_tpu_torch.ops.gn_relu import group_moments_reference, merge_moments
from multimodal_pl_tpu_torch.parallel import spatial
from multimodal_pl_tpu_torch.tools import spawn, spatial_fault
from multimodal_pl_tpu_torch.utils.synthetic import make_synthetic_amos

from tests.conftest import cpu_devices

torch.set_num_threads(2)

NC = 14
X_SHAPE = (1, 16, 32, 32, 1)
TILE = (16, 32, 32)
VOL = (16, 48, 48)
BUCKET = (16, 16, 16)
RTOL, ATOL = 2e-4, 1e-5
# the predictor runs: (tta, output, window batch)
RUNS = ((False, "logits", 2), (True, "logits", 2))
HALO_CASES = ((1, 1, None), (1, 1, "zero"), (1, 1, "repeat"), (1, 0, "zero"), (2, 1, "repeat"))
FAULTS = ("layer0.0", "layer4.1")  # the first block at full resolution, the last at 1/16


class _Ranks:
    """A fake two-rank group for code that needs only rank and world."""

    def __init__(self, rank, world):
        self.rank, self.world = rank, world


@pytest.fixture(scope="module")
def jax_side():
    """The JAX flagship (tests/test_parallel.py's spatial tests: default
    widths, deep_up=False), its params and tokens, its unsharded and
    space:2-sharded forwards of one seeded 1 x 16 x 32 x 32 input, and the
    JAX predictor with each window's H split over space:2, with and without
    flip TTA, on a 16 x 48 x 48 volume."""
    model = JUNet3DFEAM(num_classes=NC, weight_std=True, deep_up=False)
    tokens = jinit_class_tokens(jax.random.PRNGKey(1), NC)
    x = np.random.default_rng(0).standard_normal(X_SHAPE).astype(np.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x), tokens)

    def fwd(params, x, tokens):
        return model.apply(params, x, tokens)[0]

    mesh = jmake_mesh("space:2", cpu_devices(2))
    want = np.asarray(jax.jit(fwd)(params, jnp.asarray(x), tokens))
    sharded = np.asarray(jmake_spatial_apply(fwd, mesh)(params, jput_spatial(jnp.asarray(x), mesh),
                                                        tokens))

    def tile_fwd(tiles, params, tokens):
        return model.apply(params, tiles, tokens)[0]

    vol = np.random.default_rng(1).standard_normal(VOL).astype(np.float32)
    preds = {run: np.asarray(JPredictor(tile_fwd, TILE, NC, window_batch=run[2], tta=run[0],
                                        bucket=BUCKET, tile_sharding=spatial_sharding(mesh))(
        vol, params, tokens)) for run in RUNS}
    return {"weights": state_dict_from_jax(params), "x": x, "want": want,
            "sharded": sharded, "vol": vol, "preds": preds}


def _model(weights, **kw):
    model = UNet3DFEAM(num_classes=NC, deep_up=False, **kw)
    model.load_state_dict(weights)
    return model.eval()


@pytest.fixture(scope="module")
def port_ranks(jax_side):
    """One spawn of two gloo ranks: the H-split forward (plain, f32), the
    spatial predictor with and without TTA, and the forward with rank 1's low
    halo zeroed at each block of FAULTS."""
    kw = {"num_classes": NC, "deep_up": False}
    x = torch.from_numpy(jax_side["x"])
    calls = [(spawn.sp_forward, (kw, jax_side["weights"], x)),
             (spawn.sp_predict, (kw, jax_side["weights"], [jax_side["vol"]], TILE, RUNS, "cpu",
                                 torch.float32, BUCKET))]
    calls += [(spawn.sp_forward, (kw, jax_side["weights"], x, "cpu", "UNet3DFEAM", False,
                                  functools.partial(spatial_fault.zero_low_halo, rank=1,
                                                    module=m))) for m in FAULTS]
    return spawn.run(spawn.dp_calls, 2, calls, timeout=300)


def test_sharded_forward_matches_jax(jax_side, port_ranks):
    """make_spatial_apply on 2 ranks equals JAX's space:2 GSPMD forward and
    JAX's unsharded forward; each rank gathers the whole output; 31 halo
    exchanges (stem 1, 18 stride-1 block convs, 4 stride-2 convs, 4
    prologue-off convs, 4 upsamples) and 35 GroupNorm gathers (18 folds, 17
    GN -> ReLU) per forward."""
    for got, _, exchanges in (r[0] for r in port_ranks):  # each rank's first call
        got = got.numpy()
        assert got.shape == (*X_SHAPE[:4], NC)
        np.testing.assert_allclose(got, jax_side["sharded"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, jax_side["want"], rtol=RTOL, atol=ATOL)
        halos = sum(n for k, n in exchanges.items() if k[0] == "halo")
        stats = sum(n for k, n in exchanges.items() if k[0] == "stats")
        assert (halos, stats) == (31, 35)


def test_sharded_forward_equals_the_port_unsharded(jax_side, port_ranks):
    """The two ranks' gathered logits equal the port's single forward up to
    f32 summation order (the plain route: <= 1e-5 relative L2)."""
    with torch.no_grad():
        single = _model(jax_side["weights"])(torch.from_numpy(jax_side["x"]), aux=False)
    got = port_ranks[0][0][0]
    assert torch.equal(got, port_ranks[1][0][0])
    assert ((got - single).norm() / single.norm()).item() <= 1e-5


@pytest.mark.parametrize("fault", range(len(FAULTS)), ids=FAULTS)
def test_zeroed_halo_fails_by_more_than_10x(jax_side, port_ranks, fault):
    """The check bites: rank 1's low halo rows zeroed at one block (the
    first at full resolution, the last at 1/16) move the logits more than 10
    times past the forward tolerance."""
    got = port_ranks[0][2 + fault][0].numpy()
    want = jax_side["want"]
    excess = np.abs(got - want) / (ATOL + RTOL * np.abs(want))
    assert excess.max() > 10


def test_spatial_predictor_matches_jax_and_single(jax_side, port_ranks):
    """SpatialSlidingWindowPredictor on 2 ranks, with and without flip TTA,
    equals JAX's SlidingWindowPredictor(tile_sharding=spatial_sharding) and
    the port's single predictor; both ranks return the same bits."""
    outs, same0 = port_ranks[0][1][:2]
    same1 = port_ranks[1][1][1]
    assert same0 and same1
    model = _model(jax_side["weights"])
    for run in RUNS:
        got = outs[run][0].numpy()
        np.testing.assert_allclose(got, jax_side["preds"][run], rtol=RTOL, atol=ATOL)
        single = SlidingWindowPredictor(lambda t: model(t, aux=False), TILE, NC,
                                        window_batch=run[2], tta=run[0], bucket=BUCKET,
                                        device="cpu")(jax_side["vol"]).numpy()
        np.testing.assert_allclose(got, single, rtol=RTOL, atol=ATOL)


def test_space_one_is_the_single_predictor_bit_for_bit(jax_side):
    """A group of one rank: the models take today's path and the predictor
    is the single one, bit for bit (logits and TTA)."""
    space = spatial.SpatialGroup(group=None, rank=0, world=1)
    single_model = _model(jax_side["weights"])
    split_model = _model(jax_side["weights"], space=space)
    vol = jax_side["vol"]
    for tta in (False, True):
        want = SlidingWindowPredictor(lambda t: single_model(t, aux=False), TILE, NC,
                                      window_batch=2, tta=tta, bucket=BUCKET, device="cpu")(vol)
        got = spatial.SpatialSlidingWindowPredictor(
            lambda t: split_model(t, aux=False), TILE, NC, space, window_batch=2, tta=tta,
            bucket=BUCKET, device="cpu")(vol)
        assert torch.equal(got, want)


@pytest.fixture(scope="module")
def halo_ranks():
    """Four gloo ranks: halo_rows and merge_group_stats on their slabs of one
    (2, 3, 8, 5, 32) tensor (2 H rows per rank)."""
    x = torch.randn((2, 3, 8, 5, 32), generator=torch.Generator().manual_seed(4)) * 3 + 7
    return x, spawn.run(spawn.sp_halo_merge, 4, x, HALO_CASES, 8, timeout=120)


def _global_rows(x, r, n, lo, hi, edge):
    """Rows of the whole tensor that rank r's extended slab must hold."""
    s = x.shape[2] // n
    idx, rows_below = [], 0
    for i in range(r * s - lo, (r + 1) * s + hi):
        if 0 <= i < x.shape[2]:
            idx.append(x[:, :, i])
        elif edge == "zero":
            idx.append(torch.zeros_like(x[:, :, 0]))
        elif edge == "repeat":
            idx.append(x[:, :, min(max(i, 0), x.shape[2] - 1)])
        else:
            continue
        rows_below += i < r * s
    return torch.stack(idx, 2), rows_below


def test_halo_rows_are_the_global_rows(halo_ranks):
    """Each rank's extended slab holds the whole tensor's rows around its
    own: zeros or the edge row repeated at a global edge, or nothing; low
    side only for a stride-2 conv's (1, 0) halo."""
    x, ranks = halo_ranks
    for r, (halos, _) in enumerate(ranks):
        for (lo, hi, edge), (ext, below) in zip(HALO_CASES, halos):
            want, want_below = _global_rows(x, r, 4, lo, hi, edge)
            assert below == want_below, (r, lo, hi, edge)
            assert torch.equal(ext, want), (r, lo, hi, edge)


@pytest.mark.parametrize("n", [2, 4])
def test_merged_group_stats_equal_the_whole_tensors(halo_ranks, n):
    """merge_group_stats over 4 ranks, and merge_moments of 2 slabs' moments,
    equal the whole tensor's per-(sample, group) mean and M2 within 1e-6."""
    x, ranks = halo_ranks
    whole = group_moments_reference(x, 8)
    if n == 4:
        merged = ranks[0][1]
        for _, other in ranks[1:]:
            assert torch.equal(other, merged)
    else:
        slabs = x.chunk(2, dim=2)
        count = float(slabs[0].numel() // (x.shape[0] * 8))
        merged = merge_moments(torch.stack([group_moments_reference(s, 8) for s in slabs]),
                               count)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=1e-6)


def test_uneven_split_raises_before_any_work():
    """N must divide H / 16 (the JAX package's GSPMD pads uneven shards
    instead): check_divisible, the predictor and make_spatial_apply raise
    ValueError, the last before the model runs or any rank exchanges."""
    space = _Ranks(0, 3)
    with pytest.raises(ValueError, match="multiple of 16"):
        spatial.check_divisible((16, 32, 32), space)
    with pytest.raises(ValueError, match="multiple of 16"):
        spatial.SpatialSlidingWindowPredictor(lambda t: t, (16, 96, 32), NC, _Ranks(0, 4),
                                              device="cpu")
    spatial.check_divisible((16, 96, 32), space)
    space = _Ranks(0, 2)
    apply = spatial.make_spatial_apply(UNet3DFEAM(num_classes=NC, space=space).eval(), space)
    with pytest.raises(ValueError, match="multiple of 16"):
        apply(torch.zeros((1, 16, 8, 32, 1)), aux=False)


def test_space_splits_h_only():
    """SpatialGroup takes the H axis (JAX _SPATIAL_AXES) and no other."""
    assert spatial.SpatialGroup(group=None, rank=0, world=2).axis == "H"
    with pytest.raises(ValueError, match="H axis only"):
        spatial.SpatialGroup(group=None, rank=0, world=2, axis="W")


def test_unported_parts_raise_under_space():
    """What the spatial port leaves out raises under a split, before any
    exchange: a train step that splits H and the batch both; deep outputs in
    the segmentation loss (no step passes them); GroupNorm without the ReLU
    or the fold (no model reaches it split); the ablations' cross-slab
    softmax and mean under autograd (no step trains them split). The train
    step with deep_up=False raises ValueError split or not, as the JAX step
    fails (tests/test_torch_port_spatial_rest.py). Every model of the family
    builds split, and remat no longer raises."""
    from multimodal_pl_tpu_torch.losses.compose import segmentation_loss
    from multimodal_pl_tpu_torch.train.state import build_models, tiny_step_config
    from multimodal_pl_tpu_torch.train.step import TrainStep

    space = _Ranks(0, 2)
    cfg = tiny_step_config(num_classes=NC)
    with pytest.raises(NotImplementedError, match="not both"):
        TrainStep(*build_models(cfg), cfg, group=object(), space=space)
    for sp in (None, space):
        with pytest.raises(ValueError, match="deep_up=False"):
            TrainStep(*build_models(tiny_step_config(num_classes=NC, deep_up=False)),
                      tiny_step_config(num_classes=NC, deep_up=False), space=sp)
    logits = torch.zeros((1, 2, 4, 2, NC))
    with pytest.raises(NotImplementedError, match="deep outputs"):
        segmentation_loss(logits, torch.zeros((1, 2, 4, 2), dtype=torch.long), torch.ones(NC),
                          (logits,), (), space=space)
    with pytest.raises(NotImplementedError, match="no model reaches it"):
        UNet3DFEAM(num_classes=NC, space=space).layer0[0].gn1(torch.zeros((1, 2, 2, 2, 32)))
    scores = torch.zeros((1, 4, NC, 8), requires_grad=True)
    with pytest.raises(NotImplementedError, match="no step trains"):
        spatial.SpatialGroup(None, 0, 2).softmax_product(scores, torch.zeros((1, 4, 8, 8)))
    with pytest.raises(NotImplementedError, match="no step trains"):
        spatial.SpatialGroup(None, 0, 2).mean(scores, (2, 3))
    for cls in (UNet3DBaseline, UNet3DDeepSup, UNet3DEAM, UNet3DDynHead):
        assert cls(space=space).space is space
    assert TrainStep(*build_models(tiny_step_config(num_classes=NC, remat=True)),
                     tiny_step_config(num_classes=NC, remat=True), space=space).space is space


def test_train_cli_space_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.main(["--mesh", "space:2", "--device", "cpu"])


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """mpl-evaluate-torch on 2 synthetic cases (tests/test_torch_port_entry.py's
    fixture) without --mesh, and on two gloo ranks with --mesh space:2,
    data:1,space:2 and data:2,space:1: {run: the CSV's rows}."""
    tmp = tmp_path_factory.mktemp("spatial_cli")
    img_dir, atlas_path, _ = make_synthetic_amos(str(tmp / "data"), n_ct=8, n_mri=2,
                                                 shape=(40, 40, 24), seed=3, spread_ids=False)
    ckpt = str(tmp / "weights.npz")
    save_npz(ckpt, UNet3DFEAM(generator=torch.Generator().manual_seed(5)).state_dict())

    def argv(name):
        return ["--data_dir", img_dir, "--reload_path", ckpt, "--save_path", str(tmp / name),
                "--input_size", "16,32,32", "--atlas_path", atlas_path, "--window_batch", "9",
                "--bf16", "false", "--device", "cpu"] + (["--mesh", name] if name else [])

    meshes = ("space:2", "data:1,space:2", "data:2,space:1")
    paths = {"": evaluate.main(argv(""))}
    ranks = spawn.run(spawn.dp_calls, 2, [(spawn.cli_evaluate, (argv(m),)) for m in meshes],
                      timeout=300)
    paths.update(zip(meshes, ranks[0]))
    out = {}
    for name, path in paths.items():
        with open(path) as f:
            out[name] = list(csv.reader(f))
    return out


@pytest.mark.parametrize("mesh", ["space:2", "data:1,space:2", "data:2,space:1"])
def test_evaluate_cli_space_writes_the_same_csv(cli_runs, mesh):
    """The per-case CSV with --mesh space:2 (and data:1,space:2, and
    data:2,space:1) is the one without --mesh: the same cases, dice within
    1e-4."""
    want, got = cli_runs[""], cli_runs[mesh]
    assert len(got) == len(want) == 3 and got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a[0] == b[0]
        np.testing.assert_allclose(np.float64(a[1:]), np.float64(b[1:]), rtol=0, atol=1e-4 + 1e-9)
