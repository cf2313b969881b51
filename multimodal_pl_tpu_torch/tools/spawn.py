"""Spawned data-parallel ranks on one host, for tests and ``chip_smoke.py``.

:func:`run` starts ``world`` processes (``torch.multiprocessing``, spawn),
makes each rank r of a ``torch.distributed`` group over a ``FileStore`` in a
temporary directory (no TCP port, so parallel test workers never race for
one), sets ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` as ``torchrun`` would, calls
a function of this package with the given arguments, and returns each rank's
return value in rank order. A rank that raises or dies ends the others and
raises in the caller; a run past ``timeout`` seconds is ended and raises.

The functions a rank runs live in the package, never in ``tests/``: a child
that unpickled a test module's function would import it, and with it
``tests/conftest.py``, which imports JAX. Arguments and results go through
files written with ``torch.save`` in the run's temporary directory (CPU
tensors; a rank moves what it needs to its device).

The rank functions below: the data-parallel train step on each rank's
batch (with the kernels' launch counts), the token EMA over a group, the
Engine's reduction, the sharded predictor, the trainer CLI's ``main``, the
H-split (``space``) forward, predictor and train step, the evaluator CLI's
``main``, and a list of such calls in one spawn. :func:`states_unequal` lists the leaves
in which two train states differ; :func:`reference_step` is
the in-process reference of the data-parallel step: per-batch gradients
averaged as ``(g0 + g1) / 2``, the updates and guards of the step, the token
EMA from the summed class statistics.
"""

from __future__ import annotations

import functools
import operator
import os
import tempfile
import time
from collections import Counter

import torch
import torch.distributed as dist


def run(fn, world: int, *args, backend: str = "gloo", timeout: float = 600.0) -> list:
    """``fn(*args)`` on each of ``world`` spawned ranks; their return values.
    Each rank takes the caller's count of torch CPU threads and its TF32
    switches (cuDNN and matmul), so a rank sums as the caller does."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        torch.save((fn, args), os.path.join(tmp, "call.pt"))
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        ctx = mp.start_processes(_rank_main,
                                 args=(world, tmp, backend, torch.get_num_threads(), tf32),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{fn.__name__} on {world} ranks ran past {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def _rank_main(rank: int, world: int, tmp: str, backend: str, threads: int, tf32) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    if backend == "gloo":
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank is on this host
    torch.set_num_threads(threads)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    fn, args = torch.load(os.path.join(tmp, "call.pt"), weights_only=False)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    try:
        torch.save(fn(*args), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _cpu(state):
    from multimodal_pl_tpu_torch.train.state import map_state

    return map_state(lambda t: t.detach().cpu(), state)


def _launch_counts() -> dict:
    from multimodal_pl_tpu_torch.ops import conv3x3, gn_relu, norm, resize

    return {"conv3x3": Counter(conv3x3.launches), "gn_relu": Counter(gn_relu.launches),
            "gn_relu_backward": Counter(gn_relu.bwd_launches),
            "fold": Counter(norm.fold_launches), "resize": Counter(resize.launches),
            "resize_backward": Counter(resize.bwd_launches),
            "gn_moments": Counter(gn_relu.moments_launches),
            "gn_apply": Counter(gn_relu.apply_launches),
            "gn_bwd_sums": Counter(gn_relu.bwd_sums_launches),
            "gn_bwd_dx": Counter(gn_relu.bwd_dx_launches)}


def _reset_launch_counts() -> None:
    from multimodal_pl_tpu_torch.ops import conv3x3, gn_relu, norm, resize

    conv3x3.reset_launches()
    gn_relu.reset_launches()
    norm.fold_launches.clear()
    resize.reset_launches()


def states_unequal(a, b) -> list:
    """The leaves of train states a and b that differ in any bit."""
    bad = [f"{g}.{k}" for g in ("params", "rparams", "dparams", "tokens")
           for k in getattr(a, g) if not torch.equal(getattr(a, g)[k], getattr(b, g)[k])]
    bad += [f"momentum{i}.{k}" for i in range(2) for k in a.momentum[i]
            if not torch.equal(a.momentum[i][k], b.momentum[i][k])]
    return bad + [k for k in ("step", "epoch") if not torch.equal(getattr(a, k), getattr(b, k))]


def collective_times(trees, reps: int = 20) -> list:
    """Device ms of the step's own average (``train.step.tree_apply`` with
    ``pmean`` over the default group) of each name -> tensor dict list of
    ``trees`` (CUDA tensors), the median of ``reps`` runs timed with CUDA
    events: the ``pmean`` calls (all_reduce and divide, one per dtype) and
    the rest of it (flatten and unflatten); and each buffer's MB."""
    import numpy as np

    from multimodal_pl_tpu_torch.train.step import pmean, tree_apply

    out = []
    for tensors in trees:
        times = {"all_reduce": [], "flatten_unflatten": []}
        for _ in range(reps + 2):
            marks = []

            def timed(flat):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                mean = pmean(flat, dist.group.WORLD)
                ev[1].record()
                marks.append(ev)
                return mean

            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            tree_apply(tensors, timed)
            end.record()
            torch.cuda.synchronize()
            reduce_ms = sum(a.elapsed_time(b) for a, b in marks)
            times["all_reduce"].append(reduce_ms)
            times["flatten_unflatten"].append(start.elapsed_time(end) - reduce_ms)
        leaves = [t for tree in tensors for t in tree.values()]
        out.append({"mb": sum(t.numel() * t.element_size() for t in leaves) / 1e6,
                    "leaves": len(leaves),
                    **{k + "_ms": float(np.median(v[2:])) for k, v in times.items()}})
    return out


def grad_trees(state):
    """Tensors shaped as the step's two averaged buffers: (params, rparams)
    gradients; discriminator gradients with the two losses."""
    zeros = lambda tree: {k: torch.zeros_like(v) for k, v in tree.items()}  # noqa: E731
    loss = state.params[next(iter(state.params))].new_zeros(())
    return [[zeros(state.params), zeros(state.rparams)],
            [zeros(state.dparams), {"d": loss, "t": loss.clone()}]]


def dp_step(cfg, state, batches, lr, wf, device="cpu", time_reps: int = 0):
    """Rank r: one data-parallel step (``make_sharded_train_step`` over the
    default group) from ``state`` on ``batches[r]``, on ``device``. Returns
    (new state on the CPU, metrics as floats, the kernels' launch counts of
    the step); with ``time_reps`` (CUDA only), also
    :func:`collective_times` of the step's buffers."""
    from multimodal_pl_tpu_torch.parallel.sharded_step import make_sharded_train_step
    from multimodal_pl_tpu_torch.train.state import build_models

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    step = make_sharded_train_step(*(m.to(device) for m in build_models(cfg)), cfg,
                                   dist.group.WORLD)
    batch = {k: v.to(device) for k, v in batches[dist.get_rank()].items()}
    state = state.to(device)
    _reset_launch_counts()
    new, metrics = step(state, batch, torch.as_tensor(lr, device=device),
                        torch.as_tensor(wf, device=device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out = (_cpu(new), {k: float(v) for k, v in metrics.items()}, _launch_counts())
    return out + (collective_times(grad_trees(state), time_reps),) if time_reps else out


def dp_renew_tokens(tokens, features, fmasks, alpha):
    """Rank r: ``renew_tokens`` over the default group on ``features[r]``
    and ``fmasks[r]``."""
    from multimodal_pl_tpu_torch.models.tokens import renew_tokens

    r = dist.get_rank()
    return renew_tokens(tokens, features[r], fmasks[r], alpha, group=dist.group.WORLD)


def dp_engine(values):
    """Rank r: the Engine's world size, local rank and
    ``all_reduce_tensor`` of ``values[r]`` (mean and sum) over the default
    group."""
    from multimodal_pl_tpu_torch.engine import Engine

    eng = Engine()
    t = values[dist.get_rank()]
    return (eng.world_size, eng.local_rank, eng.all_reduce_tensor(t),
            eng.all_reduce_tensor(t, norm=False))


def dp_predict(model_kwargs, weights, volumes, tile, runs=(("logits", 2),), device="cpu",
               compute_dtype=torch.float32, bucket=(32, 64, 64)):
    """Rank r: ``ShardedSlidingWindowPredictor`` over the default group with
    a ``UNet3DFEAM(**model_kwargs)`` holding ``weights``, through
    ``predict_iter`` over ``volumes``, once per (output mode, window batch)
    of ``runs``. Returns ({run: rank 0's predictions on the CPU}, None on the
    other ranks), whether every prediction of this rank equals rank 0's bit
    for bit, and {run: this rank's kernel launch counts}."""
    from multimodal_pl_tpu_torch.models import UNet3DFEAM
    from multimodal_pl_tpu_torch.parallel.sharded_infer import ShardedSlidingWindowPredictor

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    model = UNet3DFEAM(**model_kwargs)
    model.load_state_dict(weights)
    model = model.to(device).eval()
    outs, same, launches = {}, True, {}
    for run_key in runs:
        output, window_batch = run_key
        pred = ShardedSlidingWindowPredictor(
            lambda t: model(t, aux=False), tile, model_kwargs.get("num_classes", 14),
            dist.group.WORLD, window_batch=window_batch, output=output, device=device,
            compute_dtype=compute_dtype, bucket=bucket)
        outs[run_key] = []
        _reset_launch_counts()
        for out in pred.predict_iter(volumes):
            launches[run_key] = _launch_counts()
            lead = out.clone()
            dist.broadcast(lead, src=0)
            same = same and torch.equal(lead, out)
            outs[run_key].append(out.cpu())
    return (outs if dist.get_rank() == 0 else None), same, launches


def dp_train(argv):
    """Rank r: ``multimodal_pl_tpu_torch.cli.train.main(argv)``; the final
    train state on the CPU."""
    from multimodal_pl_tpu_torch.cli import train

    return _cpu(train.main(argv))


def _spatial_model(name, model_kwargs, weights, device, space):
    from multimodal_pl_tpu_torch import models

    net = getattr(models, name)(**model_kwargs, space=space)
    net.load_state_dict(weights)
    return net.to(device).eval()


def _on(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def span_ms(spans) -> dict:
    """Stream ms summed per tag of a SpatialGroup's (tag, start, end) CUDA
    events (synchronizes), and the number of spans per tag."""
    torch.cuda.synchronize()
    out = Counter()
    for tag, start, end in spans:
        out[tag + "_ms"] += start.elapsed_time(end)
        out[tag + "_n"] += 1
    return dict(out)


def sp_forward(model_kwargs, weights, x, device="cpu", name="UNet3DFEAM", timed=False,
               prepare=None):
    """Rank r: the H-split forward of ``name(**model_kwargs)`` built with a
    SpatialGroup over the default group and holding ``weights``, through
    ``make_spatial_apply`` on this rank's slab of ``x``
    (the FEAM with aux=False); ``prepare(model, space)``, if given, first
    (``tools/spatial_fault.py`` plants its fault so). Returns (the whole
    output on the CPU, the kernels' launch counts, the exchanges by kind and
    shape, and with ``timed`` the stream ms of the halo exchanges, copies and
    statistics gathers (:func:`span_ms`))."""
    from multimodal_pl_tpu_torch.parallel import spatial

    device = _on(device)
    space = spatial.SpatialGroup.of(dist.group.WORLD, spans=[] if timed else None)
    net = _spatial_model(name, model_kwargs, weights, device, space)
    if prepare is not None:
        prepare(net, space)
    fwd = spatial.make_spatial_apply(net, space)
    xs = spatial.put_spatial(x.to(device), space)
    kw = {"aux": False} if name == "UNet3DFEAM" else {}
    fwd(xs, **kw)  # warm-up (the kernels' first launches)
    if timed:
        span_ms(space.spans)
        space.spans.clear()
    _reset_launch_counts()
    spatial.reset_exchanges()
    y = fwd(xs, **kw)
    out = (y.cpu(), _launch_counts(), Counter(spatial.exchanges))
    return out + (span_ms(space.spans),) if timed else out


def sp_predict(model_kwargs, weights, volumes, tile, runs, device="cpu",
               compute_dtype=torch.float32, bucket=(32, 64, 64)):
    """Rank r: ``SpatialSlidingWindowPredictor`` over the default group with
    a ``UNet3DFEAM(**model_kwargs)`` built with that SpatialGroup and
    holding ``weights``, through ``predict_iter`` over ``volumes``, once per
    (tta, output, window batch) of ``runs``. Returns ({run: rank 0's
    predictions on the CPU}, None on the other ranks), whether every
    prediction equals rank 0's bit for bit, {run: this rank's kernel launch
    counts and exchanges of the last volume}, {run: seconds per volume, the
    predictor's own (host clock; the check against rank 0 and the copy to
    the CPU left out)} and {run: the stream ms per volume of its halo
    exchanges, copies, moment gathers and accumulator merges, on a CUDA
    device (:func:`span_ms`)}."""
    from multimodal_pl_tpu_torch.parallel import spatial

    device = _on(device)
    cuda = torch.device(device).type == "cuda"
    space = spatial.SpatialGroup.of(dist.group.WORLD, spans=[] if cuda else None)
    net = _spatial_model("UNet3DFEAM", model_kwargs, weights, device, space)
    outs, same, launches, secs, spans = {}, True, {}, {}, {}
    for run_key in runs:
        tta, output, window_batch = run_key
        pred = spatial.SpatialSlidingWindowPredictor(
            lambda t: net(t, aux=False), tile, model_kwargs.get("num_classes", 14), space,
            window_batch=window_batch, tta=tta, output=output, device=device,
            compute_dtype=compute_dtype, bucket=bucket)
        outs[run_key] = []
        _reset_launch_counts()
        spatial.reset_exchanges()
        if cuda:
            space.spans.clear()
        it, busy = pred.predict_iter(volumes), 0.0
        while True:
            t0 = time.perf_counter()
            out = next(it, None)  # each volume computes in its own step
            if out is None:
                break
            if cuda:
                torch.cuda.synchronize()
            busy += time.perf_counter() - t0
            launches[run_key] = (_launch_counts(), Counter(spatial.exchanges))
            _reset_launch_counts()
            spatial.reset_exchanges()
            lead = out.clone()
            dist.broadcast(lead, src=0)
            same = same and torch.equal(lead, out)
            outs[run_key].append(out.cpu())
        secs[run_key] = busy / len(volumes)
        if cuda:
            spans[run_key] = {k: v / len(volumes) if k.endswith("_ms") else v // len(volumes)
                              for k, v in span_ms(space.spans).items()}
    return (outs if dist.get_rank() == 0 else None), same, launches, secs, spans


def sp_step(cfg, state, batch, lr, wf, device="cpu", prepare=None, peak=False):
    """Rank r: one spatial train step (``make_spatial_train_step`` over the
    default group as a SpatialGroup) from ``state`` on this rank's
    ``spatial_batch`` of ``batch``, on ``device``; ``prepare(step, space)``,
    if given, first (``tools/spatial_fault.py`` plants its faults so; what it
    returns, if anything, is called after the step to undo it).
    Returns (new state on the CPU, metrics as floats, the kernels' launch
    counts, the exchanges by kind and shape, and with ``peak`` this rank's
    peak GiB (CUDA; NaN on the CPU) and wall ms (synchronized) of a second
    step from the same state, the one whose calls are counted)."""
    from multimodal_pl_tpu_torch.parallel import spatial
    from multimodal_pl_tpu_torch.train.state import build_models

    device = _on(device)
    space = spatial.SpatialGroup.of(dist.group.WORLD)
    model, refiner, disc = (m.to(device) for m in build_models(cfg, space=space))
    step = spatial.make_spatial_train_step(model, refiner, disc, cfg, space)
    undo = prepare(step, space) if prepare is not None else None
    part = {k: v.to(device) for k, v in spatial.spatial_batch(batch, space).items()}
    state = state.to(device)
    lr, wf = torch.as_tensor(lr, device=device), torch.as_tensor(wf, device=device)
    cuda = device.type == "cuda"
    if peak:  # a first step builds what later ones reuse; the second is measured
        step(state, part, lr, wf)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
    _reset_launch_counts()
    spatial.reset_exchanges()
    t0 = time.perf_counter()
    new, metrics = step(state, part, lr, wf)
    if peak:
        if cuda:
            torch.cuda.synchronize(device)
        measured = (torch.cuda.max_memory_allocated(device) / 2**30 if cuda else float("nan"),
                    (time.perf_counter() - t0) * 1e3)
    out = (_cpu(new), {k: float(v) for k, v in metrics.items()}, _launch_counts(),
           Counter(spatial.exchanges))
    if undo is not None:
        undo()
    return out + measured if peak else out


def sp_grads(cfg, state, batch, wf, device="cpu", prepare=None, float64=False):
    """Rank r: the gradient pass of the spatial train step
    (``TrainStep.summed_grads``: the segmenter's gradients summed over the
    ranks) from ``state`` on this rank's ``spatial_batch`` of ``batch``;
    ``prepare`` as in :func:`sp_step`. ``float64``: the step in double
    precision (state, batch and every f32 cast of the step, through
    ``Tensor.float``; ``cfg`` a plain route). Returns (total loss,
    {'params.' / 'rparams.' + leaf: gradient on the CPU, f32 or f64})."""
    import dataclasses

    from multimodal_pl_tpu_torch.parallel import spatial
    from multimodal_pl_tpu_torch.train.state import build_models, map_state

    device = _on(device)
    space = spatial.SpatialGroup.of(dist.group.WORLD)
    real_float, default = torch.Tensor.float, torch.get_default_dtype()
    if float64:
        torch.Tensor.float = lambda self, *a, **k: self.double()
        torch.set_default_dtype(torch.float64)
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float64)
        state = map_state(lambda t: t.double() if t.is_floating_point() else t, state)
        batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    try:
        model, refiner, disc = (m.to(device) for m in build_models(cfg, space=space))
        step = spatial.make_spatial_train_step(model, refiner, disc, cfg, space)
        undo = prepare(step, space) if prepare is not None else None
        part = {k: v.to(device) for k, v in spatial.spatial_batch(batch, space).items()}
        total, (gp, gr), _ = step.summed_grads(state.to(device), part,
                                                    torch.as_tensor(wf, device=device))
        keep = (lambda g: g.detach().cpu()) if float64 else (lambda g: g.detach().float().cpu())
        out = (float(total), {**{"params." + k: keep(g) for k, g in gp.items()},
                              **{"rparams." + k: keep(g) for k, g in gr.items()}})
        if undo is not None:
            undo()
    finally:
        torch.Tensor.float = real_float
        torch.set_default_dtype(default)
    return out


def sp_exchange_grads(x, cases):
    """Rank r: each differentiable exchange of a SpatialGroup over the
    default group on this rank's H slab of ``x``, and the gradient that
    reaches the slab from a loss sum(out * w) (w: the case's weights of this
    rank's output, or of the whole output when every rank computes the same
    loss). Cases: ('halo', lo, hi, edge, ws) with ws[r] the weights of rank
    r's extended slab; ('crop', start, rows, ws, adds): the crop of rows
    [start, start + rows) of the slab plus adds[r], and the gradients of
    both; ('gather', w); ('sum', w): the sum over the ranks of the slab's sum
    over H. Returns the gradients in case order."""
    from multimodal_pl_tpu_torch.parallel import spatial

    space = spatial.SpatialGroup.of(dist.group.WORLD)
    r = space.rank
    out = []
    for case in cases:
        xs = spatial.put_spatial(x, space).requires_grad_(True)
        kind = case[0]
        if kind == "halo":
            _, lo, hi, edge, ws = case
            y, w, inputs = space.halo_rows(xs, lo, hi, edge)[0], ws[r], (xs,)
        elif kind == "crop":
            _, start, rows, ws, adds = case
            add = adds[r].clone().requires_grad_(True)
            y, w, inputs = space.crop_rows(xs, start, rows, add), ws[r], (xs, add)
        elif kind == "gather":
            y, w, inputs = space.gather_rows(xs), case[1], (xs,)
        else:
            y, w, inputs = space.sum(xs.sum(spatial.H_AXIS)), case[1], (xs,)
        out.append(torch.autograd.grad((y * w).sum(), inputs))
    return out


def sp_halo_merge(x, cases, groups: int):
    """Rank r: ``halo_rows`` of this rank's H slab of ``x`` for each (lo,
    hi, edge) of ``cases`` (the extended slab and the rows attached below),
    and ``merge_group_stats`` of the slab's moments in ``groups`` groups."""
    from multimodal_pl_tpu_torch.ops.gn_relu import group_moments_reference
    from multimodal_pl_tpu_torch.parallel import spatial

    space = spatial.SpatialGroup.of(dist.group.WORLD)
    xs = spatial.put_spatial(x, space)
    halos = [space.halo_rows(xs, lo, hi, edge) for lo, hi, edge in cases]
    count = float(xs.numel() // (xs.shape[0] * groups))
    return halos, spatial.merge_group_stats(group_moments_reference(xs, groups), space, count)


def sp_sendrecv(shape, device="cpu", reps: int = 10) -> dict:
    """Rank r: a bf16 tensor of ``shape`` (one boundary row's worth) sent to
    each neighbour in H order and theirs received, by
    ``dist.batch_isend_irecv``, beside the ``all_gather`` of every rank's
    rows that ``SpatialGroup.halo_rows`` makes. Returns {'ok': the received
    rows are the neighbours', 'error': what the backend raised, or None,
    'p2p_ms', 'all_gather_ms': host-clock medians of ``reps`` calls, each
    synchronized}."""
    device = _on(device)
    r, n = dist.get_rank(), dist.get_world_size()
    peers = [p for p in (r - 1, r + 1) if 0 <= p < n]
    x = torch.full(shape, float(r), device=device, dtype=torch.bfloat16)
    bufs = [torch.empty_like(x) for _ in peers]
    gathered = [torch.empty_like(x) for _ in range(n)]

    def p2p():
        ops = [dist.P2POp(dist.isend, x, p) for p in peers]
        ops += [dist.P2POp(dist.irecv, b, p) for b, p in zip(bufs, peers)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    def median_ms(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            if x.is_cuda:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2]

    out = {"ok": False, "error": None, "p2p_ms": None,
           "all_gather_ms": median_ms(lambda: dist.all_gather(gathered, x))}
    try:
        p2p()
        if x.is_cuda:
            torch.cuda.synchronize()
        out["ok"] = all(torch.equal(b, torch.full_like(b, float(p))) for b, p in zip(bufs, peers))
        out["p2p_ms"] = median_ms(p2p)
    except Exception as e:  # noqa: BLE001 - what the backend raises is the answer
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def cli_evaluate(argv):
    """Rank r: ``multimodal_pl_tpu_torch.cli.evaluate.main(argv)``; the CSV's
    path."""
    from multimodal_pl_tpu_torch.cli import evaluate

    return evaluate.main(argv)


def dp_calls(calls):
    """Rank r: each ``(function, args)`` of ``calls`` in turn, in one group
    (one spawn for several cases); their results."""
    return [fn(*args) for fn, args in calls]


def _sum(ts):
    return functools.reduce(operator.add, ts)


def reference_step(step, state, batches, lr, wf):
    """The data-parallel step of ``len(batches)`` ranks in one process, from
    the single-device step's parts: ``step.grads``/``step.disc_grads`` per
    batch, averaged as ``(g0 + g1 + ...) / n``, then the step's updates and
    guards; the token EMA from the class sums and counts summed over the
    batches. Returns (new state, {'loss', 'disc_loss'}: the means)."""
    from multimodal_pl_tpu_torch.models.tokens import agreement_mask, masked_class_sums
    from multimodal_pl_tpu_torch.ops.resize import resize_nearest
    from multimodal_pl_tpu_torch.train.state import (
        all_finite,
        fresh_adam_update,
        select_tree,
        torch_sgd_update,
    )
    from multimodal_pl_tpu_torch.train.step import poly_lr

    cfg, n = step.cfg, len(batches)

    def mean(trees):
        return {k: _sum([t[k] for t in trees]) / n for k in trees[0]}

    outs = [step.grads(state, b, wf) for b in batches]
    gp = mean([o[1][0] for o in outs])
    gr = mean([o[1][1] for o in outs])
    g_ok = all_finite(gp) & all_finite(gr)
    new_p, new_bp = torch_sgd_update(state.params, gp, state.momentum[0], lr, cfg.momentum,
                                     cfg.weight_decay)
    new_r, new_br = torch_sgd_update(state.rparams, gr, state.momentum[1], lr, cfg.momentum,
                                     cfg.weight_decay)
    disc = [step.disc_grads(state, o[2], b) for o, b in zip(outs, batches)]
    dg = mean([d[1] for d in disc])
    disc_lr = poly_lr(cfg.disc_lr, state.epoch, cfg.num_epochs)
    dparams = select_tree(all_finite(dg), fresh_adam_update(state.dparams, dg, disc_lr),
                          state.dparams)

    tokens = dict(state.tokens)
    fmasks = [agreement_mask(o[2]["cmask"], o[2]["logits"].argmax(dim=-1), b["sup_mask"])
              for o, b in zip(outs, batches)]
    for j, (name, tok) in enumerate(state.tokens.items()):
        stats = []
        for o, fm in zip(outs, fmasks):
            x = o[2]["feats"][j].detach()
            m = resize_nearest(fm[..., None].to(x.dtype), x.shape[1:4])[..., 0]
            stats.append(masked_class_sums(x, m, tok.shape[0]))
        sums, counts = _sum([s for s, _ in stats]), _sum([c for _, c in stats])
        means = (sums / torch.clamp(counts.float(), min=1.0)[:, None]).to(x.dtype)
        upd = tok * (1.0 - cfg.token_alpha) + cfg.token_alpha * means.to(tok.dtype)
        tokens[name] = torch.where((counts > 0)[:, None], upd, tok)
    tokens = select_tree(all_finite(tokens), tokens, state.tokens)

    new = state.replace(
        params=select_tree(g_ok, new_p, state.params),
        rparams=select_tree(g_ok, new_r, state.rparams), dparams=dparams,
        momentum=(select_tree(g_ok, new_bp, state.momentum[0]),
                  select_tree(g_ok, new_br, state.momentum[1])),
        tokens=tokens, step=state.step + 1)
    return new, {"loss": _sum([o[0] for o in outs]) / n,
                 "disc_loss": _sum([d[0] for d in disc]) / n}
