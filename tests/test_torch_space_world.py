"""Space-parallel worlds on the CPU (parallel/spatial.py), and the sharded
conv halos, norms and collectives in a world of 4 gloo ranks.

The ranks' side of every space-parallel test lives here, free of JAX:
``start_world`` spawns gloo ranks that meet through a ``FileStore`` in a
temporary directory, each running one job of ``JOBS`` on a payload the
test saved, and ``finish_world`` collects every rank's result.
``test_torch_space_raft.py`` / ``_models.py`` / ``_eval.py`` drive the
model's forward and the Evaluator through them.

Here, against the same op in one process on the whole frame:

- every conv of the models by (kernel, stride): 7x7 s2, 3x3 s2 and 1x1
  s2 (the encoders' strided convs, with asymmetric halos), 3x3, 1x1, 7x7
  (the motion encoder's flow conv), 5x1 and 1x5 (the GRU's passes) at
  stride 1, each at a shard of 8 rows (the halo from the next rank) and of
  2 rows (a 3-row halo reaches past it): within 1e-5;
- the instance norm with and without relu, the conv -> instance norm ->
  relu pair (K5 on the rows and a 1-row halo, the moments over the whole
  frame, K4; their plain versions here) and the group norm: within 1e-5;
  the bf16 pair within one bf16 ulp of the statistics of its bf16 conv
  output, which the unsharded pair (fp32 accumulator) is not (pinned);
- ``gather_rows`` and ``halo_rows`` exact in fp32, bf16 (carried as fp32)
  and int64, with zeros beyond the image's edges;
- a height that is not a multiple of 8 * world is refused, naming both;
- outside a shard every helper is the identity (``halo_rows``: zero rows).
"""
import contextlib
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from flow_supervisor_tpu_torch.parallel import spatial

WORLD = 4
# (kernel, stride) of every conv of the models (padding k // 2 a side)
CONVS = [((7, 7), 2), ((3, 3), 2), ((1, 1), 2), ((3, 3), 1), ((1, 1), 1), ((7, 7), 1),
         ((5, 1), 1), ((1, 5), 1)]
ROWS = (8, 2)  # a shard's rows: the halo from the next rank; past it (3 > 2)
LIMIT = 1e-5


# ---- the world -------------------------------------------------------------


@contextlib.contextmanager
def planted(fault):
    """A space-parallel fault planted in this process: ``coords_offset``,
    coords0 without the shard's first row; ``local_pos_rows``, GMA's position
    term indexed by the shard's local rows."""
    from flow_supervisor_tpu_torch.models import gma, raft

    saved = raft.coords_grid, gma.first_row
    if fault == "coords_offset":
        raft.coords_grid = lambda *a, row0=0, **kw: saved[0](*a, **kw)
    elif fault == "local_pos_rows":
        gma.first_row = lambda rows: 0
    try:
        yield
    finally:
        raft.coords_grid, gma.first_row = saved


def _forwards(payload):
    """Each case's (flow_up, flow_low, all-reduces it made) through
    ``spatial_forward``, or the message of the ValueError it raised."""
    from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig

    real, calls = torch.distributed.all_reduce, [0]

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    torch.distributed.all_reduce = counted
    out = []
    for case in payload["cases"]:
        model = RAFT(RAFTConfig(**case["cfg"]))
        model.load_state_dict(case["state"])
        calls[0] = 0
        with planted(case.get("fault")):
            try:
                up, low = spatial.spatial_forward(model, case.get("iters"))(
                    case["image1"], case["image2"], case.get("flow_init"))
                out.append((up, low, calls[0]))
            except ValueError as e:
                out.append(str(e))
    return out


def _ops(payload):
    """The sharded convs, norms and collectives of this file's tests, each
    output gathered whole."""
    from flow_supervisor_tpu_torch.models.encoders import _conv_instnorm_relu

    out = {}
    torch.set_grad_enabled(False)
    for name, module, x in payload["modules"]:
        with shard_of(x.shape[2], x.shape[3]):
            xl = spatial.local_rows(x, dim=2)
            if name.startswith("pair"):
                y = _conv_instnorm_relu(module, xl)
            else:
                y = module(xl)
            out[name] = spatial.gather_rows(y.contiguous(), dim=2)
    for name, x in payload["tensors"]:
        with shard_of(x.shape[1], 1):
            xl = spatial.local_rows(x)
            out[name] = (spatial.gather_rows(xl), spatial.halo_rows(xl, 3, 2))
    try:
        with spatial.shard(8 * WORLD + 8, 8):
            out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    return out


@contextlib.contextmanager
def shard_of(h, w, rank=None, world=None):
    """A shard of a tensor of h rows at any resolution (the image-height
    rule holds for the padded image, not for every activation); rank and
    world default to the process group's."""
    token = spatial._SHARD.set(spatial.SpaceShard(
        torch.distributed.get_rank() if rank is None else rank,
        torch.distributed.get_world_size() if world is None else world, h, w))
    try:
        yield
    finally:
        spatial._SHARD.reset(token)


def _evaluate(payload):
    """The Evaluator's results over the payload's records (and its first
    pair's predictions) at ``space_parallel`` = the world."""
    from flow_supervisor_tpu_torch.evaluation import Evaluator
    from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
    from flow_supervisor_tpu_torch.parallel import mesh

    model = RAFT(RAFTConfig(**payload["cfg"]))
    model.load_state_dict(payload["state"])
    ev = Evaluator(model, iters=payload["iters"], pad_bucket=payload["pad_bucket"],
                   space_parallel=mesh.world_size())
    return {"pad_bucket": ev.pad_bucket,
            "results": ev.evaluate(payload["records"], warm_start=True),
            "predict": ev.predict(*payload["pair"], "sintel")}


JOBS = {"forwards": _forwards, "ops": _ops, "evaluate": _evaluate}


def _rank(rank, world, job, workdir):
    from flow_supervisor_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.init_world(world, rank, torch.device("cpu"),
                    "file://" + os.path.join(workdir, "store"), "gloo")
    try:
        payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
        torch.save(JOBS[job](payload), os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        mesh.close_world()


def start_world(world: int, job: str, payload):
    """Spawn ``world`` gloo ranks running ``JOBS[job](payload)``; returns the
    handle ``finish_world`` takes (the caller may work meanwhile)."""
    workdir = tempfile.mkdtemp(prefix="fst_space_test_")
    torch.save(payload, os.path.join(workdir, "payload.pt"))
    ctx = mp.start_processes(_rank, args=(world, job, workdir), nprocs=world, join=False,
                             start_method="spawn")
    return ctx, workdir, world


def finish_world(handle) -> list:
    """Wait for the ranks (raising if one failed) -> each rank's result."""
    ctx, workdir, world = handle
    try:
        while not ctx.join(timeout=300):
            pass
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run_world(world: int, job: str, payload) -> list:
    return finish_world(start_world(world, job, payload))


# ---- the halos, norms and collectives ----------------------------------------


def _modules():
    from flow_supervisor_tpu_torch.models.layers import GroupNorm, InstanceNorm, conv2d

    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)

    def x(c, h, w=12):
        t = torch.from_numpy(rng.normal(0, 1, (1, c, h, w)).astype(np.float32))
        return t.contiguous(memory_format=torch.channels_last)

    mods = []
    for (kh, kw), s in CONVS:
        for rows in ROWS:
            conv = conv2d(6, 5, (kh, kw), s)
            with torch.no_grad():
                for t in conv.parameters():
                    t.copy_(torch.randn(t.shape, generator=gen) * 0.3)
            mods.append((f"conv_{kh}x{kw}_s{s}_rows{rows}", conv, x(6, rows * WORLD)))
    pair = conv2d(8, 8, 3, 1)
    pair_bf16 = conv2d(16, 16, 3, 1).to(torch.bfloat16)
    mods += [("instance", InstanceNorm(), x(8, 32)), ("instance_relu", InstanceNorm(True), x(8, 32)),
             ("pair", pair, x(8, 32)), ("pair_bf16", pair_bf16, (x(16, 32) * 2 + 1).to(torch.bfloat16)),
             ("group", GroupNorm(2, 8), x(8, 32))]
    with torch.no_grad():
        mods[-1][1].weight.uniform_(0.5, 1.5, generator=gen)
        mods[-1][1].bias.uniform_(-0.5, 0.5, generator=gen)
    return mods


def _tensors():
    rng = np.random.default_rng(1)
    full = torch.from_numpy(rng.normal(0, 1, (2, 16, 3, 4)).astype(np.float32))
    return [("fp32", full), ("bf16", full.to(torch.bfloat16)),
            ("int64", torch.arange(2 * 16 * 3).reshape(2, 16, 3))]


@pytest.fixture(scope="module")
def ops_world():
    mods, tensors = _modules(), _tensors()
    res = run_world(WORLD, "ops", {"modules": mods, "tensors": tensors})
    return mods, tensors, res


def _unsharded(name, module, x):
    from flow_supervisor_tpu_torch.models.encoders import _conv_instnorm_relu

    with torch.no_grad():
        return _conv_instnorm_relu(module, x) if name.startswith("pair") else module(x)


@pytest.mark.parametrize("kernel,s", CONVS, ids=[f"{h}x{w}_s{s}" for (h, w), s in CONVS])
@pytest.mark.parametrize("rows", ROWS, ids=["halo_from_next_rank", "halo_past_next_rank"])
def test_sharded_conv_matches_the_unsharded_conv(ops_world, kernel, s, rows):
    mods, _, res = ops_world
    kh, kw = kernel
    name = f"conv_{kh}x{kw}_s{s}_rows{rows}"
    (module, x), = [(m, x) for n, m, x in mods if n == name]
    want = _unsharded(name, module, x)
    top, bottom = spatial.conv_halo(kh, s, module.padding[0])
    print(name, "halo", (top, bottom), [float((r[name] - want).abs().max()) for r in res])
    for r in res:
        assert r[name].shape == want.shape
        assert float((r[name] - want).abs().max()) <= LIMIT


def test_conv_halo_widths():
    assert spatial.conv_halo(7, 2, 3) == (3, 2)
    assert spatial.conv_halo(3, 2, 1) == (1, 0)
    assert spatial.conv_halo(1, 2, 0) == (0, 0)
    assert spatial.conv_halo(3, 1, 1) == (1, 1)
    assert spatial.conv_halo(7, 1, 3) == (3, 3)
    assert spatial.conv_halo(5, 1, 2) == (2, 2)


@pytest.mark.parametrize("name", ["instance", "instance_relu", "pair", "group"])
def test_sharded_norms_take_the_whole_frames_moments(ops_world, name):
    mods, _, res = ops_world
    (module, x), = [(m, x) for n, m, x in mods if n == name]
    want = _unsharded(name, module, x)
    errs = [float((r[name] - want).abs().max()) for r in res]
    print(name, errs)
    assert max(errs) <= LIMIT
    # the first shard's own statistics would be another function
    rows = x.shape[2] // WORLD
    local = _unsharded(name, module, x[:, :, :rows])
    assert float((local - want[:, :, :rows]).abs().max()) > 1e-3


def test_sharded_bf16_pair_takes_statistics_from_the_bf16_conv_output(ops_world):
    """The pinned divergence of the sharded conv -> norm pair in bf16: its
    moments are those of the conv output rounded to bf16 (K5's output; JAX's
    sharded forward with ``fused_norm=False`` alike), where the unsharded
    pair (K2) takes them from the fp32 accumulator."""
    from flow_supervisor_tpu_torch.kernels.conv3x3 import conv3x3_bare_plain
    from flow_supervisor_tpu_torch.kernels.norm import (
        instance_norm_apply_plain,
        instance_norm_stats_plain,
    )
    from flow_supervisor_tpu_torch.models.layers import nchw, nhwc

    mods, _, res = ops_world
    (module, x), = [(m, x) for n, m, x in mods if n == "pair_bf16"]
    with torch.no_grad():
        y = conv3x3_bare_plain(nhwc(x), module.weight.permute(2, 3, 1, 0).contiguous(),
                               module.bias)
        want = nchw(instance_norm_apply_plain(y, instance_norm_stats_plain(y), relu=True))
    unsharded = _unsharded("pair_bf16", module, x)
    for r in res:
        got = r["pair_bf16"]
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, want, rtol=2 ** -7, atol=0)  # within one bf16 ulp
    print("unsharded elements off the bf16-statistics formula:", int((unsharded != want).sum()))
    assert (unsharded != want).any()


@pytest.mark.parametrize("name", ["fp32", "bf16", "int64"])
def test_gather_and_halo_rows_are_exact(ops_world, name):
    _, tensors, res = ops_world
    (full,), = [(t,) for n, t in tensors if n == name]
    rows = full.shape[1] // WORLD
    padded = torch.cat([torch.zeros_like(full[:, :3]), full, torch.zeros_like(full[:, :2])], 1)
    for rank, r in enumerate(res):
        gathered, halo = r[name]
        assert gathered.dtype == full.dtype and torch.equal(gathered, full)
        assert torch.equal(halo, padded[:, rank * rows : rank * rows + rows + 5])


def test_a_height_off_the_8n_grid_is_refused(ops_world):
    for r in ops_world[2]:
        assert "H=40" in r["refusal"] and "8*space=32" in r["refusal"]
    with pytest.raises(ValueError, match=r"H=60 must be a multiple of 8\*space=8"):
        spatial.check_height(60, 1)


def test_helpers_outside_a_shard():
    x = torch.randn(1, 3, 4, 2)
    assert spatial.current() is None and spatial.space_world() == 1
    assert spatial.first_row(5) == 0
    assert spatial.local_rows(x) is x and spatial.gather_rows(x) is x
    s = torch.ones(2, 2)
    assert spatial.all_reduce_moments(s) is s
    h = spatial.halo_rows(x, 1, 2)
    assert torch.equal(h[:, 1:4], x) and not h[:, :1].any() and not h[:, 4:].any()
    with spatial.shard(64, 8) as sh:  # a world of 1 enters no shard
        assert sh is None and spatial.current() is None
