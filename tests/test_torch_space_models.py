"""The port's space-parallel GMA and small models (parallel/spatial.py) in a
world of 2 gloo ranks on the CPU, against the port's one-process forward.

One pair of seeded noise images, 64x96 (each rank 32 rows, 4 at 1/8
resolution), 2 iterations, fp32, weights from a seed (GMA's aggregator
gamma at 0.5: its initial zero leaves the attention out):

- GMA with 2 heads, content similarity (the auto lookup: einsum here) and
  the content plus relative-position similarity (the fused lookup, its
  plain version here), and the position term alone: the attention's queries
  stay the rank's rows, k is gathered once and v in every iteration, the
  softmax runs over the whole frame; the final and low-resolution flow
  within 1e-5;
- a planted fault, the position term's height table indexed by the shard's
  local rows, must put the position_and_content forward beyond the limit;
- the small model (SmallEncoder's bottleneck blocks, instance norm, radius
  3, bilinear x8 upsampling of the gathered field) within 1e-5;
- ``RelPosEmb`` refuses a frame whose height at 1/8 exceeds its tables
  even when the shard's rows fit them.
"""
import numpy as np
import pytest
import torch

from flow_supervisor_tpu_torch.models.raft import RAFT, RAFTConfig
from test_torch_space_world import run_world, shard_of

WORLD = 2
H, W = 64, 96
ITERS = 2
LIMIT = 1e-5
CASES = {
    "gma_content": dict(gma=True, num_heads=2, lookup_backend="auto"),
    "gma_position_and_content": dict(gma=True, num_heads=2, position_and_content=True,
                                     lookup_backend="fused"),
    "gma_position_only": dict(gma=True, num_heads=2, position_only=True,
                              lookup_backend="einsum"),
    "small": dict(small=True, lookup_backend="einsum"),
}


def _model(name, seed=5):
    model = RAFT(RAFTConfig(iters=ITERS, **CASES[name]),
                 generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("aggregator.gamma"):
                p.fill_(0.5)
    return model


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(2)
    i1 = rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)
    i2 = np.roll(i1, (1, 2), axis=(1, 2)) * 0.9 + 0.05 * rng.uniform(0, 1, i1.shape)
    t1, t2 = torch.from_numpy(i1), torch.from_numpy(i2.astype(np.float32))
    names = list(CASES) + ["gma_position_and_content"]
    cases = [{"cfg": {"iters": ITERS, **CASES[n]}, "state": _model(n).state_dict(),
              "image1": t1, "image2": t2} for n in names]
    cases[-1]["fault"] = "local_pos_rows"
    ranks = run_world(WORLD, "forwards", {"cases": cases})
    one = {}
    for n in CASES:
        out = _model(n)(t1, t2, final_flow_only=True)
        one[n] = out["flow_up"][-1], out["flow_low"][-1]
    return {"ranks": ranks, "one": one, "names": names}


def _err(a, b) -> float:
    return float((a - b).abs().max())


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_model_matches_one_process(runs, name):
    up, low = runs["one"][name]
    i = runs["names"].index(name)
    got = [r[i] for r in runs["ranks"]]
    print(name, [(_err(u, up), _err(lo, low)) for u, lo, _ in got])
    for u, lo, _ in got:
        assert u.shape == up.shape == (1, H, W, 2) and lo.shape == low.shape
        assert _err(u, up) < LIMIT and _err(lo, low) < LIMIT
        assert torch.equal(u, got[0][0])


def test_local_rows_in_the_position_term_fail_the_comparison(runs):
    up, _ = runs["one"]["gma_position_and_content"]
    errs = [_err(r[-1][0], up) for r in runs["ranks"]]
    print("position term at local rows:", errs)
    assert min(errs) > 100 * LIMIT


def test_the_position_tables_refuse_the_frames_height():
    from flow_supervisor_tpu_torch.models.gma import RelPosEmb

    emb = RelPosEmb(160, 4)
    with shard_of(81 * WORLD, 2, rank=1, world=WORLD):  # 81 rows a rank, 162 in the frame
        with pytest.raises(ValueError, match="162x2 feature map exceeds max_pos_size 160"):
            emb(torch.zeros(1, 1, 81, 2, 4))
    assert emb(torch.zeros(1, 1, 81, 2, 4)).shape == (1, 1, 81, 2, 81, 2)
