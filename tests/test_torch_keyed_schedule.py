"""The schedule of the keyed-draw kernels R1 and R2, emulated on the CPU
(``ops/keyed_random.py``: ``emulate_schedule``, ``tile_elements``).

Each warp draws a tile of consecutive elements; in R1 each lane takes
the tile's next element as soon as its own is written, R2 draws tiles
of 32, one element a lane. Played from the plain versions' hash counts:
every element is drawn exactly once, on one lane, over as many
iterations as its rounds need, no two on one lane at once, in index
order; the draws taken in the emulated order, each at its own index, are
the plain versions' bits; one thread an element's lane efficiency is the
grouped maximum over 32 consecutive elements (0.74 at α = 2.5); R1's
schedule at its own tile reaches 0.9 at the Student-t chunk's n; R2's
is one thread an element's (0.52 and 0.43 at rates 4 and 37).
"""
import math

import numpy as np
import pytest
import torch

from mxfusion_tpu_torch.common import config as tconfig
from mxfusion_tpu_torch.ops import keyed_random as kr

# the Student-t propagation's gamma draw of a chunk (20 × 8192 × 30)
STUDENT_T_N = 20 * 8192 * 30
# the warps an H100 (132 SMs) holds at once of R1 in float32: 40 an SM,
# from its 48 registers a thread (chip_smoke.py phase 58a reads them from
# the card)
H100_WARPS = 132 * 40


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    old = tconfig.set_default_device("cpu")
    yield
    tconfig.set_default_device(old)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _key(seed):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, 2 ** 32, 2, dtype=np.int64))


def _params(kind, n, seed):
    """Mixed parameters: gamma shapes on both sides of 1, and rates of
    both arms with the roundless ones (0, negative, NaN)."""
    rng = np.random.default_rng(seed)
    if kind == "gamma":
        values = (0.1, 0.7, 1.0, 2.5, 6.0, 50.0)
    else:
        values = (0.0, -1.0, math.nan, 0.3, 4.0, 9.99, 10.0, 37.0, 1e4)
    return torch.as_tensor(rng.choice(values, n))


def _schedule(kind, p, tile):
    plain = kr._gamma_torch if kind == "gamma" else kr._poisson_torch
    draws, hashes = plain(p, _key(3), with_hashes=True)
    return draws, hashes, kr.emulate_schedule(kind, p, hashes, tile)


def test_tiles_split_n_evenly_over_the_resident_warps():
    """R1: one element a lane while n fits the resident lanes, else n
    split evenly over every resident warp: at the Student-t chunk 931
    elements a warp, at 2^20 elements 199, at n = 1 one a lane. R2 draws
    tiles of 32 only."""
    gw = H100_WARPS
    for n, tile in ((STUDENT_T_N, 931), (1 << 20, 199), (163840, 32),
                    (1, 32), (32 * gw, 32), (32 * gw + 1, 33)):
        assert kr.tile_elements(n, gw) == tile
        assert -(-n // tile) <= gw
    p = torch.full((64,), 4.0)
    with pytest.raises(ValueError, match="tiles of 32"):
        kr.emulate_schedule("poisson", p, torch.ones(64), 64)


@pytest.mark.parametrize("kind,n,tile", [
    ("gamma", 5000, 97),      # tiles of 97, the last of 53
    ("gamma", 1, 32),
    ("gamma", 31, 32),
    ("poisson", 3001, 32),    # one a lane, the last tile of 25
    ("poisson", 163, 32),
    ("poisson", 7, 32),
    ("poisson", 1, 32)])
def test_every_element_is_drawn_once_on_one_lane(kind, n, tile):
    """Each element is handed out once, to a lane in [0, 32), and drawn
    over as many iterations as its rounds need (R2: its whole draw in
    one); on each lane of each tile the elements follow one another
    with no overlap, in index order; the slots issued cover every hash
    needed."""
    p = _params(kind, n, n)
    _, hashes, s = _schedule(kind, p, tile)
    lane, start, finish = s["lane"], s["start"], s["finish"]
    assert lane.min() >= 0 and lane.max() < 32
    if kind == "gamma":
        iters = (hashes - (~(p >= 1)).long()) // 3
    else:
        iters = (hashes > 0).long()
    assert torch.equal(finish - start + 1, iters)
    tile_of = torch.arange(n) // tile
    for t in range(-(-n // tile)):
        for ln in range(32):
            on = ((tile_of == t) & (lane == ln)).nonzero().reshape(-1)
            order = torch.argsort(start[on] * 2 + (iters[on] > 0).long(),
                                  stable=True)
            st, fi = start[on][order], finish[on][order]
            assert bool((st[1:] > fi[:-1]).all())
        # the hand-out order: a permutation of the tile, taken in time
        mine = (tile_of == t).nonzero().reshape(-1)
        taken = mine[torch.argsort(s["rank"][mine])]
        assert torch.equal(s["rank"][taken], torch.arange(mine.numel()))
        assert bool((start[taken][1:] >= start[taken][:-1]).all())
        assert torch.equal(taken, mine)
    assert s["tile_slots"] >= int(hashes.sum())
    assert s["thread_slots"] >= int(hashes.sum())


@pytest.mark.parametrize("kind,dtype", [
    ("gamma", torch.float32), ("gamma", torch.float64),
    ("poisson", torch.float32), ("poisson", torch.float64)])
def test_draws_in_the_emulated_order_are_the_plain_bits(kind, dtype):
    """Draw 4096 mixed elements as the schedule takes them, iteration by
    iteration, each at its own index: the same bits as the whole draw."""
    n, tile = 4096, 160 if kind == "gamma" else 32
    p = _params(kind, n, 9).to(dtype)
    whole, _, s = _schedule(kind, p, tile)
    plain = kr._gamma_torch if kind == "gamma" else kr._poisson_torch
    order = torch.argsort(s["start"] * (1 << 20) + (
        torch.arange(n) // tile) * tile + s["rank"])
    got = torch.empty_like(whole)
    for chunk in torch.split(order, 512):
        got[chunk] = plain(p[chunk], _key(3), index=chunk)
    assert torch.equal(got.isnan(), whole.isnan())
    np.testing.assert_array_equal(got.numpy(), whole.numpy())


def test_one_thread_an_element_is_the_grouped_maximum():
    """At α = 2.5, 2^16 elements: one thread an element issues 32 × the
    largest hash count of each 32 consecutive elements, a lane efficiency
    of 0.74 ± 0.02; the tile schedule at tiles of 32 is the same
    schedule."""
    n = 1 << 16
    p = torch.full((n,), 2.5)
    _, hashes, s = _schedule("gamma", p, 32)
    grouped = int(hashes.sum()) / (32 * int(
        hashes.reshape(-1, 32).amax(1).sum()))
    assert s["thread_efficiency"] == pytest.approx(grouped, abs=1e-12)
    assert abs(s["thread_efficiency"] - 0.74) <= 0.02
    assert s["tile_efficiency"] == pytest.approx(grouped, abs=1e-12)


@pytest.mark.parametrize("alpha,n,floor,thread", [
    (2.5, STUDENT_T_N, 0.9, 0.74),   # the Student-t chunk: 931 a warp
    (0.1, 1 << 20, 0.85, 0.65)])     # 199 a warp; 0.870 read here
def test_the_tile_schedule_keeps_the_lanes_busy(alpha, n, floor, thread):
    """R1's lane efficiency at its own tile for n float32 elements on the
    H100, counted on 2^16 of them, reaches ``floor``, where one thread an
    element gives ``thread``."""
    p = torch.full((1 << 16,), alpha, dtype=torch.float32)
    _, _, s = _schedule("gamma", p, kr.tile_elements(n, H100_WARPS))
    assert s["tile_efficiency"] >= floor
    assert abs(s["thread_efficiency"] - thread) <= 0.02


@pytest.mark.parametrize("rate,thread", [(4.0, 0.52), (37.0, 0.43)])
def test_r2_draws_one_element_a_lane(rate, thread):
    """R2 draws one element a lane at every n, so its lane efficiency is
    one thread an element's: 0.52 and 0.43 at rates 4 and 37 (2^16
    float32 elements). A tile that hands elements out would reach about
    0.8, but it paid on the card only at PTRS's rates, which no path
    draws at more than the card's resident lanes."""
    p = torch.full((1 << 16,), rate, dtype=torch.float32)
    _, _, s = _schedule("poisson", p, 32)
    assert s["tile_efficiency"] == pytest.approx(s["thread_efficiency"],
                                                 abs=1e-12)
    assert abs(s["thread_efficiency"] - thread) <= 0.02
