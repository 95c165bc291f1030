"""Keyed gamma and Poisson draws (R1, R2): counter-based, as JAX's are.

A gamma or a Poisson draw is a rejection loop whose number of rounds
depends on the data, so it has no parameter-free base draw that an
exported program could take as an input. Here, as in ``jax.random``,
such a draw is a pure function of (key, parameter, element index): the
key is one base draw of kind ``"key"`` from the caller's generator (two
int64 words below 2³², ``random_gen.draw_key``), and everything else is
computed from it. So a program that takes the key as an input draws what
the live path draws, and one operator node holds the whole loop.

The layout, which the kernels (``csrc/keyed_draws.cu``) and the plain
versions here follow exactly:

* **Hash.** Threefry-2x32 with 20 rounds, the hash of JAX's keys
  (``jax.extend.random.threefry_2x32``), of the counter (word 0,
  word 1) under the key (k0, k1).
* **Counters.** Word 0 is the element's flat index i (2³² elements or
  more raise). Word 1 is 4·r + j: r the round (0 ≤ r < ``ROUNDS``), j
  the draw within it. The gamma draw takes j = 0 and 1 for the two
  uniforms of a Box-Muller normal and j = 2 for the acceptance uniform,
  and (r, j) = (0, 3) for the boost uniform below α = 1. The Poisson
  draw takes j = 0 (Knuth) or j = 0 and 1 (the u and v of PTRS).
* **Uniforms.** (y0, y1) is the hash; float32 takes m = y0 >> 9 and
  u = (2m + 1)·2⁻²⁴, float64 m = (y0 << 20) | (y1 >> 12) and
  u = (2m + 1)·2⁻⁵³: in (0, 1), both ends excluded, exact in its type.
* **R1, gamma.** ``jax.random.gamma``'s algorithm: Marsaglia-Tsang on
  Gamma(α) for α ≥ 1 and on Gamma(α + 1) boosted by U^(1/α) below, the
  normal from Box-Muller, sqrt(-2 log u₀)·cos(2π u₁). A round whose
  v = 1 + c·x is not above 0 is rejected whole (JAX redraws only x; the
  law is the same). The draw is clamped at the type's ``tiny`` for
  α > 0, as ``torch._standard_gamma`` does, so float32 at α = 0.1 gives
  no zeros; α = 0 gives 0 and α ≤ -2/3 or NaN give NaN, as JAX's.
* **R2, Poisson.** ``jax.random.poisson``'s algorithms: Knuth's product
  of uniforms (as a sum of logs) below rate 10 or at NaN, Hörmann's
  transformed rejection (PTRS) from 10 up; rate 0 gives 0, a negative
  or NaN rate -1, as JAX's. The counts are of the rate's type.
* **Cap.** An element that accepts in none of its ``ROUNDS`` rounds is
  NaN, never a biased value. PTRS and Marsaglia-Tsang accept above 0.9
  of their rounds, and Knuth's 64 uniforms reach a count of 63, so it
  does not happen in practice.

Both are operators of the package's ``torch.library`` fragment,
``mxfusion_tpu_torch::keyed_gamma`` and ``::keyed_poisson``, with a
CUDA implementation that launches the kernel, a CPU implementation that
is the plain version (so a CPU artifact holds one node too) and a fake
one. A CUDA tensor launches the kernel or raises; nothing falls back to
the plain version. Neither is tagged ``nondeterministic_seeded``: each is
a pure function of its inputs. ``threefry2x32`` exposes the raw words
(the kernel's and the plain version's), so the hash can be held to
JAX's and the kernel to its plain version bit for bit.

**The kernels' schedule.** How many rounds an element takes depends on
its own draws, so one thread an element leaves a warp's lanes idle while
its slowest element redraws. While n fits the lanes of the warps the
card holds at once, both kernels draw tiles of 32 consecutive elements,
one a lane, each to its end. Above, R1 splits n evenly over the
resident warps, one wave (:func:`tile_elements`, :func:`launch_plan`);
each lane runs one round of its element an iteration and, once the
element is written, takes the tile's next one; the boosts below α = 1
run in a pass over the tile after the loop. R2 stays one element a lane,
a block for each 256: handing elements out paid only at PTRS's dear
rounds, which no path draws at that size. The schedule moves no
bit: every draw is a pure function of (key, parameter, index).
:func:`emulate_schedule` plays it in torch from the plain versions' hash
counts, with the one-thread-an-element schedule's lane efficiency beside
it.
"""
import ctypes
import math

import torch

from . import cuda_build
from .cuda_kernels import _LIB_OPS

SOURCE = "keyed_draws.cu"
# no multiply and add contracted into one rounding, so that each operation
# of the kernels rounds as the plain version's torch operation does
NVCC_FLAGS = ("--fmad=false",)
ROUNDS = 64
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

_LIB = None


def _threefry_torch(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on int64 tensors (or ints) that hold
    32-bit words: every add and left shift is masked to 32 bits, so the
    values stay below 2³² and ``>>`` is a logical shift."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for b in range(5):
        for rot in _ROTATIONS[b % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << rot) & _MASK) | (x1 >> (32 - rot))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(b + 1) % 3]) & _MASK
        x1 = (x1 + ks[(b + 2) % 3] + (b + 1)) & _MASK
    return x0, x1


def _uniform(key, index, word, dtype):
    """The uniform in (0, 1) of counter (index, word) under ``key``."""
    y0, y1 = _threefry_torch(key[0], key[1], index, word)
    if dtype == torch.float32:
        return (2 * (y0 >> 9) + 1).to(torch.float32) * 2.0 ** -24
    m = (y0 << 20) | (y1 >> 12)
    return (2 * m + 1).to(torch.float64) * 2.0 ** -53


def _flat(x, key, index, name):
    """``x`` flattened, its element indices, and a maker of constants in
    its type (each operation of the plain versions then rounds as the
    kernel's: a Python scalar on the left of ``/`` would take another
    path)."""
    _check(name, x, key, cuda=False)
    flat = x.reshape(-1)
    if index is None:
        index = torch.arange(flat.numel(), device=x.device)
    else:
        index = index.reshape(-1).to(device=x.device, dtype=torch.int64)
    return flat, index, (lambda v: torch.tensor(v, dtype=x.dtype,
                                                device=x.device))


def _gamma_torch(alpha, key, index=None, with_hashes=False):
    """Plain version of R1 (the module docstring's algorithm): Gamma(α, 1)
    draws of ``alpha``'s shape and type. ``index``: the elements' counter
    words 0 (default: their flat indices), so that a slice can be drawn
    alone. ``with_hashes``: also return the Threefry calls each element
    made (the work this draw needed)."""
    a, idx, c = _flat(alpha, key, index, "keyed_gamma")
    one, third = c(1.0), c(1.0 / 3.0)
    boost = ~(a >= one)
    d = torch.where(boost, a + one, a) - third
    cc = third / torch.sqrt(d)
    res = torch.full_like(a, math.nan)
    if with_hashes:
        hashes = boost.to(torch.int64)   # the boost's uniform
    act = torch.arange(a.numel(), device=a.device)
    for r in range(ROUNDS):
        if act.numel() == 0:
            break
        i, w = idx[act], 4 * r
        u1, u2 = _uniform(key, i, w, a.dtype), _uniform(key, i, w + 1, a.dtype)
        x = torch.sqrt(torch.log(u1) * c(-2.0)) * torch.cos(
            u2 * c(2.0 * math.pi))
        d_, c_ = d[act], cc[act]
        v = one + x * c_
        X = x * x
        V = v * v * v
        U = _uniform(key, i, w + 2, a.dtype)
        reject = (U >= one - c(0.0331) * (X * X)) & (
            torch.log(U) >= X * c(0.5) + d_ * ((one - V) + torch.log(V)))
        accept = ~(v <= 0) & ~reject
        res[act[accept]] = (d_ * V)[accept]
        if with_hashes:
            hashes[act] += 3
        act = act[~accept]
    res = torch.where(boost, res * torch.pow(_uniform(key, idx, 3, a.dtype),
                                             one / a), res)
    tiny = c(torch.finfo(a.dtype).tiny)
    res = torch.where((a > 0) & (res < tiny), tiny, res).reshape(alpha.shape)
    return (res, hashes) if with_hashes else res


def _poisson_torch(rate, key, index=None, with_hashes=False):
    """Plain version of R2 (the module docstring's algorithm): Poisson
    counts of ``rate``'s shape, in its type. ``index`` and
    ``with_hashes`` as for :func:`_gamma_torch`."""
    lam, idx, c = _flat(rate, key, index, "keyed_poisson")
    res = torch.full_like(lam, math.nan)
    if with_hashes:
        hashes = torch.zeros(lam.shape, dtype=torch.int64, device=lam.device)
    knuth = torch.isnan(lam) | (lam < 10)
    # Knuth: the count of uniforms whose log-sum stays above -rate
    act = torch.nonzero(knuth).reshape(-1)
    neg, lp = -lam[act], torch.zeros_like(lam[act])
    for r in range(ROUNDS + 1):
        stop = ~(lp > neg)
        res[act[stop]] = float(r - 1)
        act, neg, lp = act[~stop], neg[~stop], lp[~stop]
        if r == ROUNDS or act.numel() == 0:
            break
        lp = lp + torch.log(_uniform(key, idx[act], 4 * r, lam.dtype))
        if with_hashes:
            hashes[act] += 1
    # PTRS (Hörmann 1993), as jax.random's _poisson_rejection
    act = torch.nonzero(~knuth).reshape(-1)
    l_ = lam[act]
    log_lam = torch.log(l_)
    b = c(0.931) + c(2.53) * torch.sqrt(l_)
    a = c(-0.059) + c(0.02483) * b
    inv_alpha = c(1.1239) + c(1.1328) / (b - c(3.4))
    v_r = c(0.9277) - c(3.6224) / (b - c(2.0))
    half = c(0.5)
    for r in range(ROUNDS):
        if act.numel() == 0:
            break
        i = idx[act]
        u = _uniform(key, i, 4 * r, lam.dtype) - half
        v = _uniform(key, i, 4 * r + 1, lam.dtype)
        us = half - torch.abs(u)
        k = torch.floor((c(2.0) * a / us + b) * u + l_ + c(0.43))
        s = torch.log(v * inv_alpha / (a / (us * us) + b))
        t = -l_ + k * log_lam - torch.lgamma(k + c(1.0))
        accept1 = (us >= c(0.07)) & (v <= v_r)
        reject = (k < 0) | ((us < c(0.013)) & (v > us))
        accept = accept1 | (~reject & (s <= t))
        res[act[accept]] = k[accept]
        if with_hashes:
            hashes[act] += 2
        keep = ~accept
        act, l_, log_lam, b, a, inv_alpha, v_r = (
            t_[keep] for t_ in (act, l_, log_lam, b, a, inv_alpha, v_r))
    res = torch.where(lam == 0, c(0.0), res).reshape(rate.shape)
    return (res, hashes) if with_hashes else res


def _check(name, x, key, cuda):
    """Raise on what the draw does not take: a float32 or float64
    parameter, an int64 key of shape (2,) on its device, fewer than 2³²
    elements."""
    if x.dtype not in _DTYPE_CODE:
        raise ValueError("{}: the parameter is {}; the draw takes float32 "
                         "or float64.".format(name, x.dtype))
    if key.dtype != torch.int64 or tuple(key.shape) != (2,) or \
            key.device != x.device:
        raise ValueError("{}: the key is {} {} on {}; it must be int64 of "
                         "shape (2,) on {}.".format(
                             name, key.dtype, tuple(key.shape), key.device,
                             x.device))
    if x.numel() >= 2 ** 32:
        raise ValueError("{}: {} elements; counter word 0 holds fewer than "
                         "2**32.".format(name, x.numel()))
    if cuda and x.device.type != "cuda":
        raise ValueError("{}: the kernel takes CUDA tensors, got {}."
                         .format(name, x.device))


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load(SOURCE, NVCC_FLAGS)
        ptr, cint, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mxf_keyed_gamma.argtypes = [cint, ptr, cll, ptr, ptr, cll, ptr]
        lib.mxf_keyed_poisson.argtypes = lib.mxf_keyed_gamma.argtypes
        lib.mxf_keyed_plan.argtypes = [cint, cint, cll, ctypes.POINTER(cll),
                                       ctypes.POINTER(cint)]
        for fn in (lib.mxf_keyed_gamma, lib.mxf_keyed_poisson,
                   lib.mxf_keyed_plan):
            fn.restype = cint
        lib.mxf_threefry2x32.argtypes = [ptr, ptr, ptr, ptr, ptr, cll, ptr]
        lib.mxf_threefry2x32.restype = cint
        lib.mxf_cuda_error_string.argtypes = [cint]
        lib.mxf_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(name, fn, x, key):
    """One launch of ``fn`` (R1 or R2) on ``x``'s current stream."""
    _check(name, x, key, cuda=True)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    # a parameter expanded from one element (a scalar broadcast to the
    # draw's shape) is read in place, at element stride 0
    stride = 0 if all(st == 0 for st, n in zip(x.stride(), x.shape)
                      if n > 1) else 1
    if stride:
        x = x.contiguous()
    key = key.contiguous()
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, fn)(_DTYPE_CODE[x.dtype], x.data_ptr(), stride,
                               key.data_ptr(), out.data_ptr(), x.numel(),
                               stream)
    if err != 0:
        raise RuntimeError("{} kernel launch failed: {} ({})".format(
            name, lib.mxf_cuda_error_string(err).decode(), err))
    return out


def _gamma_cuda(alpha, key):
    out = _launch("keyed_gamma", "mxf_keyed_gamma", alpha, key)
    keyed_standard_gamma.launches += 1
    return out


def _poisson_cuda(rate, key):
    out = _launch("keyed_poisson", "mxf_keyed_poisson", rate, key)
    keyed_poisson.launches += 1
    return out


def tile_elements(n, resident_warps):
    """The elements each warp of R1 draws over n elements when the card
    holds ``resident_warps`` of its warps at once (the kernel's rule;
    :func:`launch_plan` gives the card's own): 32, one a lane, while n
    fits the resident lanes, else n split evenly over them. R2's tile is
    always 32."""
    return 32 if n <= 32 * resident_warps else -(-n // resident_warps)


def launch_plan(kind, dtype, n):
    """The launch R1 (``kind`` "gamma") or R2 ("poisson") makes over n
    elements of ``dtype`` on the current card: (tile, the kernel's resident
    warps); R2's tile is always 32. Needs the card."""
    lib = _lib()
    tile, warps = ctypes.c_longlong(), ctypes.c_int()
    err = lib.mxf_keyed_plan({"gamma": 0, "poisson": 1}[kind],
                             _DTYPE_CODE[dtype], n, ctypes.byref(tile),
                             ctypes.byref(warps))
    if err != 0:
        raise RuntimeError("keyed draw launch plan failed: {} ({})".format(
            lib.mxf_cuda_error_string(err).decode(), err))
    return tile.value, warps.value


def _group_max(x, size):
    """The largest entry of each ``size`` consecutive entries of ``x``
    (padded with zeros)."""
    return torch.nn.functional.pad(x, (0, -x.numel() % size)).reshape(
        -1, size).amax(1)


def emulate_schedule(kind, param, hashes, tile):
    """R1's or R2's schedule, played in torch on ``param``'s device (no
    kernel runs). Each warp draws a tile of ``tile`` consecutive
    elements (R2: 32, one a lane). R1: each lane runs one round of its
    element an iteration (the warp runs as many as its longest lane)
    and, once the element is written, takes the tile's next one at the
    next iteration; its boosts below α = 1 run in a pass over the tile
    after the loop. R2: each lane draws its element to its end in one
    iteration, each arm its live lanes hold in turn.

    ``kind``: "gamma" or "poisson"; ``param``: the draw's parameter;
    ``hashes``: the Threefry calls each element needs (the plain
    version's ``with_hashes``). Returns a dict: ``lane``, ``start`` and
    ``finish`` (the iterations of an element's first and last round;
    finish = start - 1 for one that needs no round) and ``rank`` (its
    place in its tile's hand-out order) of each element;
    ``tile_slots`` and ``thread_slots``, the hash slots the warps issue
    (32 for each hash a warp runs) in this schedule and in one thread an
    element's (each 32 consecutive elements a warp, every lane running as
    many rounds as the warp's slowest element of its arm); and
    ``tile_efficiency``/``thread_efficiency``, the hashes needed over
    those slots."""
    p = param.reshape(-1)
    h = hashes.reshape(-1).to(torch.int64)
    n, dev = p.numel(), p.device
    # each element's work in units (rounds; Knuth's: hashes), the units
    # it runs an iteration and the hashes a unit
    if kind == "gamma":
        boost = ~(p >= 1)
        units = (h - boost.to(torch.int64)) // 3
        per, unit = torch.ones_like(h), torch.full_like(h, 3)
        arm = torch.zeros_like(h)
        thread = 3 * _group_max(units, 32) + _group_max(
            boost.to(torch.int64), 32)
    elif kind == "poisson":
        if tile != 32:
            raise ValueError("emulate_schedule: R2 draws tiles of 32, not "
                             "{}".format(tile))
        knuth = torch.isnan(p) | (p < 10)
        arm = (~knuth).to(torch.int64)
        per = torch.full_like(h, ROUNDS)
        units = torch.where(knuth, h, h // 2)
        unit = torch.where(knuth, 1, 2)
        zero = torch.zeros_like(h)
        thread = _group_max(torch.where(knuth, h, zero), 32) + _group_max(
            torch.where(knuth, zero, h), 32)
    else:
        raise ValueError("emulate_schedule: kind is 'gamma' or 'poisson', "
                         "not {!r}".format(kind))
    tiles = -(-n // tile)
    count = torch.full((tiles,), tile, device=dev)
    count[-1] = n - (tiles - 1) * tile
    first = torch.arange(tiles, device=dev)[:, None] * tile
    rem = torch.zeros((tiles, 32), dtype=torch.int64, device=dev)
    cur = torch.zeros_like(rem)
    cursor = torch.zeros(tiles, dtype=torch.int64, device=dev)
    lane, start, finish, rank = (torch.zeros_like(h) for _ in range(4))
    slots, t = 0, 0
    while True:
        idle = rem == 0
        at = cursor[:, None] + idle.cumsum(1) - 1
        take = idle & (at < count[:, None])
        if not bool(take.any()) and not bool((rem > 0).any()):
            break
        # each tile hands its elements out in index order
        el = (first + at)[take]
        ti, li = take.nonzero(as_tuple=True)
        cur[ti, li] = el
        rem[ti, li] = units[el]
        lane[el], start[el], rank[el] = li, t, at[take]
        cursor += take.sum(1)
        live = rem > 0
        used = torch.minimum(per[cur], rem) * live
        c, a = used * unit[cur], arm[cur]
        zero = torch.zeros_like(c)
        slots += 32 * int((torch.where(a == 0, c, zero).amax(1)
                           + torch.where(a == 1, c, zero).amax(1)).sum())
        rem -= used
        done = live & (rem == 0)
        finish[cur[done]] = t
        t += 1
    finish = torch.where(units == 0, start - 1, finish)
    if kind == "gamma":   # the boost pass: every lane, a hash a slot
        boosted = torch.nn.functional.pad(boost, (0, tiles * tile - n)) \
            .reshape(tiles, tile).any(1)
        slots += 32 * int((boosted * -(-count // 32)).sum())
    need = int(h.sum())
    thread_slots = 32 * int(thread.sum())
    return {"lane": lane, "start": start, "finish": finish, "rank": rank,
            "tile_slots": slots, "thread_slots": thread_slots,
            "tile_efficiency": need / slots,
            "thread_efficiency": need / thread_slots}


def keyed_standard_gamma(alpha, key):
    """Gamma(α, 1) draws of ``alpha``'s shape and type (float32 or
    float64) under ``key`` (int64 (2,), on ``alpha``'s device): R1 on a
    CUDA tensor, its plain version on a CPU one. No gradient: the
    sampler's ``_StandardGamma`` gives the implicit one."""
    return torch.ops.mxfusion_tpu_torch.keyed_gamma(alpha, key)


def keyed_poisson(rate, key):
    """Poisson counts of ``rate``'s shape, in its type (float32 or
    float64), under ``key``: R2 on a CUDA tensor, its plain version on a
    CPU one. No gradient flows into the rate."""
    return torch.ops.mxfusion_tpu_torch.keyed_poisson(rate, key)


keyed_standard_gamma.launches = 0
keyed_poisson.launches = 0


def threefry2x32(key, x0, x1):
    """The raw Threefry-2x32 words (y0, y1) of the counters (x0, x1)
    (int64 tensors of one shape holding 32-bit words) under ``key``:
    the kernel's on the card, the plain version's on the CPU."""
    if any(t.dtype != torch.int64 or t.device != x0.device
           for t in (x1, key)) or x0.dtype != torch.int64 or \
            x0.shape != x1.shape or tuple(key.shape) != (2,):
        raise ValueError("threefry2x32: the key (2,) and the counters (of "
                         "one shape) are int64 tensors on one device.")
    if x0.device.type == "cpu":
        return _threefry_torch(key[0], key[1], x0, x1)
    lib = _lib()
    x0, x1 = x0.contiguous(), x1.contiguous()
    y0, y1 = torch.empty_like(x0), torch.empty_like(x1)
    with torch.cuda.device(x0.device):
        err = lib.mxf_threefry2x32(
            key.contiguous().data_ptr(), x0.data_ptr(), x1.data_ptr(),
            y0.data_ptr(), y1.data_ptr(), x0.numel(),
            torch.cuda.current_stream(x0.device).cuda_stream)
    if err != 0:
        raise RuntimeError("threefry2x32 kernel launch failed: {} ({})"
                           .format(lib.mxf_cuda_error_string(err).decode(),
                                   err))
    return y0, y1


_LIB_OPS.define("keyed_gamma(Tensor alpha, Tensor key) -> Tensor")
_LIB_OPS.define("keyed_poisson(Tensor rate, Tensor key) -> Tensor")
# looked up at each call, so that a test can wrap the launch
_LIB_OPS.impl("keyed_gamma", lambda alpha, key: _gamma_cuda(alpha, key),
              "CUDA")
_LIB_OPS.impl("keyed_poisson", lambda rate, key: _poisson_cuda(rate, key),
              "CUDA")
_LIB_OPS.impl("keyed_gamma", lambda alpha, key: _gamma_torch(alpha, key),
              "CPU")
_LIB_OPS.impl("keyed_poisson", lambda rate, key: _poisson_torch(rate, key),
              "CPU")


@torch.library.register_fake("mxfusion_tpu_torch::keyed_gamma", lib=_LIB_OPS)
def _keyed_gamma_fake(alpha, key):
    _check("keyed_gamma", alpha, key, cuda=False)
    return alpha.new_empty(alpha.shape)


@torch.library.register_fake("mxfusion_tpu_torch::keyed_poisson",
                             lib=_LIB_OPS)
def _keyed_poisson_fake(rate, key):
    _check("keyed_poisson", rate, key, cuda=False)
    return rate.new_empty(rate.shape)
