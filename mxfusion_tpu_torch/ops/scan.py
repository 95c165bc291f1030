"""All-prefix combine with an associative operation, at log depth.

Torch has no stable ``associative_scan``. :func:`associative_scan` is
the recursion of ``jax.lax.associative_scan`` (``_scan`` in
``jax/_src/lax/control_flow/loops.py``), combine for combine: pairs of
adjacent elements are combined, the halved sequence is scanned by
recursion, the odd results are combined with the even elements (with
the same branch on an odd length), and the two are interleaved. So the
parallel Kalman filter and smoother (``ops/kalman.py``) combine their
elements in JAX's order and match it to rounding.
"""
import torch


def _slice(x, axis, start, stop=None, step=1):
    index = [slice(None)] * x.ndim
    index[axis] = slice(start, stop, step)
    return x[tuple(index)]


def _interleave(even, odd, axis):
    """``[e0, o0, e1, o1, ...]``; ``even`` is as long as ``odd`` or one
    longer."""
    m = odd.shape[axis]
    pairs = torch.stack([_slice(even, axis, 0, m), odd], dim=axis + 1)
    shape = list(odd.shape)
    shape[axis] = 2 * m
    out = pairs.reshape(shape)
    if even.shape[axis] > m:
        out = torch.cat([out, _slice(even, axis, m)], dim=axis)
    return out


def associative_scan(fn, elems, reverse=False, axis=0):
    """Inclusive scan of the tuple of tensors ``elems`` along ``axis``
    with the associative ``fn(a, b)``, which takes and returns tuples of
    tensors and is applied elementwise along ``axis`` (counted from the
    front, the same for every element, so that batch axes lead and event
    axes trail): the k-th result is
    ``fn(...fn(fn(x0, x1), x2)..., xk)``.

    ``reverse=True`` scans from the end, as JAX does: it flips the
    inputs, so ``fn`` is called as ``fn(later, earlier)`` and the k-th
    result combines elements k to the last. The order matters for a
    composition that does not commute (the RTS smoother's is
    earlier ∘ later)."""
    elems = list(elems)
    if reverse:
        elems = [torch.flip(e, (axis,)) for e in elems]

    def combine(a, b):
        return list(fn(tuple(a), tuple(b)))

    def scan(xs):
        n = xs[0].shape[axis]
        if n < 2:
            return xs
        reduced = combine([_slice(x, axis, 0, -1, 2) for x in xs],
                          [_slice(x, axis, 1, None, 2) for x in xs])
        odd = scan(reduced)
        if n % 2 == 0:
            even = combine([_slice(o, axis, 0, -1) for o in odd],
                           [_slice(x, axis, 2, None, 2) for x in xs])
        else:
            even = combine(odd, [_slice(x, axis, 2, None, 2) for x in xs])
        even = [torch.cat([_slice(x, axis, 0, 1), e], dim=axis)
                for x, e in zip(xs, even)]
        return [_interleave(e, o, axis) for e, o in zip(even, odd)]

    out = scan(elems)
    if reverse:
        out = [torch.flip(o, (axis,)) for o in out]
    return tuple(out)
