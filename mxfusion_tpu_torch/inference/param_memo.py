"""Values that depend on the parameters only, kept while the parameters
they were built from are unchanged.

A served posterior answers many chunks, and many requests, from one set
of parameters: the runtime env's transformed parameters and the factors
a prediction builds from them (the SVGP's Cholesky factors of Kuu and S)
are the same in every chunk. ``BatchedPredictor`` owns a
:class:`ParamMemo` and activates it around its chunks; inside that scope
the env builder and a prediction algorithm look such values up, outside
it (training, samplers, ``export()`` tracing, a loaded artifact) nothing
is kept and every caller computes as it always does.

A value is recognised by the tensors it was computed from: their
identity and their ``_version``. An in-place update (an optimizer's
step) bumps the version, and ``InferenceParameters.update_params``
replaces the tensor, so either forces a rebuild; a value recomputed or
drawn for each chunk is a new tensor every time, and is never reused.
The memo holds every tensor it keys on, so no id is reused while an
entry stands, and it keeps one entry a slot: a rebuild replaces what the
slot held.
"""
import contextlib
import contextvars

_ACTIVE = contextvars.ContextVar("param_memo", default=None)


def _stamp(tensors):
    """``((tensor, version), ...)``, or None where a tensor keeps no
    version (one made in inference mode): what is built from it is never
    kept."""
    try:
        return tuple((t, t._version) for t in tensors)
    except RuntimeError:
        return None


def _current(stamp):
    return all(t._version == v for t, v in stamp)


def _same(stamp, values):
    return len(stamp) == len(values) and \
        all(s is t for (s, _), t in zip(stamp, values)) and _current(stamp)


class ParamMemo:
    """One predictor's store of parameter-derived values.

    ``hits`` and ``misses`` count the lookups of :meth:`derived` (the
    factors a prediction builds); the env's entries are not counted. The
    ``svgp.factors`` span shows the same builds, but only while a
    profiler records: the counts tell a serving process without one
    whether its factors are rebuilt, say because the store it serves is
    being trained in place."""

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self._env = {}
        self._derived = {}

    @contextlib.contextmanager
    def scope(self):
        """Make this memo the one that lookups in this context use."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    def env_value(self, key, source, transform, build):
        """The env's entry for ``key`` (a variable's uuid), built by
        ``build()`` from ``source`` under ``transform``: the kept entry
        while ``source`` is the same tensor at the same version, the
        transform the same object, and the entry itself unmodified."""
        kept = self._env.get(key)
        if kept is not None:
            stamp, held_transform, value, value_stamp = kept
            if held_transform is transform and _same(stamp, (source,)) \
                    and _current(value_stamp):
                return value
        value = build()
        self._keep(self._env, key, transform, (source,), value, (value,))
        return value

    def derived(self, owner, key, inputs, build):
        """``build()``'s result for ``owner`` (an algorithm instance),
        kept while ``key`` (hashable settings: jitter, tier, shapes) is
        equal and ``inputs`` are the same tensors at the same versions;
        ``build`` returns a tuple of tensors, which must stay unmodified
        for the entry to stand."""
        # the entry holds ``owner``, so no other object takes its id
        slot = (id(owner), key)
        kept = self._derived.get(slot)
        if kept is not None:
            stamp, _, value, value_stamp = kept
            if _same(stamp, inputs) and _current(value_stamp):
                self.hits += 1
                return value
        self.misses += 1
        value = build()
        self._keep(self._derived, slot, owner, inputs, value, value)
        return value

    @staticmethod
    def _keep(store, slot, holder, inputs, value, outputs):
        stamp, value_stamp = _stamp(inputs), _stamp(outputs)
        if stamp is None or value_stamp is None:
            store.pop(slot, None)
        else:
            store[slot] = (stamp, holder, value, value_stamp)


def env_value(key, source, transform, build):
    """The active memo's :meth:`ParamMemo.env_value`, or ``build()``
    where no memo is active."""
    memo = _ACTIVE.get()
    if memo is None:
        return build()
    return memo.env_value(key, source, transform, build)


def derived(owner, key, inputs, build):
    """The active memo's :meth:`ParamMemo.derived`, or ``build()`` where
    no memo is active."""
    memo = _ACTIVE.get()
    if memo is None:
        return build()
    return memo.derived(owner, key, inputs, build)
