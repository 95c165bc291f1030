"""GP kernel base classes.

Counterpart of ``mxfusion_tpu/components/distributions/gp/kernels/
kernel.py``. A kernel is a function object with parameter Variables
living in a name-prefixed namespace (``{kernel_name}_{param}``); K and
Kdiag strip one prefix level before dispatching, and combination
kernels (``k1 + k2``, ``k1 * k2``) nest prefixes: ``add_rbf_lengthscale``.
Covariances are batched tensor code with the leading sample axis riding
along.
"""
from ....variables.variable import Variable
from ....variables.var_trans import PositiveTransformation
from .....common.config import get_default_dtype
from .....common.exceptions import ModelSpecificationError
from .....util.util import slice_axis


class Kernel:
    """Base class of all GP covariance functions."""

    def __init__(self, input_dim, name, active_dims=None, dtype=None):
        object.__setattr__(self, "_parameter_names", [])
        self.input_dim = input_dim
        self.name = name
        self.active_dims = active_dims
        self.dtype = dtype if dtype is not None else get_default_dtype()

    def __setattr__(self, name, value):
        # auto-register parameter Variables
        if isinstance(value, Variable) and not name.startswith("_"):
            if name not in self._parameter_names:
                self._parameter_names.append(name)
        object.__setattr__(self, name, value)

    # ------------------------------------------------------------------
    @property
    def parameters(self):
        """``{prefixed_name: Variable}`` over all parameters."""
        return {self.name + "_" + n: getattr(self, n)
                for n in self._parameter_names}

    @property
    def parameter_names(self):
        return [self.name + "_" + n for n in self._parameter_names]

    def _strip_prefix(self, kernel_params):
        offset = len(self.name) + 1
        return {k[offset:]: v for k, v in kernel_params.items()
                if k.startswith(self.name + "_")}

    # ------------------------------------------------------------------
    def K(self, X, X2=None, **kernel_params):
        """Covariance matrix ``K[..., i, j] = k(X_i, X2_j)``.

        ``X``: (..., N, D); ``X2``: (..., M, D) or None (treated as X).
        Parameter tensors carry the leading sample axis.
        """
        params = self._strip_prefix(kernel_params)
        if self.active_dims is not None:
            X = slice_axis(X, axis=-1, indices=self.active_dims)
            if X2 is not None:
                X2 = slice_axis(X2, axis=-1, indices=self.active_dims)
        return self._compute_K(X=X, X2=X2, **params)

    def Kdiag(self, X, **kernel_params):
        """Diagonal of the covariance matrix: (..., N)."""
        params = self._strip_prefix(kernel_params)
        if self.active_dims is not None:
            X = slice_axis(X, axis=-1, indices=self.active_dims)
        return self._compute_Kdiag(X=X, **params)

    def _compute_K(self, X, X2=None, **kernel_params):
        raise NotImplementedError

    def _compute_Kdiag(self, X, **kernel_params):
        raise NotImplementedError

    # ------------------------------------------------------------------
    def fetch_parameters(self, env):
        """Fetch runtime values of all parameters from a UUID env."""
        return {name: env[v.uuid] for name, v in self.parameters.items()}

    # ------------------------------------------------------------------
    def add(self, other, name="add"):
        if not isinstance(other, Kernel):
            raise ModelSpecificationError(
                "Only a Kernel can be added to a Kernel.")
        from .add_kernel import AddKernel
        return AddKernel([self, other], name=name, dtype=self.dtype)

    def __add__(self, other):
        return self.add(other)

    def multiply(self, other, name="mul"):
        if not isinstance(other, Kernel):
            raise ModelSpecificationError(
                "Only a Kernel can be multiplied with a Kernel.")
        from .multiply_kernel import MultiplyKernel
        return MultiplyKernel([self, other], name=name, dtype=self.dtype)

    def __mul__(self, other):
        return self.multiply(other)

    # ------------------------------------------------------------------
    def replicate_self(self, attribute_map=None):
        replica = type(self).__new__(type(self))
        object.__setattr__(replica, "_parameter_names",
                           list(self._parameter_names))
        for k, v in self.__dict__.items():
            if k == "_parameter_names":
                continue
            if isinstance(v, Variable) and attribute_map is not None:
                object.__setattr__(replica, k, attribute_map.get(v, v))
            else:
                object.__setattr__(replica, k, v)
        return replica

    def _make_param(self, value, shape, transformation="positive"):
        """Accept a Variable or create one with the given initial value."""
        if isinstance(value, Variable):
            return value
        trans = PositiveTransformation() if transformation == "positive" \
            else None
        return Variable(shape=shape, transformation=trans,
                        initial_value=value)


class NativeKernel(Kernel):
    """Leaf kernels: covariance independent of other kernels."""


class CombinationKernel(Kernel):
    """Kernels combining sub-kernels: their parameters keep each
    sub-kernel's prefix under the combination's own."""

    def __init__(self, sub_kernels, name, dtype=None):
        input_dim = max(k.input_dim for k in sub_kernels)
        # rename duplicate sub-kernel names in place: rbf, rbf -> rbf_0, rbf_1
        names = [k.name for k in sub_kernels]
        counts = {}
        for n in names:
            counts[n] = counts.get(n, 0) + 1
        seen = {}
        for k in sub_kernels:
            if counts[k.name] > 1:
                idx = seen.get(k.name, 0)
                seen[k.name] = idx + 1
                k.name = k.name + "_" + str(idx)
        super().__init__(input_dim=input_dim, name=name, dtype=dtype)
        self.sub_kernels = list(sub_kernels)

    @property
    def parameters(self):
        p = {}
        for k in self.sub_kernels:
            p.update(k.parameters)
        return {self.name + "_" + k: v for k, v in p.items()}

    @property
    def parameter_names(self):
        out = []
        for k in self.sub_kernels:
            out.extend(self.name + "_" + n for n in k.parameter_names)
        return out

    def replicate_self(self, attribute_map=None):
        replica = super().replicate_self(attribute_map)
        object.__setattr__(
            replica, "sub_kernels",
            [k.replicate_self(attribute_map) for k in self.sub_kernels])
        return replica
