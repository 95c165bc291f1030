"""Test utilities shipped with the package.

Counterpart of ``mxfusion_tpu/util/testutils.py``: array helpers, model
factories and distribution-sample checks, under the JAX package's names.
The mock random generator is :class:`FixedRandomGenerator`
(``components.distributions.random_gen``). ``make_net`` builds a
``torch.nn`` MLP of ``nn.Linear`` layers wrapped in ``NNFunction``; a JAX
``make_net``'s weights carry onto it through
``util.carryover.linear_stack_map("f", net.module)``.
"""
import numpy as np
import torch

from ..common.config import as_torch_dtype, resolve_device


def numpy_array_reshape(var, has_samples, n_dim):
    """Prepend axes up to ``n_dim``; axis 0 is the sample axis."""
    var = np.asarray(var)
    if not has_samples:
        var = np.expand_dims(var, axis=0)
    while var.ndim < n_dim:
        var = np.expand_dims(var, axis=1)
    return var


def prepare_runtime_array(array, has_samples, dtype=None, device=None):
    """A numpy array as a runtime tensor with a sample axis, of ``dtype``
    on ``device`` (default: the package's defaults)."""
    a = torch.as_tensor(np.asarray(array), dtype=as_torch_dtype(dtype),
                        device=resolve_device(device))
    if not has_samples:
        a = a.unsqueeze(0)
    return a


def make_spd_matrix(dim, rng=None):
    """Random symmetric positive-definite matrix."""
    rng = rng if rng is not None else np.random.default_rng(0)
    A = rng.standard_normal((dim, dim))
    return A @ A.T + dim * np.eye(dim)


def make_basic_model(finalize=True):
    """Toy Gaussian model with unknown mean/variance over N=100 points."""
    from ..models.model import Model
    from ..components.variables.variable import Variable
    from ..components.variables.var_trans import PositiveTransformation
    from ..components.distributions.normal import Normal
    from ..components.functions.operators import broadcast_to
    m = Model()
    N = 100
    m.mu = Normal.define_variable(mean=0., variance=100., shape=(1,))
    m.s = Variable(transformation=PositiveTransformation(),
                   initial_value=5.)
    m.Y = Normal.define_variable(mean=broadcast_to(m.mu, (N, 1)),
                                 variance=broadcast_to(m.s, (N, 1)),
                                 shape=(N, 1))
    return m


def make_net(input_shape=(100, 2), hidden=8, out=1, seed=0, dtype=None,
             device=None):
    """A small MLP, Linear → tanh → Linear, wrapped as the ``NNFunction``
    ``f``. Each layer's weight and bias are uniform in ±1/sqrt(fan_in)
    (``nn.Linear``'s initialization), drawn from a ``torch.Generator``
    seeded with ``seed``."""
    from ..components.functions.nn_function import NNFunction
    net = torch.nn.Sequential(torch.nn.Linear(input_shape[-1], hidden),
                              torch.nn.Tanh(), torch.nn.Linear(hidden, out))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in (net[0], net[2]):
            bound = layer.in_features ** -0.5
            for p in (layer.weight, layer.bias):
                p.uniform_(-bound, bound, generator=g)
    return NNFunction(net, name="f", input_shapes=[input_shape],
                      dtype=dtype, device=device)


def check_sampling_bivariate(samples, mean, cov, atol=0.1):
    """Moment check for 2-D sampling: the mean within ``atol`` and the
    covariance within ``3 * atol``."""
    s = _numpy(samples).reshape(-1, 2)
    return (np.allclose(s.mean(0), mean, atol=atol) and
            np.allclose(np.cov(s.T), cov, atol=3 * atol))


def make_bnn_model(net, data_x_shape, finalize=True):
    """Bayesian NN model: priors over all lifted network weights."""
    from ..models.model import Model
    from ..components.variables.variable import Variable
    from ..components.variables.var_trans import PositiveTransformation
    from ..components.distributions.normal import Normal
    from ..components.functions.operators import broadcast_to
    m = Model()
    m.N = Variable()
    m.f = net
    m.x = Variable(shape=(m.N,) + tuple(data_x_shape[1:]))
    m.r = m.f(m.x)
    for name, v in m.r.factor.function.parameters.items():
        v.set_prior(Normal(mean=broadcast_to(Variable(value=0.), v.shape),
                           variance=broadcast_to(Variable(value=1.),
                                                 v.shape)))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.01)
    m.y = Normal.define_variable(mean=m.r,
                                 variance=broadcast_to(m.noise_var,
                                                       (m.N, 1)),
                                 shape=(m.N, 1))
    return m


def check_sampling_univariate(samples, cdf, min_pvalue=0.01):
    """Distributional sampling check: a Kolmogorov-Smirnov test of the
    samples against ``cdf``."""
    from scipy import stats
    _, pvalue = stats.kstest(_numpy(samples).ravel(), cdf)
    return pvalue > min_pvalue


def sample_moment_check(samples, mean, variance, rtol=0.1, atol=0.1):
    """Check empirical moments of samples against analytic values."""
    s = _numpy(samples)
    emp_mean = s.mean(axis=0)
    emp_var = s.var(axis=0)
    return (np.allclose(emp_mean, mean, rtol=rtol, atol=atol) and
            np.allclose(emp_var, variance, rtol=3 * rtol, atol=3 * atol))


def _numpy(samples):
    """Samples as a numpy array, from a tensor on any device too."""
    if isinstance(samples, torch.Tensor):
        return samples.detach().cpu().numpy()
    return np.asarray(samples)
