"""Linear-Gaussian state-space model (LGSSM) distribution.

Counterpart of ``mxfusion_tpu/components/distributions/ssm.py``. The
output variable is the whole observation trajectory y (T, E) of

    x_t = A x_{t-1} + w_t,  w_t ~ N(0, Q);  y_t = H x_t + v_t,
    v_t ~ N(0, R);  x_0 ~ N(m0, P0)

with the latent path x marginalized: ``log_pdf`` is the exact Kalman
marginal likelihood, smooth in (A, H, Q, R, m0, P0), so MAP and SVI fit
the system matrices by gradient and the samplers give posteriors over
them; ``ops.kalman``'s filter and smoother recover the states from
fitted parameters. Sampling simulates trajectories. The output is
unconstrained (``support`` "real").

The JAX package maps the filter over the samples (``jax.vmap``); here
the filter takes the sample axis as its batch axis, so one loop over
time filters all of them.
"""
import torch

from .distribution import Distribution
from ..variables.variable import Variable
from ...ops.kalman import kalman_filter, kalman_filter_parallel, lgssm_sample


class LinearGaussianSSM(Distribution):

    #: the filter couples the time steps
    row_separable = False

    def __init__(self, A, H, trans_cov, obs_cov, initial_mean,
                 initial_cov, observation_mask=None,
                 parallel_filter=False, rand_gen=None, dtype=None):
        inputs = [("A", A), ("H", H), ("trans_cov", trans_cov),
                  ("obs_cov", obs_cov), ("initial_mean", initial_mean),
                  ("initial_cov", initial_cov)]
        if observation_mask is not None:
            if parallel_filter:
                raise ValueError(
                    "observation_mask requires the sequential filter "
                    "(parallel_filter=False).")
            if not isinstance(observation_mask, Variable):
                observation_mask = Variable(value=observation_mask)
            inputs.append(("observation_mask", observation_mask))
        super().__init__(
            inputs=inputs, outputs=None,
            input_names=[k for k, _ in inputs],
            output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)
        # the associative-scan filter: log depth over T instead of T
        # sequential steps
        self.parallel_filter = parallel_filter

    def replicate_self(self, attribute_map=None):
        replica = super().replicate_self(attribute_map)
        replica.parallel_filter = self.parallel_filter
        return replica

    def log_pdf_impl(self, random_variable, A, H, trans_cov, obs_cov,
                     initial_mean, initial_cov, observation_mask=None):
        y = random_variable                       # (s, T, E)
        s = y.shape[0]

        def bc(a):
            return torch.broadcast_to(a, (s,) + tuple(a.shape[1:]))

        args = [bc(a) for a in (y, A, H, trans_cov, obs_cov, initial_mean,
                                initial_cov)]
        if observation_mask is not None:
            return kalman_filter(*args, mask=bc(observation_mask))["loglik"]
        filt = kalman_filter_parallel if self.parallel_filter \
            else kalman_filter
        return filt(*args)["loglik"]              # (s,)

    def draw_samples_impl(self, rv_shape, num_samples, generator, A, H,
                          trans_cov, obs_cov, initial_mean, initial_cov,
                          observation_mask=None):
        # the mask marks which steps were observed in training; the
        # generative process is unaffected, so simulation ignores it
        def bc(a):
            return torch.broadcast_to(a, (num_samples,) + tuple(a.shape[1:]))

        _, y = lgssm_sample(generator, rv_shape[-2], bc(A), bc(H),
                            bc(trans_cov), bc(obs_cov), bc(initial_mean),
                            bc(initial_cov), dtype=self.dtype,
                            num_samples=num_samples)
        return y

    def _generate_outputs(self, shape):
        if shape is None or len(shape) < 2:
            raise ValueError(
                "LinearGaussianSSM requires an explicit (T, E) shape.")
        self.set_outputs([Variable(shape=shape)])

    @classmethod
    def define_variable(cls, A, H, trans_cov, obs_cov, initial_mean,
                        initial_cov, shape=None, observation_mask=None,
                        parallel_filter=False, rand_gen=None,
                        dtype=None):
        dist = cls(A=A, H=H, trans_cov=trans_cov, obs_cov=obs_cov,
                   initial_mean=initial_mean, initial_cov=initial_cov,
                   observation_mask=observation_mask,
                   parallel_filter=parallel_filter, rand_gen=rand_gen,
                   dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable
