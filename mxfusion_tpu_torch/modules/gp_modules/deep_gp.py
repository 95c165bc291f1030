"""Deep Gaussian processes by doubly-stochastic variational inference
(Salimbeni & Deisenroth, NeurIPS 2017): regression
(:class:`DeepGPRegression`) and binary classification
(:class:`DeepGPClassification`) over a shared layer stack
(:class:`_DeepGPModule`).

Counterpart of ``mxfusion_tpu/modules/gp_modules/deep_gp.py``. L SVGP
layers F_l ~ GP(m_l(F_{l-1}), k_l) with independent posteriors q(U_l),
trained on the doubly-stochastic bound

    Σ_n E_{q(f_L,n)}[log p(y_n | f_L,n)] − Σ_l KL(q(U_l) ‖ p(U_l))

whose outer expectation is estimated by S reparameterized samples
propagated through the inner layers. The final layer's expected
log-likelihood is analytic for the Gaussian likelihood (residual form)
and a Gauss-Hermite quadrature for the Bernoulli one, both the
single-layer modules' own copies, so a 1-layer stack reproduces
``SVGPRegression``'s and ``SVGPClassification``'s bounds.

- The S propagation samples ride the leading sample axis: each layer is
  one batched evaluation over an (S, N, D) block. Layer parameters stay
  at sample size 1, so each M×M Cholesky runs once and broadcasts
  against the S-sample panels; layer 0 runs once at s = 1 and only its
  draw fans out to S.
- On the card each layer's Kuu and Kuf (RBF, float32) are K1 launches
  through ``RBF.K``: layer l ≥ 1's Kuf takes Z at s = 1 against inputs at
  s = S, which the route expands to one launch (``kernels/rbf.py``).
- Inner layers carry fixed identity-like linear means
  (``inner_mean="linear"``, the Salimbeni & Deisenroth skip): W_l is a
  constant, not trained.
- The whitened parameterization is the default: deep stacks compound
  the conditioning problem that whitening solves.
- Draws come from the module's ``rand_gen`` on ``ctx.next_generator()``,
  one per inner layer in layer order, and for the sampling prediction one
  more after them: a fixed generator is used up in the JAX package's
  order.
"""
import math

import numpy as np
import torch

from ..module import Module
from ...models.model import Model
from ...models.posterior import Posterior
from ...components.variables.variable import Variable
from ...components.variables.var_trans import PositiveTransformation
from ...components.variables.runtime_variable import arrays_as_samples
from ...components.distributions.normal import Normal
from ...components.distributions.random_gen import default_rand_gen
from ...components.distributions.gp.gp import GaussianProcess
from ...components.distributions.gp.cond_gp import \
    ConditionalGaussianProcess
from ...components.functions.operators import (broadcast_to, dot,
                                               sigmoid, probit)
from ...inference.variational import VariationalInference
from ...inference.inference_alg import SamplingAlgorithm
from ...inference.forward_sampling import ForwardSamplingAlgorithm
from ...components.distributions.bernoulli import Bernoulli
from ...ops.precision import guarded_forward_matmul
from .svgp_classification import (_bernoulli_expected_log_lik,
                                  _class_probability, _layer_q_moments,
                                  _neg_kl, _VAR_FLOOR)

LOG2PI = math.log(2.0 * math.pi)


def _identity_mean_weights(d_in, d_out):
    """Fixed inner-layer mean map: identity, truncated (d_out < d_in) or
    zero-padded (d_out > d_in), the standard DSVI skip connection."""
    return np.eye(d_in, d_out)


def _noise_per_point(noise_var):
    """A (s, D) noise variance as (s, 1, D); (s, 1, D) as it is."""
    return noise_var[..., None, :] if noise_var.ndim == 2 else noise_var


class _DeepGPLayerStack:
    """Layer propagation shared by the bounds and the predictions.

    Subclasses are inference algorithms over the module graph of
    :meth:`_DeepGPModule._build_module_graphs`; layer l's components are
    addressed by name (``U_l``, ``inducing_inputs_l``, ``qU_*_l``), so
    the handles survive module cloning.
    """

    def _fetch_layer(self, env, l):
        model = self.model
        post = self._extra_graphs[0]
        Z = env[getattr(model, "inducing_inputs_%d" % l)]
        mu = env[getattr(post, "qU_mean_%d" % l)]
        S_W = env[getattr(post, "qU_cov_W_%d" % l)]
        S_diag = env[getattr(post, "qU_cov_diag_%d" % l)]
        kern = getattr(model, "U_%d" % l).factor.kernel
        kern_params = kern.fetch_parameters(env)
        Z, mu, S_W, S_diag, kern_params = arrays_as_samples(
            [Z, mu, S_W, S_diag, kern_params])
        W = None
        if self.inner_mean == "linear" and l < self.num_layers - 1:
            (W,) = arrays_as_samples([env[getattr(model, "W_%d" % l)]])
        return Z, mu, S_W, S_diag, kern, kern_params, W

    def _layer_moments(self, env, l, A):
        """q(f_l) moments at the (sampled) inputs ``A`` (s, N, D_{l-1})."""
        Z, mu, S_W, S_diag, kern, kern_params, W = \
            self._fetch_layer(env, l)
        # the skip mean's forward is floored at HIGH: it feeds the
        # residual Y − m and every deeper layer's gram
        mean_f = guarded_forward_matmul(A, W) if W is not None else None
        # relative jitter (× Kuu's mean diagonal), as the classification
        # bound's: deep training walks every layer's kernel scale freely
        return _layer_q_moments(
            A, Z, mu, S_W, S_diag, kern, kern_params, self.jitter,
            self.whitened, relative_jitter=True, mean_f=mean_f)

    def _mc_count(self, sample_count, requested):
        """The Monte Carlo propagation count. An env that already carries
        s > 1 samples (sampled hyperparameters, outer SVI draws) pins it
        to s, one propagation draw per env sample; ``requested`` applies
        to a sample-size-1 env only."""
        if self.num_layers == 1 or sample_count > 1:
            return sample_count
        return requested

    def _requested(self):
        """A prediction's propagation count: the caller's, an explicit 1
        included, or ``default_samples`` where the caller chose none."""
        requested = self.num_samples_requested
        return self.default_samples if requested is None else requested

    def _propagate(self, env, ctx, A, num_mc):
        """Sample through the inner layers; returns (A, neg_kl_sum) with A
        carrying ``num_mc`` samples after the first sampled layer. A is
        not broadcast beforehand: layer 0 runs once on the deterministic
        input and only its draw fans out to ``num_mc``. The final layer
        is left to the caller."""
        kl_sum = 0.0
        for l in range(self.num_layers - 1):
            mu_f, var_f, Linvmu, LinvLs = self._layer_moments(env, l, A)
            eps = self._rand_gen.sample_normal(
                ctx.next_generator(), shape=(num_mc,) + tuple(mu_f.shape[1:]),
                dtype=mu_f.dtype)
            # a positive floor, not 0: sqrt'(0) is infinite and the
            # moments' cancellation can land slightly below 0
            A = mu_f + torch.sqrt(
                torch.clamp_min(var_f, _VAR_FLOOR))[..., None] * eps
            kl_sum = kl_sum + _neg_kl(Linvmu, LinvLs, mu_f.shape[-1])
        return A, kl_sum


class DeepGPRegressionLogPdf(VariationalInference, _DeepGPLayerStack):
    """The doubly-stochastic ELBO. ``num_samples`` is the propagation
    count S: the bound has shape (S,), and the outer interpreter's
    per-term sample mean is the Monte Carlo average."""

    def __init__(self, model, posterior, observed, num_layers,
                 jitter=0.0, whitened=True, num_samples=5,
                 inner_mean="linear", rand_gen=None):
        super().__init__(num_samples=num_samples, model=model,
                         posterior=posterior, observed=observed)
        self.log_pdf_scaling = 1.0
        self.num_layers = num_layers
        self.jitter = jitter
        self.whitened = whitened
        self.inner_mean = inner_mean
        self._rand_gen = rand_gen if rand_gen is not None \
            else default_rand_gen()

    def compute(self, env, ctx):
        X = env[self.model.X]
        Y = env[self.model.Y]
        noise_var = env[self.model.noise_var]
        X, Y, noise_var = arrays_as_samples([X, Y, noise_var])
        D = Y.shape[-1]

        num_mc = self._mc_count(X.shape[0], self.num_samples)
        A, kl_sum = self._propagate(env, ctx, X, num_mc)

        # the final layer: the analytic Gaussian expected log-likelihood
        # in residual form; var_f carries the Kff − qff trace correction
        # and the S-term in one per-point residual
        mu_f, var_f, Linvmu, LinvLs = self._layer_moments(
            env, self.num_layers - 1, A)
        kl_sum = kl_sum + _neg_kl(Linvmu, LinvLs, D)

        noise_var = _noise_per_point(noise_var)
        if noise_var.shape[-1] == 1:
            beta_sum = D * torch.sum(1.0 / noise_var, dim=-1)
        else:
            beta_sum = torch.sum(1.0 / noise_var, dim=-1)

        R = Y - mu_f                                          # (S, N, D)
        logL = -torch.sum(torch.square(R) / noise_var + LOG2PI +
                          torch.log(noise_var), dim=(-2, -1)) / 2.0
        logL = logL - torch.sum(var_f * beta_sum, dim=-1) / 2.0
        return self.log_pdf_scaling * logL + kl_sum


class DeepGPMeanVariancePrediction(SamplingAlgorithm, _DeepGPLayerStack):
    """Predictive mixture moments: S propagation samples through the
    inner layers, the final layer's analytic moments per sample, then the
    Gaussian mixture's mean and diagonal variance. ``num_samples`` (set
    by ``predict(num_samples=...)``) is the propagation count; a caller
    who never chose one (``num_samples_requested`` is None) gets
    ``default_samples``, and an explicit 1 is honoured."""

    serving_data_axes = ((1,), (1,))  # (1, N, D) mean and variance

    def __init__(self, model, posterior, observed, num_layers,
                 noise_free=True, jitter=0.0, whitened=True,
                 inner_mean="linear", default_samples=20, rand_gen=None):
        super().__init__(model=model, observed=observed,
                         extra_graphs=[posterior])
        self.num_layers = num_layers
        self.noise_free = noise_free
        self.jitter = jitter
        self.whitened = whitened
        self.inner_mean = inner_mean
        self.default_samples = default_samples
        self._rand_gen = rand_gen if rand_gen is not None \
            else default_rand_gen()

    def _noise(self, env):
        (noise_var,) = arrays_as_samples([env[self.model.noise_var]])
        return _noise_per_point(noise_var)

    def compute(self, env, ctx):
        (X,) = arrays_as_samples([env[self.model.X]])
        num_mc = self._mc_count(X.shape[0], self._requested())
        A, _ = self._propagate(env, ctx, X, num_mc)
        mu_f, var_f, _, _ = self._layer_moments(
            env, self.num_layers - 1, A)
        # the mixture's mean and per-point variance over the MC axis
        mean = torch.mean(mu_f, dim=0, keepdim=True)          # (1, N, D)
        var = torch.mean(var_f[..., None] + torch.square(mu_f), dim=0,
                         keepdim=True) - torch.square(mean)  # (1, N, D)
        if not self.noise_free:
            var = var + self._noise(env)
        outcomes = {self.model.Y.uuid: (mean, var)}
        if self.target_variables:
            return tuple(outcomes[v] for v in self.target_variables)
        return outcomes


class DeepGPSamplingPrediction(DeepGPMeanVariancePrediction):
    """Predictive sampling: propagate and sample the final layer too
    (plus the observation noise unless ``noise_free``). Returns
    (num_samples, N, D) draws from the posterior predictive."""

    serving_data_axes = ((1,),)

    def compute(self, env, ctx):
        (X,) = arrays_as_samples([env[self.model.X]])
        # the env's sample count when it carries one (> 1), else the
        # requested count, whatever the depth (a 1-layer stack fans out
        # through the final draw)
        num_mc = X.shape[0] if X.shape[0] > 1 else max(self.num_samples, 1)
        A, _ = self._propagate(env, ctx, X, num_mc)
        mu_f, var_f, _, _ = self._layer_moments(
            env, self.num_layers - 1, A)
        var = torch.clamp_min(var_f, _VAR_FLOOR)[..., None]
        if not self.noise_free:
            var = var + self._noise(env)
        eps = self._rand_gen.sample_normal(
            ctx.next_generator(), shape=(num_mc,) + tuple(mu_f.shape[1:]),
            dtype=mu_f.dtype)
        samples = mu_f + torch.sqrt(var) * eps
        outcomes = {self.model.Y.uuid: samples}
        if self.target_variables:
            return tuple(outcomes[v] for v in self.target_variables)
        return outcomes


class _DeepGPModule(Module):
    """Deep GP module plumbing: the layer stack, the per-layer
    posteriors, replication. Subclasses supply the likelihood tail
    (``_replicate_extra_inputs``, ``_set_output_prior``) and the attached
    inference algorithms.

    Parameters (shared by the concrete modules)
    ----------
    kernels : list of kernels, one per layer (depth L = len(kernels)).
        Layer l outputs ``kernels[l+1].input_dim`` features; the final
        layer outputs the observed Y's event width.
    inducing_inputs : optional list of L Variables, layer l's of shape
        (M_l, D_{l-1}); by default ``num_inducing`` standard-normal rows
        each.
    num_samples : the propagation count S of the training bound.
    inner_mean : "linear" (a fixed identity-like skip, the default) or
        "zero".
    whitened : True by default.
    jitter : the relative Cholesky stabilizer (times Kuu's mean
        diagonal).
    """

    #: doubly-stochastic: the data term is a sum over rows
    row_separable = True

    _graph_name = "deep_gp"

    def __init__(self, X, kernels, inducing_inputs=None,
                 num_inducing=10, extra_inputs=(), rand_gen=None,
                 dtype=None, jitter=1e-5, whitened=True, num_samples=5,
                 inner_mean="linear"):
        if not isinstance(kernels, (list, tuple)) or len(kernels) == 0:
            raise ValueError(
                "{} needs a non-empty list of kernels (one per layer);"
                " got {!r}.".format(type(self).__name__, kernels))
        if inner_mean not in ("linear", "zero"):
            raise ValueError("inner_mean must be 'linear' or 'zero', "
                             "got {!r}".format(inner_mean))
        self.kernels = list(kernels)
        self.num_layers = len(self.kernels)
        self.jitter = jitter
        self.whitened = whitened
        self.num_samples = num_samples
        self.inner_mean = inner_mean
        if not isinstance(X, Variable):
            X = Variable(value=X)
        if inducing_inputs is None:
            inducing_inputs = [
                Variable(shape=(num_inducing, k.input_dim),
                         initial_value=np.random.randn(num_inducing,
                                                       k.input_dim))
                for k in self.kernels]
        if len(inducing_inputs) != self.num_layers:
            raise ValueError(
                "Need one inducing-input Variable per layer: got {} "
                "for {} layers.".format(len(inducing_inputs),
                                        self.num_layers))
        inputs = [("X", X)]
        inputs += [("inducing_inputs_%d" % l, z)
                   for l, z in enumerate(inducing_inputs)]
        inputs.extend(extra_inputs)
        input_names = [k for k, _ in inputs]
        super().__init__(inputs=inputs, outputs=None,
                         input_names=input_names,
                         output_names=["random_variable"],
                         rand_gen=rand_gen, dtype=dtype)

    def _generate_outputs(self, output_shapes=None):
        if output_shapes["random_variable"] is None:
            Y_shape = self.X.shape[:-1] + (1,)
        else:
            Y_shape = output_shapes["random_variable"]
        self.set_outputs([Variable(shape=Y_shape)])

    def _layer_widths(self):
        D_out = self.random_variable.shape[-1]
        return [k.input_dim for k in self.kernels[1:]] + [D_out]

    # ---- subclass hooks ------------------------------------------------
    def _replicate_extra_inputs(self, graph):
        """Replicate the likelihood's own inputs onto ``graph``."""

    def _set_output_prior(self, graph, A):
        """Attach the likelihood tail: graph.Y with a prior driven by the
        final layer's output ``A``."""
        raise NotImplementedError

    def _build_module_graphs(self):
        graph = Model(name=self._graph_name)
        graph.X = self.X.replicate_self()
        self._replicate_extra_inputs(graph)
        N = self.X.shape[0]
        widths = self._layer_widths()

        post_specs = []
        A = graph.X
        for l, kern in enumerate(self.kernels):
            Z = getattr(self, "inducing_inputs_%d" % l).replicate_self()
            setattr(graph, "inducing_inputs_%d" % l, Z)
            M_l = Z.shape[0]
            U = GaussianProcess.define_variable(
                X=Z, kernel=kern, shape=(M_l, widths[l]),
                rand_gen=self._rand_gen, dtype=self.dtype,
                jitter=self.jitter)
            setattr(graph, "U_%d" % l, U)
            mean = None
            if self.inner_mean == "linear" and l < self.num_layers - 1:
                W = Variable(value=_identity_mean_weights(
                    kern.input_dim, widths[l]))
                setattr(graph, "W_%d" % l, W)
                mean = dot(A, W)
                setattr(graph, "mean_%d" % l, mean)
            F = ConditionalGaussianProcess.define_variable(
                X=A, X_cond=Z, Y_cond=U,
                kernel=getattr(graph, "U_%d" % l).factor.kernel,
                shape=(N, widths[l]), mean=mean,
                rand_gen=self._rand_gen, dtype=self.dtype,
                jitter=self.jitter)
            setattr(graph, "F_%d" % l, F)
            A = F
            post_specs.append((M_l, widths[l]))

        self._set_output_prior(graph, A)

        post = Posterior(graph)
        for l, (M_l, D_l) in enumerate(post_specs):
            setattr(post, "qU_cov_diag_%d" % l, Variable(
                shape=(M_l,), transformation=PositiveTransformation(),
                initial_value=np.ones(M_l) * 1e-6))
            setattr(post, "qU_cov_W_%d" % l, Variable(
                shape=(M_l, M_l), initial_value=np.eye(M_l)))
            setattr(post, "qU_mean_%d" % l, Variable(
                shape=(M_l, D_l)))
        return graph, [post]

    def replicate_self(self, attribute_map=None):
        rep = super().replicate_self(attribute_map)
        rep.kernels = [k.replicate_self(attribute_map)
                       for k in self.kernels]
        rep.num_layers = self.num_layers
        rep.jitter = self.jitter
        rep.whitened = self.whitened
        rep.num_samples = self.num_samples
        rep.inner_mean = self.inner_mean
        return rep


class DeepGPRegression(_DeepGPModule):
    """Deep GP regression (see the module docstring and
    :class:`_DeepGPModule` for the shared parameters)."""

    _graph_name = "deep_gp_regression"

    def __init__(self, X, kernels, noise_var, inducing_inputs=None,
                 num_inducing=10, rand_gen=None, dtype=None,
                 jitter=1e-5, whitened=True, num_samples=5,
                 inner_mean="linear"):
        if not isinstance(noise_var, Variable):
            noise_var = Variable(value=noise_var)
        super().__init__(
            X=X, kernels=kernels, inducing_inputs=inducing_inputs,
            num_inducing=num_inducing,
            extra_inputs=[("noise_var", noise_var)], rand_gen=rand_gen,
            dtype=dtype, jitter=jitter, whitened=whitened,
            num_samples=num_samples, inner_mean=inner_mean)

    def _replicate_extra_inputs(self, graph):
        graph.noise_var = self.noise_var.replicate_self()

    def _set_output_prior(self, graph, A):
        graph.Y = self.random_variable.replicate_self()
        graph.Y.set_prior(Normal(
            mean=A,
            variance=broadcast_to(graph.noise_var, graph.Y.shape),
            rand_gen=self._rand_gen, dtype=self.dtype))

    def _attach_default_inference_algorithms(self):
        observed = [v for _, v in self.inputs] + \
            [v for _, v in self.outputs]
        self.attach_log_pdf_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=DeepGPRegressionLogPdf(
                self._module_graph, self._extra_graphs[0], observed,
                num_layers=self.num_layers, jitter=self.jitter,
                whitened=self.whitened, num_samples=self.num_samples,
                inner_mean=self.inner_mean, rand_gen=self._rand_gen),
            alg_name="deep_gp_log_pdf")
        observed = [v for _, v in self.inputs]
        self.attach_draw_samples_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=ForwardSamplingAlgorithm(self._module_graph,
                                               observed),
            alg_name="deep_gp_sampling")
        self.attach_prediction_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=DeepGPMeanVariancePrediction(
                self._module_graph, self._extra_graphs[0], observed,
                num_layers=self.num_layers, jitter=self.jitter,
                whitened=self.whitened, inner_mean=self.inner_mean,
                rand_gen=self._rand_gen),
            alg_name="deep_gp_predict")

    @staticmethod
    def define_variable(X, kernels, noise_var, shape=None,
                        inducing_inputs=None, num_inducing=10,
                        rand_gen=None, dtype=None, jitter=1e-5,
                        whitened=True, num_samples=5,
                        inner_mean="linear"):
        gp = DeepGPRegression(
            X=X, kernels=kernels, noise_var=noise_var,
            inducing_inputs=inducing_inputs, num_inducing=num_inducing,
            rand_gen=rand_gen, dtype=dtype, jitter=jitter,
            whitened=whitened, num_samples=num_samples,
            inner_mean=inner_mean)
        gp._generate_outputs({"random_variable": shape})
        return gp.random_variable


class DeepGPClassificationLogPdf(VariationalInference, _DeepGPLayerStack):
    """The doubly-stochastic ELBO with a Bernoulli likelihood: the final
    layer's expected log-likelihood is a Gauss-Hermite quadrature over
    its analytic q(f_L | propagation sample), as the single-layer
    classification bound's, so a 1-layer stack reproduces
    ``SVGPClassification``'s bound."""

    def __init__(self, model, posterior, observed, num_layers,
                 jitter=0.0, whitened=True, num_samples=5,
                 inner_mean="linear", num_quadrature_points=20,
                 link="logit", rand_gen=None):
        super().__init__(num_samples=num_samples, model=model,
                         posterior=posterior, observed=observed)
        self.log_pdf_scaling = 1.0
        self.num_layers = num_layers
        self.jitter = jitter
        self.whitened = whitened
        self.inner_mean = inner_mean
        self.num_quadrature_points = num_quadrature_points
        self.link = link
        self._rand_gen = rand_gen if rand_gen is not None \
            else default_rand_gen()

    def compute(self, env, ctx):
        X, Y = arrays_as_samples([env[self.model.X], env[self.model.Y]])

        num_mc = self._mc_count(X.shape[0], self.num_samples)
        A, kl_sum = self._propagate(env, ctx, X, num_mc)
        mu_f, var_f, Linvmu, LinvLs = self._layer_moments(
            env, self.num_layers - 1, A)
        kl_sum = kl_sum + _neg_kl(Linvmu, LinvLs, 1)
        mu = mu_f[..., 0]                                     # (S, N)

        sign = 2.0 * Y[..., 0] - 1.0                          # (s, N)
        quad = _bernoulli_expected_log_lik(
            mu, var_f, sign, self.link, self.num_quadrature_points)
        logL = torch.sum(quad, dim=-1)
        return self.log_pdf_scaling * logL + kl_sum


class DeepGPClassificationProbPrediction(SamplingAlgorithm,
                                         _DeepGPLayerStack):
    """Predictive class-1 probability, averaged over the S propagation
    samples: p = (1/S) Σ_s E_{q(f_L | s)}[link(f_L)], the quadrature for
    the logit link and Φ(μ/√(1+σ²)) per sample for the probit link.
    Returns {Y: (p, p(1−p))}."""

    serving_data_axes = ((1,), (1,))  # (1, N, 1) probability moments

    def __init__(self, model, posterior, observed, num_layers,
                 jitter=0.0, whitened=True, inner_mean="linear",
                 num_quadrature_points=20, link="logit",
                 default_samples=20, rand_gen=None):
        super().__init__(model=model, observed=observed,
                         extra_graphs=[posterior])
        self.num_layers = num_layers
        self.jitter = jitter
        self.whitened = whitened
        self.inner_mean = inner_mean
        self.num_quadrature_points = num_quadrature_points
        self.link = link
        self.default_samples = default_samples
        self._rand_gen = rand_gen if rand_gen is not None \
            else default_rand_gen()

    def compute(self, env, ctx):
        (X,) = arrays_as_samples([env[self.model.X]])
        num_mc = self._mc_count(X.shape[0], self._requested())
        A, _ = self._propagate(env, ctx, X, num_mc)
        mu_f, var_f, _, _ = self._layer_moments(
            env, self.num_layers - 1, A)
        p_s = _class_probability(mu_f[..., 0], var_f, self.link,
                                 self.num_quadrature_points)  # (S, N)
        p = torch.mean(p_s, dim=0, keepdim=True)[..., None]  # (1, N, 1)
        outcomes = {self.model.Y.uuid: (p, p * (1.0 - p))}
        if self.target_variables:
            return tuple(outcomes[v] for v in self.target_variables)
        return outcomes


class DeepGPClassification(_DeepGPModule):
    """Deep GP binary classification: stacked SVGP layers, a Bernoulli
    likelihood through a logit or probit link on the final layer. Labels
    are {0, 1}; the output event dim must be 1. See
    :class:`_DeepGPModule` for the shared stack parameters."""

    _graph_name = "deep_gp_classification"

    def __init__(self, X, kernels, inducing_inputs=None,
                 num_inducing=10, rand_gen=None, dtype=None,
                 jitter=1e-5, whitened=True, num_samples=5,
                 inner_mean="linear", num_quadrature_points=20,
                 link="logit"):
        if link not in ("logit", "probit"):
            raise ValueError("link must be 'logit' or 'probit', got "
                             "{!r}".format(link))
        self.num_quadrature_points = num_quadrature_points
        self.link = link
        super().__init__(
            X=X, kernels=kernels, inducing_inputs=inducing_inputs,
            num_inducing=num_inducing, rand_gen=rand_gen, dtype=dtype,
            jitter=jitter, whitened=whitened, num_samples=num_samples,
            inner_mean=inner_mean)

    def _generate_outputs(self, output_shapes=None):
        super()._generate_outputs(output_shapes)
        if self.random_variable.shape[-1] != 1:
            raise ValueError(
                "DeepGPClassification is binary: the output event dim "
                "must be 1, got {}.".format(
                    self.random_variable.shape[-1]))

    def _set_output_prior(self, graph, A):
        graph.p = sigmoid(A) if self.link == "logit" else probit(A)
        graph.Y = self.random_variable.replicate_self()
        graph.Y.set_prior(Bernoulli(
            prob_true=graph.p, rand_gen=self._rand_gen,
            dtype=self.dtype))

    def _attach_default_inference_algorithms(self):
        observed = [v for _, v in self.inputs] + \
            [v for _, v in self.outputs]
        self.attach_log_pdf_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=DeepGPClassificationLogPdf(
                self._module_graph, self._extra_graphs[0], observed,
                num_layers=self.num_layers, jitter=self.jitter,
                whitened=self.whitened, num_samples=self.num_samples,
                inner_mean=self.inner_mean,
                num_quadrature_points=self.num_quadrature_points,
                link=self.link, rand_gen=self._rand_gen),
            alg_name="deep_gp_class_log_pdf")
        observed = [v for _, v in self.inputs]
        self.attach_draw_samples_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=ForwardSamplingAlgorithm(self._module_graph,
                                               observed),
            alg_name="deep_gp_class_sampling")
        self.attach_prediction_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=DeepGPClassificationProbPrediction(
                self._module_graph, self._extra_graphs[0], observed,
                num_layers=self.num_layers, jitter=self.jitter,
                whitened=self.whitened, inner_mean=self.inner_mean,
                num_quadrature_points=self.num_quadrature_points,
                link=self.link, rand_gen=self._rand_gen),
            alg_name="deep_gp_class_predict")

    @staticmethod
    def define_variable(X, kernels, shape=None, inducing_inputs=None,
                        num_inducing=10, rand_gen=None, dtype=None,
                        jitter=1e-5, whitened=True, num_samples=5,
                        inner_mean="linear", num_quadrature_points=20,
                        link="logit"):
        gp = DeepGPClassification(
            X=X, kernels=kernels, inducing_inputs=inducing_inputs,
            num_inducing=num_inducing, rand_gen=rand_gen, dtype=dtype,
            jitter=jitter, whitened=whitened, num_samples=num_samples,
            inner_mean=inner_mean,
            num_quadrature_points=num_quadrature_points, link=link)
        gp._generate_outputs({"random_variable": shape})
        return gp.random_variable

    def replicate_self(self, attribute_map=None):
        rep = super().replicate_self(attribute_map)
        rep.num_quadrature_points = self.num_quadrature_points
        rep.link = self.link
        return rep
