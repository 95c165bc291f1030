"""Writing a new module.

The PyTorch port of ``examples/writing_a_new_module.py``: a custom
``Module``, Bayesian linear regression with the weights collapsed
analytically. Its log-pdf algorithm is the exact evidence, one
Cholesky of alpha·XXᵀ + s2·I in torch (the kernel matrix built at the
HIGHEST precision tier), so plain ``GradBasedInference`` fits alpha and
s2 by type-II maximum likelihood; its sampler is forward sampling over
the module's graph. The fit's evidence is checked against scipy's.
"""
import math
import os

import numpy as np
import torch

from mxfusion_tpu_torch import Model, Posterior, Variable
from mxfusion_tpu_torch.components.distributions import Normal
from mxfusion_tpu_torch.components.functions.operators import (broadcast_to,
                                                               dot)
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.components.variables.runtime_variable import \
    arrays_as_samples
from mxfusion_tpu_torch.inference import (
    GradBasedInference, MAP, InferenceAlgorithm, ForwardSamplingAlgorithm,
    create_executor)
from mxfusion_tpu_torch.modules import Module
from mxfusion_tpu_torch.ops import precision

SMOKE = bool(os.environ.get("MXF_SMOKE"))
N, D = 200, 4
MAX_ITER = 30 if SMOKE else 300
LOG2PI = math.log(2 * math.pi)


class LinRegLogEvidence(InferenceAlgorithm):
    """The exact collapsed marginal likelihood through the Cholesky of
    alpha·XXᵀ + s2·I, one batched factorization over the samples."""

    def __init__(self, model, observed):
        super().__init__(model=model, observed=observed)
        self.log_pdf_scaling = 1.0

    def compute(self, env, ctx):
        X, Y, alpha, s2 = arrays_as_samples([
            env[self.model.X], env[self.model.Y], env[self.model.alpha],
            env[self.model.noise_var]])
        n = X.shape[-2]
        # a product that feeds a Cholesky: pinned at the HIGHEST tier
        # (IEEE fp32 on the card, whatever TF32 setting is on)
        K = alpha[..., None] * precision.einsum("...nd,...md->...nm", X, X) \
            + s2[..., None] * torch.eye(n, dtype=X.dtype, device=X.device)
        L = torch.linalg.cholesky(K)
        LinvY = torch.linalg.solve_triangular(L, Y, upper=False)
        logdet = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        lp = -0.5 * n * LOG2PI - logdet \
            - 0.5 * torch.sum(LinvY ** 2, dim=(-2, -1))
        return self.log_pdf_scaling * lp


class BayesianLinearRegression(Module):
    """w collapsed analytically; training fits alpha and s2 by exact
    evidence maximization through plain GradBasedInference."""

    def __init__(self, X, alpha, noise_var, rand_gen=None, dtype=None):
        if not isinstance(X, Variable):
            X = Variable(value=X)
        inputs = [("X", X), ("alpha", alpha), ("noise_var", noise_var)]
        super().__init__(inputs=inputs, outputs=None,
                         input_names=[k for k, _ in inputs],
                         output_names=["random_variable"],
                         rand_gen=rand_gen, dtype=dtype)

    def _generate_outputs(self, output_shapes=None):
        Y_shape = output_shapes["random_variable"] \
            if output_shapes["random_variable"] is not None \
            else self.X.shape[:-1] + (1,)
        self.set_outputs([Variable(shape=Y_shape)])

    def _build_module_graphs(self):
        Y = self.random_variable
        graph = Model(name="bayes_linreg")
        graph.X = self.X.replicate_self()
        graph.alpha = self.alpha.replicate_self()
        graph.noise_var = self.noise_var.replicate_self()
        d = self.X.shape[-1]
        graph.w = Normal.define_variable(
            mean=broadcast_to(Variable(value=0.), (d, 1)),
            variance=broadcast_to(graph.alpha, (d, 1)), shape=(d, 1),
            rand_gen=self._rand_gen, dtype=self.dtype)
        graph.f = dot(graph.X, graph.w)
        graph.Y = Y.replicate_self()
        graph.Y.set_prior(Normal(
            mean=graph.f,
            variance=broadcast_to(graph.noise_var, graph.Y.shape),
            rand_gen=self._rand_gen, dtype=self.dtype))
        return graph, [Posterior(graph)]

    def _attach_default_inference_algorithms(self):
        observed_io = [v for _, v in self.inputs] + \
            [v for _, v in self.outputs]
        self.attach_log_pdf_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=LinRegLogEvidence(self._module_graph, observed_io),
            alg_name="linreg_evidence")
        observed_in = [v for _, v in self.inputs]
        self.attach_draw_samples_algorithms(
            targets=self.output_names, conditionals=self.input_names,
            algorithm=ForwardSamplingAlgorithm(self._module_graph,
                                               observed_in),
            alg_name="linreg_sampling")

    @staticmethod
    def define_variable(X, alpha, noise_var, shape=None, rand_gen=None,
                        dtype=None):
        mod = BayesianLinearRegression(X=X, alpha=alpha,
                                       noise_var=noise_var,
                                       rand_gen=rand_gen, dtype=dtype)
        mod._generate_outputs({"random_variable": shape})
        return mod.random_variable


def main():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D))
    w_true = np.array([1.0, -0.5, 0.25, 2.0])[:, None]
    s2_true = 0.09
    y = X @ w_true + rng.standard_normal((N, 1)) * np.sqrt(s2_true)

    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, D))
    m.alpha = Variable(transformation=PositiveTransformation(),
                       initial_value=1.0)
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=1.0)
    m.Y = BayesianLinearRegression.define_variable(
        X=m.X, alpha=m.alpha, noise_var=m.noise_var, shape=(m.n, 1))

    alg = MAP(model=m, observed=[m.X, m.Y])
    infr = GradBasedInference(alg)
    infr.run(X=X, Y=y, max_iter=MAX_ITER, learning_rate=0.1,
             verbose=False)
    s2_hat = infr.params[m.noise_var].flatten()[0].item()
    a_hat = infr.params[m.alpha].flatten()[0].item()
    print("evidence-maximized noise variance: {:.4f} (true {})".format(
        s2_hat, s2_true))

    # the module's log-pdf at the fit against scipy's exact evidence
    from scipy import stats
    params = infr.params
    ex = create_executor(alg, params)
    data = [torch.as_tensor(a, dtype=params.dtype, device=params.device)
            for a in (X, y)]
    with torch.no_grad():
        loss, _, _ = ex(params.trainable_params(), params.fixed_params(),
                        data, torch.Generator(params.device).manual_seed(0))
    K = a_hat * X @ X.T + s2_hat * np.eye(N)
    log_z = stats.multivariate_normal.logpdf(y[:, 0], np.zeros(N), K)
    print("log evidence (module): {:.3f}  (scipy: {:.3f})".format(
        -float(loss), log_z))
    return s2_hat


if __name__ == "__main__":
    main()
