"""Writing a new distribution.

The PyTorch port of ``examples/writing_a_new_distribution.py``: a
Gumbel distribution written against the port's
``UnivariateDistribution``, its log-density in torch and its sampler a
reparameterized inverse CDF of a uniform draw on the caller's
``torch.Generator``, fitted by MAP end to end.
"""
import os

import numpy as np
import torch

from mxfusion_tpu_torch import Model, Variable
from mxfusion_tpu_torch.components.distributions.distribution import \
    UnivariateDistribution
from mxfusion_tpu_torch.components.functions.operators import broadcast_to
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import GradBasedInference, MAP

SMOKE = bool(os.environ.get("MXF_SMOKE"))
MAX_ITER = 30 if SMOKE else 400


class Gumbel(UnivariateDistribution):
    """Gumbel(location, scale):
    log p(x) = -z - exp(-z) - log(scale), z = (x - location) / scale."""

    def __init__(self, location, scale, rand_gen=None, dtype=None):
        super().__init__(
            inputs=[("location", location), ("scale", scale)], outputs=None,
            input_names=["location", "scale"],
            output_names=["random_variable"],
            rand_gen=rand_gen, dtype=dtype)

    def log_pdf_impl(self, random_variable, location, scale):
        z = (random_variable - location) / scale
        return -z - torch.exp(-z) - torch.log(scale)

    def draw_samples_impl(self, rv_shape, num_samples, generator, location,
                          scale):
        u = self._rand_gen.sample_uniform(
            generator, shape=(num_samples,) + tuple(rv_shape),
            dtype=self.dtype)
        # inverse CDF, reparameterized: gradients flow to location/scale
        return location - scale * torch.log(-torch.log(u))

    @classmethod
    def define_variable(cls, location=0., scale=1., shape=None,
                        rand_gen=None, dtype=None):
        dist = cls(location=location, scale=scale, rand_gen=rand_gen,
                   dtype=dtype)
        dist._generate_outputs(shape=shape)
        return dist.random_variable


def main():
    rng = np.random.default_rng(0)
    true_loc, true_scale = 1.5, 0.8
    y = rng.gumbel(true_loc, true_scale, (400, 1))

    m = Model()
    m.loc = Variable(initial_value=0.0)
    m.scale = Variable(transformation=PositiveTransformation(),
                       initial_value=1.0)
    m.y = Gumbel.define_variable(
        location=broadcast_to(m.loc, (400, 1)),
        scale=broadcast_to(m.scale, (400, 1)), shape=(400, 1))

    infr = GradBasedInference(
        inference_algorithm=MAP(model=m, observed=[m.y]))
    infr.run(max_iter=MAX_ITER, learning_rate=0.1, y=y)
    loc_hat = infr.params[m.loc].flatten()[0].item()
    scale_hat = infr.params[m.scale].flatten()[0].item()
    print("MLE location: {:.3f} (true {})".format(loc_hat, true_loc))
    print("MLE scale:    {:.3f} (true {})".format(scale_hat, true_scale))
    return loc_hat


if __name__ == "__main__":
    main()
