"""Write the torch-1.0 predictor artifact that the export tests load.

``tests/goldens/export_torch_1_0_svgp.zip`` is an SVGP regression
predictor (float64, D = 2, M = 8, chunk 16) exported in format
"torch-1.0", whose program takes (trainable, fixed, chunk);
``export_torch_1_0_svgp.npz`` holds 37 request rows and the live
predictor's mean and variance on them. The format moved to torch-1.1
when the networks' buffers and the base draws became program inputs, so
this script runs against a checkout of the package from before that
move, put first on the path:

    PYTHONPATH=<checkout of a torch-1.0 commit> \\
        python tests/oracles/torch_export_v1_0.py

It refuses to run against a package that writes another format.
"""
import os

import numpy as np

import mxfusion_tpu_torch as mt
from mxfusion_tpu_torch.common.config import set_default_device
from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
from mxfusion_tpu_torch.components.variables import PositiveTransformation
from mxfusion_tpu_torch.inference import (BatchedPredictor,
                                          GradBasedInference, MAP, serving)

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                   "goldens", "export_torch_1_0_svgp")


def main():
    if serving.FORMAT_VERSION != "torch-1.0":
        raise SystemExit("the package on the path writes {}, not torch-1.0"
                         .format(serving.FORMAT_VERSION))
    set_default_device("cpu")
    rng = np.random.default_rng(11)
    N, D, M = 60, 2, 8
    X = rng.random((N, D)) * 4
    Y = np.sin(X[:, :1]) + rng.standard_normal((N, 1)) * 0.1
    m = mt.Model()
    m.n = mt.Variable()
    m.X = mt.Variable(shape=(m.n, D))
    m.noise_var = mt.Variable(transformation=PositiveTransformation(),
                              initial_value=0.1)
    m.Y = mt.modules.SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=D, variance=1.0, lengthscale=1.0),
        noise_var=m.noise_var, shape=(m.n, 1),
        inducing_inputs=mt.Variable(shape=(M, D),
                                    initial_value=rng.random((M, D)) * 4))
    infr = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]),
                              dtype="float64", device="cpu")
    infr.run(max_iter=40, learning_rate=0.05, X=X, Y=Y)
    pred = BatchedPredictor(model=m, infr_params=infr.params,
                            observed=[m.X], target_variables=[m.Y.uuid],
                            chunk_size=16)
    Xt = rng.random((37, D)) * 4
    mu, var = pred.predict(X=Xt)[0]
    pred.export(OUT + ".zip")
    np.savez(OUT + ".npz", X=Xt, mean=mu, variance=var)
    print("wrote", OUT + ".zip", OUT + ".npz")


if __name__ == "__main__":
    main()
