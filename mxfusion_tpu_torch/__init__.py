"""mxfusion_tpu_torch: the PyTorch and CUDA port of mxfusion_tpu.

The JAX package ``mxfusion_tpu`` is the reference; this package mirrors
its layout and public names module for module, so each file here has a
counterpart of the same path there. It imports ``torch`` and numpy and
never ``jax``. Kernels written by hand for NVIDIA Hopper (sm_90a) live
in ``csrc/`` and are built on first use (see ``ops/cuda_build.py``).

Ported so far: the model IR and the elementwise operators, the
distribution library (the state-space ones with the Kalman filter and
smoother in ``ops.kalman``), the GP distributions
and the GP kernel family, SVGP regression, exact and collapsed GP
regression, the non-Gaussian SVGPs (binary and multi-class
classification, Poisson and negative-binomial counts), training by MAP
or SVI through the batch, minibatch and device loops, mean-field,
score-function and importance-weighted VI, serving through
``BatchedPredictor``, forward sampling, the samplers, the evidence and
criticism layer, PILCO, data parallelism over ``torch.distributed``
(``parallel``), the native host batcher (``native``), profiling hooks,
and the hand-written kernels of the paths they run (the RBF gram, the
fused L⁻¹·Kuf gram and its backward, the batched Cholesky).
"""
from .__version__ import __version__
from .models import Model, Posterior, FactorGraph
from .components import Variable, VariableType, Factor, ModelComponent
from . import common
from . import components
from . import inference
from . import models
from . import modules
from . import native
from . import ops
from . import parallel
from . import util
