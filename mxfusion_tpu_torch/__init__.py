"""mxfusion_tpu_torch: the PyTorch and CUDA port of mxfusion_tpu.

The JAX package ``mxfusion_tpu`` is the reference; this package mirrors
its layout and public names module for module, so each file here has a
counterpart of the same path there. It imports ``torch`` and numpy and
never ``jax``. Kernels written by hand for NVIDIA Hopper (sm_90a) live
in ``csrc/`` and are built on first use (see ``ops/cuda_build.py``).

Ported so far: the SVGP regression serving path (model IR, univariate
``Normal``, GP distributions, the RBF kernel and its CUDA gram kernel,
module dispatch, executors, parameter storage and ``BatchedPredictor``).
"""
from .__version__ import __version__
from .models import Model, Posterior, FactorGraph
from .components import Variable, VariableType, Factor, ModelComponent
from . import common
from . import components
from . import inference
from . import models
from . import modules
from . import ops
from . import util
