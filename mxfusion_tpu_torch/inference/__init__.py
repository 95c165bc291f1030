from .inference import Inference, TransferInference
from .inference_parameters import InferenceParameters
from .inference_alg import (
    InferenceAlgorithm, SamplingAlgorithm, RuntimeContext, VariableEnv,
    create_executor, create_sampling_executor)
from .grad_based_inference import GradBasedInference, GradTransferInference
from .grad_loop import GradLoop, TrainState
from .batch_loop import BatchInferenceLoop
from .minibatch_loop import MinibatchInferenceLoop
from .device_loop import DeviceMinibatchLoop
from .natural_gradient import (NaturalGradientLoop,
                               NaturalGradientMinibatchLoop)
from .variational import (
    VariationalInference, VariationalSamplingAlgorithm,
    StochasticVariationalInference,
    ImportanceWeightedVariationalInference)
from .meanfield import create_Gaussian_meanfield
from .map import MAP
from .score_function import ScoreFunctionInference, ScoreFunctionRBInference
from .forward_sampling import (
    ForwardSamplingAlgorithm, ForwardSampling,
    VariationalPosteriorForwardSampling, merge_posterior_into_model)
from .expectation import (
    ExpectationAlgorithm, ExpectationScoreFunctionAlgorithm)
from .prediction import ModulePredictionAlgorithm
from .serving import (BatchedPredictor, ExportedPredictor,
                      load_exported_predictor)
from .pilco_alg import PILCOAlgorithm
from .hmc import (HMCAlgorithm, HMCInference, potential_scale_reduction,
                  effective_sample_size)
from .sgld import SGLDAlgorithm, SGLDInference
from .svgd import SVGDAlgorithm, SVGDInference
from .chees import ChEESHMCAlgorithm, ChEESHMCInference
from .tempering import (ParallelTemperingAlgorithm,
                        ParallelTemperingInference)
from .laplace import LaplaceResult, laplace_approximation
from .evidence import PowerPosteriorAlgorithm, PowerPosteriorInference
from .model_comparison import (pointwise_log_likelihood, waic, loo_psis,
                               posterior_predictive_check)
