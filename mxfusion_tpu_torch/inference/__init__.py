from .inference import Inference, TransferInference
from .inference_parameters import InferenceParameters
from .inference_alg import (
    InferenceAlgorithm, SamplingAlgorithm, RuntimeContext, VariableEnv,
    create_sampling_executor)
from .prediction import ModulePredictionAlgorithm
from .serving import BatchedPredictor
