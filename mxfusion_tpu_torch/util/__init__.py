from . import util
from . import checkpoint
from . import inference
from . import profiling
from . import serialization
from . import special
from .checkpoint import CheckpointCallback, save_params, load_params
