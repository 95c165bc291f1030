from . import util
from . import checkpoint
from . import inference
from . import serialization
from .checkpoint import CheckpointCallback, save_params, load_params
