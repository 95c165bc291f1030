"""Common configuration, constants and exceptions."""
from . import config
from . import exceptions
from .config import (get_default_dtype, set_default_dtype,
                     get_default_device, set_default_device)
from .exceptions import (
    ModelSpecificationError,
    InferenceError,
    SerializationError,
)
