"""Framework exceptions (the same classes as ``mxfusion_tpu.common``)."""


class ModelSpecificationError(Exception):
    """Raised for malformed model definitions (bad factor wiring, shapes)."""


class InferenceError(Exception):
    """Raised for invalid inference configuration or runtime failures."""


class SerializationError(Exception):
    """Raised when saving/loading or graph reconciliation fails."""
