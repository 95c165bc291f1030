"""request_idle_ms_per_request.serve: device idle time inside the
predictor's own work on a request: its inputs to the device, chunking
and padding, the merge and the copy to numpy (``serving.to_device``,
``serving.pad``, ``serving.merge``, ``serving.to_host``) per request."""
from perfbench.lib.spans import span_ms_per

SPANS = ("serving.to_device", "serving.pad", "serving.merge",
         "serving.to_host")


def read(trace, cell):
    return span_ms_per(trace, SPANS, "requests", idle=True)
