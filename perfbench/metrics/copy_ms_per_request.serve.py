"""copy_ms_per_request.serve: device time of the host-to-device and
device-to-host copies per request (``BatchedPredictor``: the request to
the device once, the moments back)."""
from perfbench.lib.readers import copy_ms_per

COPIES = r"HtoD|DtoH"


def read(trace, cell):
    return copy_ms_per(trace, COPIES, "requests")
