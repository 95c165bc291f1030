"""Set-up's phases, each timed and logged as it ends."""
import time


def phase_logger(log):
    """``phase(name)`` logs the seconds since the previous call (or this
    one) under ``name``."""
    last = [time.perf_counter()]

    def phase(name):
        now = time.perf_counter()
        log("set-up: {} {:.3f} s".format(name, now - last[0]))
        last[0] = now
    return phase
