"""The benchmark's yardstick: the harness, the trace reduction, the
peaks and bounds, and the comparison that decides ``correct``."""
