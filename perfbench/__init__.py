"""The benchmark of ``mxfusion_tpu_torch`` on an NVIDIA H100: one cell a
run, driven by the data under this folder (see ``run.py``)."""
