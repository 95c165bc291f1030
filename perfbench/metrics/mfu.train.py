"""mfu.train: the training steps' model FLOPs (the configuration's
``flops_per_step``) over the traced window, as a % of the card's TF32
dense peak. It names no kernel, so it bounds a claim when one is gone."""
from perfbench.lib.readers import mfu as read  # noqa: F401
