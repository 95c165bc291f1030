"""mfu.serve: the predictive moments' model FLOPs (the configuration's
``flops_per_row`` times the rows served) over the traced window, as a %
of the card's TF32 dense peak."""
from perfbench.lib.readers import mfu as read  # noqa: F401
