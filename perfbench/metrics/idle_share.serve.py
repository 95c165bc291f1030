"""idle_share.serve: % of the traced serving window with nothing running
on the device (the union of kernel, copy and set intervals)."""
from perfbench.lib.readers import idle_share as read  # noqa: F401
