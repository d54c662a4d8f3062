"""device_idle.train: the share of the profiled stretch of train steps in
which no kernel, copy or memset ran on the card, in % (torch.profiler)."""
from portbench.profiling import idle_share as read  # noqa: F401
