"""device_idle.long: the share of the profiled stretch in which no kernel,
copy or memset ran on the card, in % (torch.profiler)."""
from portbench.profiling import idle_share as read  # noqa: F401
