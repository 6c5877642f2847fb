"""fit.device_idle: the share of the profiled training slice's wall time
in which no operation ran on the device, in percent."""

from benchmark.trace import idle_percent as read  # noqa: F401
