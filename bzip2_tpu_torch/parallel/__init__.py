"""Host-side helpers of the port's parallel decode paths."""
