"""The port's parallel layers: ``decode`` (host-side parallel decode of
multi-member streams and the magic scans of the device decoder), ``mesh``
(block-data-parallel encode and decode over a mesh of devices, one thread
an entry) and ``multihost`` (the multi-process encode and member-grain
decode on ``torch.distributed`` with Gloo)."""
