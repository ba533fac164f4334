"""Measurement tools of the port, each run as ``python -m
bzip2_tpu_torch.tools.<name>`` (counterparts of the root ``tools/*.py``):
``scale_bench``, ``mesh_bench``, ``scaling_bench``, ``probe_stages``,
``profile_device``, ``bwt_stats``, ``gather_probe``, ``sais_probe`` and
``sanitize``.  Each runs on the card unless ``--device cpu`` is given, and
exits non-zero without CUDA otherwise; each ``main(argv)`` returns its
figures as well as printing them.
"""
