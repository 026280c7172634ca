"""Offline analysis of simulation output (reference: postprocessing/*.py),
the port's copy of ``devicekmc_tpu/postprocessing`` (numpy and matplotlib).

The log schema written by the engine is key-compatible with the reference's
``output.txt``, so these tools work on either implementation's output.
"""

from .parse import parse_output, parse_snapshot

__all__ = ["parse_output", "parse_snapshot"]
