"""Solver-matrix dumps and checks of the port (a copy of
``devicekmc_tpu/io``, on the port's records)."""

from .matrix_debug import (
    boundary_matrix_dense,
    cb_matrix_dense,
    check_matrix_match,
    dump_csr_txt,
    ell_to_csr,
    load_csr_txt,
    save_csr_format,
)

__all__ = [
    "boundary_matrix_dense",
    "cb_matrix_dense",
    "check_matrix_match",
    "dump_csr_txt",
    "ell_to_csr",
    "load_csr_txt",
    "save_csr_format",
]
