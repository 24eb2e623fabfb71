"""Linear-algebra utilities: Schur-complement block inversion.

Equivalents of ``matrixBlockInverse`` / ``inverseMatrixBlockInverse``
(BayesianUtilities.wl:458-482): extract a block of a matrix inverse
without forming the full inverse — Cholesky/LU solves only, which XLA hands
to the device's linear-algebra libraries.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["matrix_block_inverse", "inverse_matrix_block_inverse"]


def _split(mat, cols):
    cols = jnp.asarray(cols)
    n = mat.shape[-1]
    mask = jnp.zeros((n,), bool).at[cols].set(True)
    rest = jnp.nonzero(~mask, size=n - cols.shape[0])[0]
    return cols, rest


def inverse_matrix_block_inverse(mat, cols):
    """Inverse[Inverse[mat][[cols, cols]]] — the Schur complement
    ``M_cc - M_cr M_rr^-1 M_rc`` (BU:476-482)."""
    mat = jnp.asarray(mat)
    cols, rest = _split(mat, cols)
    m_cc = mat[jnp.ix_(cols, cols)]
    m_cr = mat[jnp.ix_(cols, rest)]
    m_rc = mat[jnp.ix_(rest, cols)]
    m_rr = mat[jnp.ix_(rest, rest)]
    return m_cc - m_cr @ jnp.linalg.solve(m_rr, m_rc)


def matrix_block_inverse(mat, cols):
    """Inverse[mat][[cols, cols]] without the full inverse (BU:458-474)."""
    return jnp.linalg.inv(inverse_matrix_block_inverse(mat, cols))
