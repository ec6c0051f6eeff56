"""The p = 256 cells of the port's large-p matrix
(``tests/test_torch_simshard_matrix.py``, which holds p = 8 and 64): the
reference's four instance families x packed/unpacked x {srs, doubling,
auto} on ``sim_mesh(256)``, each equal to the port's sequential oracle.
"""
import pytest

from test_torch_simshard_matrix import ALGORITHMS, check_cell
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.matrix
@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("packed", (True, False), ids=("packed", "unpacked"))
def test_large_p_matrix_256(packed, algorithm):
    check_cell(256, packed, algorithm)
