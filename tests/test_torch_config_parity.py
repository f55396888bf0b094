"""The port's KNNConfig accepts and refuses the same settings as the JAX
package's, field by field, on a grid that covers each rule of the
serving and clustered-index fields (``mpi_knn_tpu/config.py:457-522``).

Every setting of the grid is ported (the sharded clustered index's
``ivf_shards`` / ``ivf_route_cap`` too), so the third column, a setting
the port would refuse as "not yet ported", is False throughout.
"""

import pytest

from mpi_knn_tpu.config import KNNConfig as JaxConfig
from mpi_knn_tpu_torch import KNNConfig

# (settings, the reference accepts them, the port refuses them as unported)
GRID = [
    (dict(nprobe=4), False, False),
    (dict(ivf_shards=2), False, False),
    (dict(ivf_route_cap=3), False, False),
    (dict(bucket_headroom=-1.0), False, False),
    (dict(compact_fill_threshold=2.0), False, False),
    (dict(compact_fill_threshold=0.0), False, False),
    (dict(compact_tombstone_fraction=0.0), False, False),
    (dict(compact_tombstone_fraction=-0.5), False, False),
    (dict(partitions=0), False, False),
    (dict(partitions=4, nprobe=5), False, False),
    (dict(partitions=4, nprobe=0), False, False),
    (dict(partitions=4, ivf_shards=0), False, False),
    (dict(partitions=4, ivf_shards=2, ivf_route_cap=0), False, False),
    (dict(partitions=4, ivf_route_cap=2), False, False),
    (dict(partitions=4, metric="cosine"), False, False),
    (dict(bucket_headroom=0.0), True, False),
    (dict(bucket_headroom=0.5), True, False),
    (dict(compact_fill_threshold=1.0), True, False),
    (dict(compact_fill_threshold=0.5), True, False),
    (dict(compact_tombstone_fraction=0.01), True, False),
    (dict(nprobe=None, ivf_shards=None, ivf_route_cap=None), True, False),
    (dict(partitions=4, nprobe=4), True, False),
    (dict(partitions=4, ivf_shards=2, ivf_route_cap=3), True, False),
]


def _accepts(cls, settings):
    try:
        cls(**settings)
    except ValueError as exc:
        return False, str(exc)
    return True, ""


@pytest.mark.parametrize("settings,ref_accepts,unported", GRID,
                         ids=[repr(g[0]) for g in GRID])
def test_both_packages_accept_or_refuse_alike(settings, ref_accepts, unported):
    ref, _ = _accepts(JaxConfig, settings)
    port, message = _accepts(KNNConfig, settings)
    assert ref == ref_accepts
    if unported:
        assert not port and "not yet ported" in message
    else:
        assert port == ref, message
