"""Several devices for the crypto batch path (the port's copy of the JAX
package's ``parallel/``).

The signature rows of a bundle split into contiguous per-device chunks;
each chunk runs the same kernels on its own device, and the quorum tally
is an exact sum of the per-device tallies on the host.
``DeviceTopology`` and ``MeshRouter`` decide, bundle by bundle, which
devices take part (``parallel/topology.py``).
"""

from tendermint_tpu_torch.parallel.mesh import make_mesh, pad_to_multiple  # noqa: F401
from tendermint_tpu_torch.parallel.topology import DeviceTopology, MeshRouter, ShardPlan, Slot  # noqa: F401
