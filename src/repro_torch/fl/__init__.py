"""Federated runtime of the port: packed delta layout (``packing``), round
plans (``plan``), fault models (``faults``), the engines (``engine``), the
semi-async runtime (``stream``) and the mesh runtime over
``torch.distributed`` (``distributed``).  Import the submodules
directly."""
