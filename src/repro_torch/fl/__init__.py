"""Federated runtime of the port: packed delta layout (``packing``), round
plans (``plan``), fault models (``faults``) and the single-host engine
(``engine``).  Import the submodules directly."""
