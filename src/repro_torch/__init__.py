"""PyTorch/CUDA port of ``repro`` (connectivity-aware semi-decentralized
federated learning over time-varying D2D networks).

Same subpackage layout as the JAX reference (``repro/X/y.py`` ->
``repro_torch/X/y.py``); imports ``torch`` and numpy only.  The graph-
mixing hot path and the LM stack's flash attention run hand-written
CUDA kernels for Hopper (``kernels/csrc``) on CUDA tensors and their
plain PyTorch versions on CPU tensors.  Entry points
(``FederatedServer``, ``LocalEngine``, ``models.model.Model``,
``launch/train.py``, ``launch/serve.py``) run on ``cuda`` unless given
``device="cpu"``.
"""
