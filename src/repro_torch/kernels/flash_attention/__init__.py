"""Flash attention: the hand-written CUDA kernel (``flash_attention``),
its plain versions (``ref``) and the model-layout entry point (``ops``)."""
