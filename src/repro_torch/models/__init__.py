"""Models of the paper's experiments (``cnn``), the LM zoo's dense /
audio / vlm stack (``config``, ``layers``, ``attention``, ``blocks``,
``model``) and the JAX-pytree converter (``convert``)."""
