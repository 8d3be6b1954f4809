"""Models of the paper's experiments (``cnn``) and the JAX-pytree
converter (``convert``)."""
