"""Models of the paper's experiments (``cnn``), the LM zoo's stack for
every family (``config``, ``layers``, ``attention``, ``mla``, ``moe``,
``ssm``, ``blocks``, ``remat``, ``model``) and the JAX-pytree converter
(``convert``)."""
