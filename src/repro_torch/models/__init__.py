"""Models of the paper's experiments (``cnn``), the LM zoo's stack for
every family (``config``, ``layers``, ``attention``, ``mla``, ``moe``,
``ssm``, ``blocks``, ``remat``, ``model``), its tensor-parallel rules
and collectives (``sharding``) and the JAX-pytree converter
(``convert``)."""
